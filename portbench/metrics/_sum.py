"""The sum of several spans' mean seconds a profile (``_phases.mean_span``),
over those a profile has; ``None`` when it has none of them."""
from portbench.metrics._phases import mean_span


def sum_spans(ctx, names, passes):
    got = [v for v in (mean_span(ctx, n, passes) for n in names)
           if v is not None]
    return sum(got) if got else None
