"""A pass's share of its roofline: the least time its function could take
at the card's published peaks (``portbench/roofline.py``), summed over the
batches of the window's profiles, over the device time of the kernels
their launches ran (the trace)."""
from portbench import tracing
from portbench.loop import numeric_lanes


def share(ctx, counter, kernels, bound_fn):
    summary = ctx["trace"]
    cell = ctx["cell"]
    if summary is None or not cell.window_counts.get(counter, 0):
        return None
    events, seconds = tracing.kernel_seconds(summary, kernels)
    if not events or seconds <= 0:
        return None
    cfg = ctx["config"]
    lanes, bins = numeric_lanes(cfg), int(cfg["bins"])
    bound_ms = sum(bound_fn(lanes, rows, bins) for p in cell.profiles
                   for rows in cell.batches[p["source"]])
    return 100.0 * bound_ms / 1e3 / seconds
