"""Mean seconds a fused profile spent in its one scan (the span named
``scan_a`` in a fused profile's ``stats["_phases"]``)."""
from portbench.metrics._phases import mean_span


def read(ctx):
    return mean_span(ctx, "scan_a", "fused")
