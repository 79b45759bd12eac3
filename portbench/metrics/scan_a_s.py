"""Mean seconds a two-pass profile spent in its ``scan_a`` span."""
from portbench.metrics._phases import mean_span


def read(ctx):
    return mean_span(ctx, "scan_a", "two_pass")
