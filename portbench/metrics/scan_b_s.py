"""Mean seconds a two-pass profile spent in its ``scan_b`` span."""
from portbench.metrics._phases import mean_span


def read(ctx):
    return mean_span(ctx, "scan_b", "two_pass")
