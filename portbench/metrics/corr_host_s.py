"""Mean seconds a two-pass profile's thread spent on the Pearson matrix's
host work (quiet span ``corr_host``: ``kcorr.finalize`` of pass A's Gram,
the (C, C) frame and the rejection scan), which grows with the square of
the numeric columns."""
from portbench.metrics._phases import mean_span


def read(ctx):
    return mean_span(ctx, "corr_host", "two_pass")
