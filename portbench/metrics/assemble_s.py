"""Mean seconds a two-pass profile spent assembling its stats (span
``assemble``: the first rows' sample, ``_assemble``, the bin seeds and the
quarantine tail)."""
from portbench.metrics._phases import mean_span


def read(ctx):
    return mean_span(ctx, "assemble", "two_pass")
