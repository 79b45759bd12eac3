"""Mean thread-seconds a two-pass profile's prepare pool spent hashing in
pass A (``hash_a``, summed over the leaf tasks, not a range of the
trace)."""
from portbench.metrics._phases import mean_span


def read(ctx):
    return mean_span(ctx, "hash_a", "two_pass")
