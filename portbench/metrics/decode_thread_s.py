"""Mean thread-seconds a two-pass profile's prepare pool spent decoding,
both passes (``decode_a`` + ``decode_b``, summed over the leaf tasks, not
ranges of the trace)."""
from portbench.metrics._sum import sum_spans


def read(ctx):
    return sum_spans(ctx, ("decode_a", "decode_b"), "two_pass")
