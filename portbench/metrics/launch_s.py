"""Mean seconds a two-pass profile's thread spent launching the passes'
kernels (quiet spans ``launch_a`` + ``launch_b``)."""
from portbench.metrics._sum import sum_spans


def read(ctx):
    return sum_spans(ctx, ("launch_a", "launch_b"), "two_pass")
