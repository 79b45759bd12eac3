"""Mean seconds a two-pass profile's thread spent in pass A's host folds
(quiet spans ``sampler_a`` + ``hll_host_a`` + ``hostagg_a``)."""
from portbench.metrics._sum import sum_spans


def read(ctx):
    return sum_spans(ctx, ("sampler_a", "hll_host_a", "hostagg_a"),
                     "two_pass")
