"""Pass A's share of its roofline: the moments and the pairwise-complete
Pearson Gram, over K1's kernels."""
from portbench import roofline
from portbench.metrics._roofline import share

KERNELS = ("stats_partial", "stats_fold", "gram_tc", "gram_fold")


def read(ctx):
    return share(ctx, "fused_a", KERNELS,
                 lambda C, R, bins: roofline.pass_a_bound(C, R))
