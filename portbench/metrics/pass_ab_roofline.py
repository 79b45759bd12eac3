"""The fused pass's share of its roofline: pass A's and pass B's
functions in one, over K4's kernels."""
from portbench import roofline
from portbench.metrics._roofline import share

KERNELS = ("stats_hist_partial", "stats_fold", "gram_tc", "gram_fold",
           "dev_fold")


def read(ctx):
    return share(ctx, "fused_ab", KERNELS,
                 lambda C, R, bins: roofline.pass_ab_bound(C, R, bins))
