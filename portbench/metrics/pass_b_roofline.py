"""Pass B's share of its roofline: the histogram counts and the MAD, over
K2's kernels.  At 10 bins the bound is the bytes'."""
from portbench import roofline
from portbench.metrics._roofline import share

KERNELS = ("hist_partial", "hist_partial_cluster", "hist_partial_global",
           "dev_fold")


def read(ctx):
    return share(ctx, "hist_b", KERNELS,
                 lambda C, R, bins: roofline.pass_b_bound(C, R, bins))
