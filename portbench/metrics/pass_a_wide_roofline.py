"""Pass A's share of its roofline past 512 numeric columns: the moments
and the pairwise-complete Pearson Gram, over the kernels K3 launches
(``gram.cuh``'s four, and ``stats_identity`` where it skips the
statistics).  The work is counted from shapes, as ``pass_a_roofline``
counts it."""
from portbench import roofline
from portbench.metrics._roofline import share

KERNELS = ("stats_partial", "stats_fold", "gram_tc", "gram_fold",
           "stats_identity")


def read(ctx):
    return share(ctx, "fused_wide", KERNELS,
                 lambda C, R, bins: roofline.pass_a_bound(C, R))
