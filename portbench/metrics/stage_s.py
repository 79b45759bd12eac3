"""Mean seconds a two-pass profile's thread spent staging batches for
the card, both passes (quiet spans ``stage_a`` + ``stage_b``: stacking,
pinning, the copy's enqueue)."""
from portbench.metrics._sum import sum_spans


def read(ctx):
    return sum_spans(ctx, ("stage_a", "stage_b"), "two_pass")
