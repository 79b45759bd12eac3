"""Mean seconds a two-pass profile's thread waited in pass B for the
next prepared batch (quiet span ``wait_b``)."""
from portbench.metrics._phases import mean_span


def read(ctx):
    return mean_span(ctx, "wait_b", "two_pass")
