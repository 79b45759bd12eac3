"""Mean seconds a two-pass profile's thread waited in pass A for the
next prepared batch (quiet span ``wait_a``)."""
from portbench.metrics._phases import mean_span


def read(ctx):
    return mean_span(ctx, "wait_a", "two_pass")
