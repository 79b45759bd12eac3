"""Mean seconds a two-pass profile spent opening its source (span
``ingest_open``: ``ArrowIngest``, with a frame's Arrow conversion)."""
from portbench.metrics._phases import mean_span


def read(ctx):
    return mean_span(ctx, "ingest_open", "two_pass")
