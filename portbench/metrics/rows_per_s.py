"""Rows of every profile or job completed in the window, over the time
from the window's start to the last completion (host clock)."""


def read(ctx):
    rows = sum(p["rows"] for p in ctx["cell"].profiles)
    span = ctx["t_last"] - ctx["t0"]
    return rows / span if rows and span > 0 else None
