"""Seconds from the process's start to the window's start: imports, the
table, kernel builds or loads, the warm-up."""


def read(ctx):
    return ctx["setup_s"]
