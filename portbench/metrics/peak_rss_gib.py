"""The highest resident set of the process during the window (VmRSS of
/proc/self/status, sampled every 20 ms), in GiB."""


def read(ctx):
    peak = ctx["rss_peak_bytes"]
    return peak / 2 ** 30 if peak else None
