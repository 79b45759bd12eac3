"""100 less the share of the traced window that the union of the device's
kernel, copy and fill intervals covers."""


def read(ctx):
    s = ctx["trace"]
    if s is None or s["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])
