"""Host-to-device bytes over the device seconds of those copies (the
trace's HtoD ``gpu_memcpy`` events), in GB/s."""


def read(ctx):
    s = ctx["trace"]
    if s is None or not s["h2d_bytes"] or s["h2d_s"] <= 0:
        return None
    return s["h2d_bytes"] / s["h2d_s"] / 1e9
