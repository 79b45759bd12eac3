"""The median of a job's latency at its client: from the submit to the
terminal state that ``wait`` returns."""
import statistics


def read(ctx):
    lat = [p["t1"] - p["t0"] for p in ctx["cell"].profiles
           if "queue_wait" in p]
    return statistics.median(lat) if lat else None
