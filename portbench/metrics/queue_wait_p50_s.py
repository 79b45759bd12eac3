"""The median of a job's wait in the queue: the scheduler's started
timestamp less its enqueued one."""
import statistics


def read(ctx):
    waits = [p["queue_wait"] for p in ctx["cell"].profiles
             if "queue_wait" in p]
    return statistics.median(waits) if waits else None
