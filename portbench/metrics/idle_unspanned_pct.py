"""The share of the card's idle time in the window that no program span
explains: the trace summary's ``outside any span`` idle gap over all its
idle gaps, in %."""


def read(ctx):
    s = ctx["trace"]
    if s is None:
        return None
    idle = sum(sec for _, sec in s["idle_gaps"])
    if idle <= 0:
        return None
    return 100.0 * dict(s["idle_gaps"]).get("outside any span", 0.0) / idle
