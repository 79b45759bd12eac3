"""The mean seconds a profile spent in one span of ``stats["_phases"]``."""


def mean_span(ctx, name, passes):
    if ctx["traffic"]["profile_passes"] != passes:
        return None
    vals = [p["phases"][name] for p in ctx["cell"].profiles
            if name in p.get("phases", {})]
    return sum(vals) / len(vals) if vals else None
