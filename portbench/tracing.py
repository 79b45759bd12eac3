"""Reading a ``torch.profiler`` Chrome trace of the measured window.

:func:`summarize` reduces the trace to what the per-layer readers need:
the window's bounds, the union of the device's kernel, copy and fill
intervals inside it, each kernel's events and device seconds by its bare
function name, the host-to-device copies' bytes and seconds, and the
device's idle gaps, each named by the innermost program span open on the
host at its middle.
"""

from __future__ import annotations

import bisect
from typing import Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "portbench.window"


def kernel_name(name: str) -> str:
    """``void tpt::gram_tc<...>(...)`` and ``(anonymous
    namespace)::hist_partial(...)``: the bare function name."""
    name = name.replace("(anonymous namespace)::", "")
    name = name.split("(")[0].split("<")[0].split()[-1]
    return name.split("::")[-1]


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def summarize(doc: dict, window: str = WINDOW) -> Dict:
    """The trace's numbers over the user annotation ``window`` (times in
    seconds).  Raises ``ValueError`` when the trace has not exactly one
    such range."""
    evs = [e for e in doc.get("traceEvents", []) if "dur" in e
           and "ts" in e]
    wins = [e for e in evs if e.get("cat") == "user_annotation"
            and e.get("name") == window]
    if len(wins) != 1:
        raise ValueError(f"trace: {len(wins)} {window!r} ranges")
    lo = float(wins[0]["ts"])
    hi = lo + float(wins[0]["dur"])
    device = [e for e in evs if e.get("cat") in DEVICE_CATS
              and e["ts"] < hi and e["ts"] + e["dur"] > lo]
    busy = _union([(max(float(e["ts"]), lo), min(float(e["ts"]) + e["dur"],
                                                  hi)) for e in device])
    kernels: Dict[str, List[float]] = {}
    ops: Dict[str, float] = {}
    h2d_bytes = 0
    h2d_us = 0.0
    for e in device:
        if e["cat"] == "kernel":
            name = kernel_name(e["name"])
            n_us = kernels.setdefault(name, [0, 0.0])
            n_us[0] += 1
            n_us[1] += e["dur"]
        else:
            name = e["name"]
        ops[name] = ops.get(name, 0.0) + e["dur"]
        if e["cat"] == "gpu_memcpy" and "HtoD" in e["name"]:
            h2d_bytes += int((e.get("args") or {}).get("bytes", 0))
            h2d_us += e["dur"]
    # idle gaps named by the innermost program span (the shortest user
    # annotation other than the window) open on the host; a gap that
    # crosses a span's edge is split there
    spans = sorted(((float(e["ts"]), float(e["ts"]) + e["dur"], e["name"])
                    for e in evs if e.get("cat") == "user_annotation"
                    and e.get("name") != window),
                   key=lambda s: s[1] - s[0])
    edges = sorted({t for s, e, _ in spans for t in (s, e)})
    gaps: Dict[str, float] = {}
    edge = lo
    for a, b in busy + [(hi, hi)]:
        if a > edge:
            cuts = [edge] + edges[bisect.bisect_right(edges, edge):
                                  bisect.bisect_left(edges, a)] + [a]
            for u, v in zip(cuts, cuts[1:]):
                mid = 0.5 * (u + v)
                owner = next((n for s, t, n in spans if s <= mid <= t),
                             "outside any span")
                gaps[owner] = gaps.get(owner, 0.0) + (v - u) / 1e6
        edge = max(edge, b)
    return {
        "window_s": (hi - lo) / 1e6,
        "busy_s": sum(b - a for a, b in busy) / 1e6,
        "kernels": {k: (int(n), us / 1e6) for k, (n, us) in kernels.items()},
        "device_ops": sorted(((k, us / 1e6) for k, us in ops.items()),
                             key=lambda kv: -kv[1]),
        "h2d_bytes": h2d_bytes,
        "h2d_s": h2d_us / 1e6,
        "idle_gaps": sorted(gaps.items(), key=lambda kv: -kv[1]),
    }


def kernel_seconds(summary: Dict, names) -> Tuple[int, float]:
    """(events, device seconds) of the kernels named ``names``."""
    got = [summary["kernels"][n] for n in names if n in summary["kernels"]]
    return sum(n for n, _ in got), sum(s for _, s in got)
