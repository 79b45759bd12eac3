"""What the host did while a profile ran, for each profile's line on
standard error: the wall seconds, this process's CPU seconds (user and
system) and the seconds in Python's garbage collector, from
``getrusage`` and ``gc.callbacks``; and the resident set (VmRSS)."""

from __future__ import annotations

import gc
import resource
import time
from typing import Dict

_gc = {"s": 0.0, "t0": 0.0}


def _gc_timer(phase, _info) -> None:
    if phase == "start":
        _gc["t0"] = time.perf_counter()
    else:
        _gc["s"] += time.perf_counter() - _gc["t0"]


def start() -> None:
    """Time the garbage collector from now on."""
    if _gc_timer not in gc.callbacks:
        gc.callbacks.append(_gc_timer)


def rss() -> int:
    """This process's resident set now (VmRSS), in bytes."""
    with open("/proc/self/status") as fh:
        for ln in fh:
            if ln.startswith("VmRSS:"):
                return int(ln.split()[1]) * 1024
    return 0


def snapshot() -> Dict[str, float]:
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return {"t": time.perf_counter(), "cpu": ru.ru_utime + ru.ru_stime,
            "sys": ru.ru_stime, "gc": _gc["s"]}


def delta(after: Dict[str, float], before: Dict[str, float]
          ) -> Dict[str, float]:
    """What happened between two snapshots; ``at`` is the first's
    ``time.perf_counter()``."""
    return {"at": before["t"], "wall": after["t"] - before["t"],
            "cpu": after["cpu"] - before["cpu"],
            "sys": after["sys"] - before["sys"],
            "gc": after["gc"] - before["gc"]}


def line(d: Dict[str, float]) -> str:
    return (f"at {d['at']:.3f} wall {d['wall']:.3f} cpu {d['cpu']:.3f} "
            f"sys {d['sys']:.3f} gc {d['gc']:.3f}")
