"""Span-based tracing: nested wall-clock timing with metadata.

Counterpart of ``tpuprof/obs/spans.py``.  ``span("scan_a", cols=200)``
times its body and records the wall seconds into

* the per-phase totals (:func:`get_phase_report`): the backend resets them
  when a profile starts and snapshots them onto the profile's
  ``stats["_phases"]`` when it ends; the report footer reads them there;
* the ``tpuprof_span_seconds{name=...}`` histogram (when metrics are on);
* one ``{"kind": "span"}`` event (into the flight recorder always, into
  the JSONL sink when one is configured), carrying the dotted path
  (``"profile.scan_a"``), the nesting depth and the span's metadata;
* a debug log line;
* while ``utils/trace.trace_to`` records a ``torch.profiler`` trace, a
  ``record_function`` range of the same name, so the trace's timeline
  shows the pipeline's stages above the device's kernels.

Nesting is per thread (a ``threading.local`` stack): spans opened by pool
threads neither see nor corrupt the main thread's stack.  Phase totals
accumulate under the span's leaf name.

``span(name, quiet=True)``, for stages that run once a batch, keeps the
first and last of those (the phase total and the trace's range) and
drops the rest, so a profile's hundreds of them flood neither the flight
recorder's ring nor a JSONL sink; it is not on the nesting stack.  A
profile's quiet spans (``backends/gpu.py``) are ``wait_a``/``wait_b``,
``sampler_a``, ``hll_host_a``, ``hostagg_a``, ``recount_b``,
``stage_a``/``stage_b``, ``launch_a``/``launch_b``, ``drain_b`` and
``corr_host`` (the Pearson matrix's host work after pass A's merge and in
the assembly).
:func:`add` adds thread-seconds measured elsewhere, from any thread, to
the phase totals and never marks the trace: the benchmark names the
card's idle time by the innermost range open on any thread, so only the
thread that runs the profile marks the trace (``backends/gpu.py``), and
the prepare pool's decode and hashing seconds arrive through :func:`add`
(``ingest/arrow.py``).
"""

from __future__ import annotations

import contextlib
import json
import logging
import threading
import time
from typing import Any, Callable, Dict, Iterator, Optional

from tpuprof_torch.obs import events, metrics

logger = logging.getLogger("tpuprof_torch")

_lock = threading.Lock()
_phase_totals: Dict[str, float] = {}
_tls = threading.local()
# set by utils/trace.trace_to while a profiler trace records: a callable
# from a span name to a context manager that marks the range in the trace
annotate: Optional[Callable[[str], Any]] = None

_SPAN_SECONDS = metrics.histogram(
    "tpuprof_span_seconds",
    "wall-clock seconds per pipeline span, by leaf name")


def _stack() -> list:
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


def current_path() -> str:
    """Dotted path of the innermost open span on THIS thread ('' at top
    level)."""
    return ".".join(_stack())


def add(name: str, seconds: float) -> None:
    """Add ``seconds`` to phase ``name``'s total; safe from any thread."""
    with _lock:
        _phase_totals[name] = _phase_totals.get(name, 0.0) + seconds


@contextlib.contextmanager
def span(name: str, quiet: bool = False, **meta: Any) -> Iterator[None]:
    """Time a pipeline stage.  Exceptions propagate; the time is recorded
    either way (a failed stage's cost is still cost).  ``quiet`` records
    the phase total and the trace's range only (module docstring)."""
    if not quiet:
        stack = _stack()
        stack.append(name)
    mark = annotate(name) if annotate is not None \
        else contextlib.nullcontext()
    t0 = time.perf_counter()
    try:
        with mark:
            yield
    finally:
        dt = time.perf_counter() - t0
        add(name, dt)
        if not quiet:
            depth = len(stack)
            stack.pop()
            _SPAN_SECONDS.observe(dt, name=name)
            # into the flight recorder even with no sink: a postmortem of
            # a metrics-off run still shows which stages closed
            events.emit("span", name=name, seconds=round(dt, 6),
                        path=".".join(stack + [name]), depth=depth, **meta)
            if logger.isEnabledFor(logging.DEBUG):
                logger.debug("%s", json.dumps(
                    {"event": "phase", "name": name,
                     "seconds": round(dt, 4), **meta}, default=str))


def get_phase_report(reset: bool = False) -> Dict[str, float]:
    """Wall seconds accumulated per span leaf name since the last reset."""
    with _lock:
        out = dict(_phase_totals)
        if reset:
            _phase_totals.clear()
    return out
