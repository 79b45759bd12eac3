"""Tracing, phase timing and structured log lines.

Counterpart of ``tpuprof/utils/trace.py``:

* ``trace_to(dir, device)`` records everything inside the context with
  ``torch.profiler``: host activity, plus the device's kernels and copies
  when ``device`` is a CUDA device (the ``--trace`` flag).  It writes one
  Chrome-trace JSON, ``dir/tpuprof-trace-<pid>.json``, which Perfetto
  (ui.perfetto.dev) and ``chrome://tracing`` open; every span opened
  meanwhile (``obs/spans.py``) is a ``record_function`` range of its name
  there.  A no-op when ``dir`` is empty.
* ``phase_timer(name)`` is :func:`tpuprof_torch.obs.spans.span`.
* ``log_event(event, **fields)`` logs one JSON line on the
  ``tpuprof_torch`` logger; field values go through ``default=str`` so
  numpy scalars, paths and timestamps never break it.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
from typing import Iterator, Optional

from tpuprof_torch.obs import spans
from tpuprof_torch.obs.spans import get_phase_report, span as phase_timer  # noqa: F401  (re-exported)

logger = logging.getLogger("tpuprof_torch")


def trace_path(trace_dir: str) -> str:
    """The file :func:`trace_to` writes in ``trace_dir``."""
    return os.path.join(trace_dir, f"tpuprof-trace-{os.getpid()}.json")


@contextlib.contextmanager
def trace_to(trace_dir: Optional[str], device=None) -> Iterator[None]:
    if not trace_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    dev = torch.device(device) if device is not None else torch.device("cpu")
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    path = trace_path(trace_dir)
    prof = profile(activities=activities, record_shapes=False,
                   with_stack=False)
    spans.annotate = record_function
    try:
        with prof:
            yield
            if dev.type == "cuda":
                # the device's last work lands inside the trace
                torch.cuda.synchronize(dev)
    finally:
        spans.annotate = None
        prof.export_chrome_trace(path)
        # the trace exists even when the body raised: say where it is
        # then, when someone will want to look at it
        logger.info("tpuprof_torch trace written to %s (open it in "
                    "Perfetto or chrome://tracing)", path)


def log_event(event: str, **fields) -> None:
    logger.debug("%s", json.dumps({"event": event, **fields}, default=str))
