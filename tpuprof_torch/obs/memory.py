"""Device and host memory gauges (OBSERVABILITY.md "memory gauges").

Counterpart of ``tpuprof/obs/memory.py``.  A long profile fails on
headroom, not speed: device memory creeping toward the card's size as
staged batches pile up, or host RSS growing.  The backend and the stream
sample both at drain boundaries (the end of pass A, the end of a profile,
a stream's drains; never a batch):

* ``tpuprof_device_memory_bytes{device="cuda:<index>", kind=...}``: on a
  CUDA device ``in_use`` is ``torch.cuda.memory_allocated`` (the bytes of
  live tensors) and ``limit`` the card's total memory
  (``torch.cuda.mem_get_info``); a CPU device reports nothing and the
  gauges stay silent, as the reference's do on its CPU backend;
* ``tpuprof_host_rss_bytes`` from ``/proc/self/statm`` (else the peak RSS
  of ``resource.getrusage``).

:func:`sample` also returns the plain dict; it records into the registry
only when metrics are on.  torch is imported only where a device is read.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Iterable, Optional

from tpuprof_torch.obs import metrics as _obs_metrics

_DEVICE_MEM = _obs_metrics.gauge(
    "tpuprof_device_memory_bytes",
    "accelerator memory bytes by device and kind (in_use/limit); "
    "silent on a CPU device")
_HOST_RSS = _obs_metrics.gauge(
    "tpuprof_host_rss_bytes",
    "resident set size of this process at the last drain boundary")


def host_rss_bytes() -> Optional[int]:
    """Current RSS in bytes (None when unreadable)."""
    try:
        with open("/proc/self/statm") as fh:
            fields = fh.read().split()
        return int(fields[1]) * os.sysconf("SC_PAGESIZE")
    except (OSError, IndexError, ValueError):
        pass
    try:
        import resource
        ru = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        # Linux reports KiB, macOS bytes
        return int(ru) * (1 if ru > 1 << 32 else 1024)
    except (ImportError, OSError, ValueError):
        return None


def device_memory(devices: Iterable = ()) -> Dict[str, Dict[str, int]]:
    """``{"cuda:<index>": {"in_use": ..., "limit": ...}}`` for each CUDA
    device of ``devices`` (``torch.device`` objects or their names); a CPU
    device gives no entry."""
    out: Dict[str, Dict[str, int]] = {}
    for dev in devices:
        import torch
        dev = torch.device(dev)
        if dev.type != "cuda":
            continue
        index = dev.index if dev.index is not None \
            else torch.cuda.current_device()
        out[f"cuda:{index}"] = {
            "in_use": int(torch.cuda.memory_allocated(index)),
            "limit": int(torch.cuda.mem_get_info(index)[1])}
    return out


def sample(*devices) -> Dict[str, Any]:
    """One sample of ``devices`` (the profile's device) and of the host:
    sets the gauges when metrics are on, and returns the plain dict either
    way."""
    devmem = device_memory(devices)
    rss = host_rss_bytes()
    if _obs_metrics.enabled():
        for label, ent in devmem.items():
            for kind, value in ent.items():
                _DEVICE_MEM.set(value, device=label, kind=kind)
        if rss is not None:
            _HOST_RSS.set(rss)
    return {"devices": devmem, "host_rss_bytes": rss}
