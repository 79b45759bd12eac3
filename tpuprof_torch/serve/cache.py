"""Keyed runner cache and the read tier of the port's serve daemon.

Counterpart of ``tpuprof/serve/cache.py``.  Every profile builds its runner
through :func:`acquire_runner` (``GPUStatsBackend._runner``,
``StreamingProfiler.__init__``, the scheduler's jobs).  Runners are keyed
on exactly the fields that decide what they launch (:func:`runner_key`),
so a repeat-shape job reuses the same runner object.  A runner holds no
per-profile state (``runtime/runner.py``: its constructor only reads the
config), so reuse cannot change a result.  On a miss the store of built
kernel libraries (``runtime/aot.py``) is consulted before the first launch
builds anything, and fed in the background after it.

The cache is process-wide and on by default (``TPUPROF_RUNNER_CACHE=0``
builds a runner per call; an integer sets the LRU capacity, default 8).

The reference's module also gates jax's persistent compilation cache
(``_note_build_with_cache``), which guards a jaxlib abort on repeated
program builds.  The port has no jit programs, no such cache and no such
abort, so nothing stands in its place.

The read tier: :class:`ResultCache` holds canonical serialized answers
keyed by (source fingerprint, config fingerprint), LRU-bounded by entries
and bytes, CRC-checked on every read; a rotten entry is demoted loudly to
a miss (:class:`~tpuprof_torch.errors.CorruptReadCacheError`), never
served.
"""

from __future__ import annotations

import collections
import hashlib
import json
import logging
import os
import threading
import zlib
from typing import Any, Dict, Optional, Sequence, Tuple

from tpuprof_torch.obs import events as _obs_events
from tpuprof_torch.obs import metrics as _obs_metrics
from tpuprof_torch.runtime import aot as _aot

logger = logging.getLogger("tpuprof_torch")

_CACHE_HITS = _obs_metrics.counter(
    "tpuprof_serve_compile_cache_hits_total",
    "profile runs that reused a cached MeshRunner (compiled programs "
    "warm — no recompile)")
_CACHE_MISSES = _obs_metrics.counter(
    "tpuprof_serve_compile_cache_misses_total",
    "profile runs that had to build (and later compile) a fresh "
    "MeshRunner")

_ENV = "TPUPROF_RUNNER_CACHE"
DEFAULT_CAPACITY = 8


def _env_capacity() -> int:
    """``TPUPROF_RUNNER_CACHE``: unset/empty -> default capacity;
    ``0``/``false``/``no`` -> caching off; any other integer -> that LRU
    capacity."""
    raw = os.environ.get(_ENV)
    if raw in (None, ""):
        return DEFAULT_CAPACITY
    if raw.strip().lower() in ("0", "false", "no"):
        return 0
    try:
        return max(int(raw), 0)
    except ValueError:
        return DEFAULT_CAPACITY


def _resolved(devices: Optional[Sequence]):
    """The devices a runner would run on: ``None`` is ``resolve_device``'s
    default (``cuda:0``, raising without CUDA)."""
    from tpuprof_torch.runtime.runner import resolve_device
    if devices is None:
        return [resolve_device(None)]
    return [resolve_device(d) for d in devices]


def _device_id(dev) -> Tuple[str, Optional[int]]:
    index = dev.index
    if dev.type == "cuda" and index is None:
        import torch
        index = torch.cuda.current_device()
    return dev.type, index


def runner_key(config, n_num: int, n_hash: int,
               devices: Optional[Sequence] = None) -> Tuple:
    """The cache key: every field that decides what a runner launches —
    the shape ``(n_num, n_hash)``, the devices as ``(type, index)``,
    ``batch_rows``, ``mesh_devices``, ``hll_precision``, ``bins``, the
    resolved ``pass_b_kernel`` and the resolved ``profile_passes`` (a
    fused runner launches K4, a two-pass one K1 and K2).  Nothing more, so
    a job differing only in paths, telemetry or budgets still hits; the
    ``aot_*`` fields and the seeded-edge values are not keyed (edges are
    launch inputs, not runner structure)."""
    from tpuprof_torch.config import resolve_profile_passes
    devs = _resolved(devices)
    if len(devs) > 1 and config.mesh_devices:
        devs = devs[: config.mesh_devices]
    return (
        int(n_num), int(n_hash),
        tuple(_device_id(d) for d in devs),
        int(config.batch_rows),
        config.mesh_devices,
        int(config.hll_precision),
        int(config.bins),
        config.pass_b,
        resolve_profile_passes(config.profile_passes),
    )


def _build_runner(config, n_num: int, n_hash: int,
                  devices: Optional[Sequence]):
    """One device's Runner, or a MeshRunner over several."""
    devs = _resolved(devices)
    if len(devs) > 1:
        from tpuprof_torch.runtime.mesh import MeshRunner
        return MeshRunner(config, n_num, n_hash, devs)
    from tpuprof_torch.runtime.runner import Runner
    return Runner(config, n_num, n_hash, devs[0])


class RunnerCache:
    """Bounded LRU of live runners keyed by :func:`runner_key`.
    Thread-safe; the build runs under the lock (a runner's constructor
    only reads the config), so two racing workers share ONE runner.  The
    store consult on a miss runs under it too: a second worker of the same
    key waits for the adopted libraries instead of building them."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self.capacity = max(int(capacity), 1)
        self._lock = threading.Lock()
        self._runners: "collections.OrderedDict[Tuple, Any]" = \
            collections.OrderedDict()
        self.hits = 0
        self.misses = 0

    def get(self, config, n_num: int, n_hash: int,
            devices: Optional[Sequence] = None):
        key = runner_key(config, n_num, n_hash, devices)
        with self._lock:
            runner = self._runners.get(key)
            if runner is not None:
                self._runners.move_to_end(key)
                self.hits += 1
                _CACHE_HITS.inc()
                return runner
            runner = _build_runner(config, n_num, n_hash, devices)
            # the store of built kernel libraries: adopt this key's
            # libraries before the first launch would build them, or
            # publish them in the background once built.  Never raises:
            # a rotten store demotes loudly to the nvcc build
            _aot.on_runner_miss(runner, config, key, n_num, n_hash)
            self._runners[key] = runner
            while len(self._runners) > self.capacity:
                self._runners.popitem(last=False)
            self.misses += 1
            _CACHE_MISSES.inc()
            return runner

    def __contains__(self, key: Tuple) -> bool:
        with self._lock:
            return key in self._runners

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            total = self.hits + self.misses
            return {"runners": len(self._runners),
                    "capacity": self.capacity,
                    "hits": self.hits, "misses": self.misses,
                    "hit_rate": self.hits / total if total else 0.0}

    def clear(self) -> None:
        with self._lock:
            self._runners.clear()
            self.hits = 0
            self.misses = 0


# ---------------------------------------------------------------------------
# process-wide cache + the acquire seam
# ---------------------------------------------------------------------------

_process_cache = RunnerCache(_env_capacity() or 1)


def process_cache() -> RunnerCache:
    return _process_cache


def cache_enabled() -> bool:
    return _env_capacity() > 0


def acquire_runner(config, n_num: int, n_hash: int,
                   devices: Optional[Sequence] = None):
    """The one seam every profile path builds runners through: a Runner
    on ``devices[0]``, or a MeshRunner when ``devices`` holds several
    (``None``: ``cuda:0``).  Cached by default; with the cache off, a
    fresh runner per call, as before the cache."""
    if not cache_enabled():
        _CACHE_MISSES.inc()
        return _build_runner(config, n_num, n_hash, devices)
    return _process_cache.get(config, n_num, n_hash, devices=devices)


def cache_stats() -> Dict[str, Any]:
    """Hit/miss view of the process cache (the scheduler's stats)."""
    return _process_cache.stats()


# ---------------------------------------------------------------------------
# the read tier: the answer cache
# ---------------------------------------------------------------------------

_READ_HITS = _obs_metrics.counter(
    "tpuprof_read_cache_hits_total",
    "read-tier requests answered from the edge result cache (no "
    "scheduler admission, no mesh)")
_READ_MISSES = _obs_metrics.counter(
    "tpuprof_read_cache_misses_total",
    "read-tier lookups that found no (or a rotten) cached answer")
_READ_EVICTIONS = _obs_metrics.counter(
    "tpuprof_read_cache_evictions_total",
    "read-cache entries dropped to respect the entry/bytes caps")
_READ_DEMOTES = _obs_metrics.counter(
    "tpuprof_read_cache_demotes_total",
    "read-cache entries dropped because their payload failed its CRC "
    "check (CorruptReadCacheError demoted to a miss)")
_READ_BYTES = _obs_metrics.gauge(
    "tpuprof_read_cache_bytes",
    "payload bytes currently held by the edge result cache")
_READ_ENTRIES = _obs_metrics.gauge(
    "tpuprof_read_cache_entries",
    "entries currently held by the edge result cache")


def source_fingerprint(source: Any) -> str:
    """The read tier's identity of a source: path + mtime_ns + size,
    hashed short.  Rewriting the file changes it, so cached answers
    invalidate with no TTL; a source that cannot be stat'ed falls back to
    the path text alone."""
    text = os.path.abspath(str(source))
    try:
        st = os.stat(text)
        raw = f"{text}|{st.st_mtime_ns}|{st.st_size}"
    except OSError:
        raw = text
    return hashlib.sha1(raw.encode()).hexdigest()[:16]


def etag_for(payload: bytes) -> str:
    """A strong ETag of a serialized answer: the CRC32 of its bytes,
    quoted."""
    return '"crc32-%08x"' % (zlib.crc32(payload) & 0xFFFFFFFF)


def canonical_body(doc: Dict[str, Any]) -> bytes:
    """The one serialization of a cached answer (indent=1, default=str),
    so a hit's bytes equal the miss that stored them."""
    return (json.dumps(doc, indent=1, default=str) + "\n").encode()


class ResultCache:
    """Bounded LRU of serialized answers, capped on entries AND payload
    bytes.  Thread-safe.  Entries are ``(payload, crc32)``; every
    :meth:`get` re-hashes the payload, and a mismatch drops the entry,
    counts it and reports a miss."""

    def __init__(self, capacity: int = 512,
                 max_bytes: int = 64 << 20):
        self.capacity = max(int(capacity), 1)
        self.max_bytes = max(int(max_bytes), 1)
        self._lock = threading.Lock()
        self._entries: "collections.OrderedDict[Any, Tuple[bytes, int]]" \
            = collections.OrderedDict()
        self._bytes = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.demotes = 0

    def put(self, key: Any, doc: Dict[str, Any]) -> str:
        """Store ``doc`` under ``key``; returns its ETag.  An answer larger
        than the whole bytes cap is not stored."""
        payload = canonical_body(doc)
        crc = zlib.crc32(payload) & 0xFFFFFFFF
        etag = '"crc32-%08x"' % crc
        if len(payload) > self.max_bytes:
            return etag
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= len(old[0])
            self._entries[key] = (payload, crc)
            self._bytes += len(payload)
            while (len(self._entries) > self.capacity
                   or self._bytes > self.max_bytes):
                _, (dropped, _c) = self._entries.popitem(last=False)
                self._bytes -= len(dropped)
                self.evictions += 1
                _READ_EVICTIONS.inc()
            _READ_BYTES.set(self._bytes)
            _READ_ENTRIES.set(len(self._entries))
            entries = len(self._entries)
        if _obs_metrics.enabled():
            _obs_events.emit("read_cache", status="store",
                             bytes=len(payload), entries=entries)
        return etag

    def get(self, key: Any) -> Optional[Tuple[bytes, str]]:
        """``(payload, etag)`` of a sound entry, ``None`` on a miss; a CRC
        mismatch demotes the entry and reports the miss."""
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                self.misses += 1
                _READ_MISSES.inc()
                return None
            payload, crc = entry
            if (zlib.crc32(payload) & 0xFFFFFFFF) != crc:
                self._entries.pop(key, None)
                self._bytes -= len(payload)
                self.demotes += 1
                self.misses += 1
                _READ_DEMOTES.inc()
                _READ_MISSES.inc()
                _READ_BYTES.set(self._bytes)
                _READ_ENTRIES.set(len(self._entries))
                entries = len(self._entries)
            else:
                self._entries.move_to_end(key)
                self.hits += 1
                _READ_HITS.inc()
                return payload, '"crc32-%08x"' % crc
        from tpuprof_torch.errors import CorruptReadCacheError
        exc = CorruptReadCacheError(
            f"read-cache entry {key!r} failed its CRC check — dropped; "
            "this request recomputes")
        logger.warning(str(exc))
        if _obs_metrics.enabled():
            _obs_events.emit("read_cache", status="demote",
                             bytes=len(payload), entries=entries)
        return None

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            total = self.hits + self.misses
            return {"entries": len(self._entries),
                    "bytes": self._bytes,
                    "capacity": self.capacity,
                    "max_bytes": self.max_bytes,
                    "hits": self.hits, "misses": self.misses,
                    "evictions": self.evictions,
                    "demotes": self.demotes,
                    "hit_rate": self.hits / total if total else 0.0}

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._bytes = 0
            self.hits = 0
            self.misses = 0
            self.evictions = 0
            self.demotes = 0
            _READ_BYTES.set(0)
            _READ_ENTRIES.set(0)
