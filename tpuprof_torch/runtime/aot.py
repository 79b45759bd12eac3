"""The store of built kernel libraries: restart-to-warm without nvcc.

Counterpart of ``tpuprof/runtime/aot.py``.  The reference stores serialized
XLA executables; the port has no jit programs, and what a restarted process
re-pays is the nvcc build of its kernel libraries (``kernels/csrc``,
``_build.py``) and their first launches.  This module stores those
libraries:

* after a runner-cache miss (``serve/cache.py``), the libraries the key's
  runner launches (:func:`libraries_for`) are built if they are not, then
  packed into one CRC-sealed envelope ``<digest>.aot`` — in a background
  thread, off the hot path (:func:`schedule_save`);
* the next process's miss for the same key verifies that envelope and
  writes each library under the name ``_build.library_path`` gives it in
  its own build directory, so ``kernels.library`` loads it with no nvcc
  run (:meth:`AotStore.load_into`);
* the store keeps an LRU manifest of hot keys, and a starting daemon's
  :class:`Prewarmer` acquires the top ones in the background: each
  library loaded and bound, and one launch on a one-batch zero input, so
  CUDA's lazy module load is paid before the first job.

Safety contract — restarts can be slow again but never wrong:

* an entry's digest covers the runner key, the environment fingerprint
  (:func:`env_fingerprint`: torch, its CUDA, nvcc's release, each card's
  name and compute capability, the device count, the store's schema) and
  the library file names, whose own digests cover the sources, headers and
  nvcc command; any skew is a different name, a clean miss.  A fingerprint
  or key inside an entry that disagrees with its name is forgery or rot;
* every entry is written by a dot-prefixed temporary file, fsync and
  rename; truncation at any offset, a bit flip anywhere, or a table that
  does not add up is :class:`~tpuprof_torch.errors.CorruptAotCacheError`,
  which the acquire seam demotes loudly to an nvcc build and unlinks;
* the whole entry is verified before any byte reaches the build
  directory, and each library lands there by a temporary file and a
  rename: an unverified ``.so`` is never ``dlopen``ed.
"""

from __future__ import annotations

import functools
import hashlib
import json
import logging
import os
import shutil
import subprocess
import threading
import time
import zlib
from typing import Any, Dict, List, Optional, Sequence, Tuple

from tpuprof_torch.errors import CorruptAotCacheError
from tpuprof_torch.obs import blackbox
from tpuprof_torch.obs import events as _obs_events
from tpuprof_torch.obs import metrics as _obs_metrics

logger = logging.getLogger("tpuprof_torch")

AOT_SCHEMA = "tpuprof-torch-aot-v1"
MANIFEST_SCHEMA = "tpuprof-torch-aot-manifest-v1"
_MAGIC = b"TPUPROF-TORCH-AOT1\n"

_HITS = _obs_metrics.counter(
    "tpuprof_aot_cache_hits_total",
    "runner-cache misses answered by deserializing AOT-cached "
    "executables instead of compiling")
_MISSES = _obs_metrics.counter(
    "tpuprof_aot_cache_misses_total",
    "runner-cache misses with no loadable AOT entry (fresh compile; "
    "corrupt entries demote here too)")
_LOAD_SECONDS = _obs_metrics.histogram(
    "tpuprof_aot_load_seconds",
    "wall seconds to deserialize + adopt one AOT store entry")
_SAVE_SECONDS = _obs_metrics.histogram(
    "tpuprof_aot_save_seconds",
    "wall seconds to AOT-compile + serialize + publish one store "
    "entry (background thread — off the serve hot path)")

# what this process's store did, whether or not metrics are on (the serve
# verb's closing line)
_counts_lock = threading.Lock()
counts = {"loaded": 0, "missed": 0, "corrupt": 0, "saved": 0}


def _count(what: str) -> None:
    with _counts_lock:
        counts[what] += 1


# ---------------------------------------------------------------------------
# what a key launches; the environment fingerprint; entry naming
# ---------------------------------------------------------------------------

def libraries_for(key: Tuple) -> List[str]:
    """The kernel libraries the runner of ``key`` (``serve/cache.
    runner_key``) may launch, by the runner's tiers: K2 (``hist_b``) for
    pass B and a fused profile's re-bins; up to 2,048 columns K3
    (``fused_wide``) and K6 (``rank``), which the Spearman kernel K5 also
    launches from up to 512 columns; up to 512 K1 (``fused_a``); K4
    (``fused_ab``) for a fused key within its columns and bins.
    Spearman is not in the key (nor in the reference's), so a key
    carries its Spearman tier's libraries too.  None on the CPU, where
    the plain versions run."""
    from tpuprof_torch.kernels.fused import (MAX_FUSED_AB_COLS,
                                             MAX_FUSED_COLS,
                                             MAX_FUSED_COLS_WIDE)
    from tpuprof_torch.kernels.hist import SHARED_MAX_BINS
    n_num, devices, bins, passes = key[0], key[2], key[6], key[8]
    if n_num == 0 or not devices \
            or any(t != "cuda" for t, _ in devices):
        return []
    names = {"hist_b"}
    if n_num <= MAX_FUSED_COLS_WIDE:
        names |= {"fused_wide", "rank"}
    if n_num <= MAX_FUSED_COLS:
        names.add("fused_a")
    if passes == "fused" and n_num <= MAX_FUSED_AB_COLS \
            and bins <= SHARED_MAX_BINS:
        names.add("fused_ab")
    return sorted(names)


def library_targets(names: Sequence[str]) -> Dict[str, str]:
    """{library: the file this process loads it from}."""
    if not names:
        return {}
    from tpuprof_torch import kernels
    return kernels.library_paths(names)


@functools.lru_cache(maxsize=1)
def nvcc_release() -> Optional[str]:
    """The release line of ``nvcc --version`` (None without nvcc)."""
    from tpuprof_torch import _build
    nvcc = shutil.which(_build.nvcc())
    if nvcc is None:
        return None
    try:
        out = subprocess.run([nvcc, "--version"], capture_output=True,
                             text=True, timeout=60).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    lines = [ln.strip() for ln in out.splitlines() if "release" in ln]
    return lines[0] if lines else out.strip() or None


def env_fingerprint(devices: Sequence[Tuple[str, Optional[int]]]
                    ) -> Dict[str, Any]:
    """Everything a stored library depends on beyond its own name: torch
    and its CUDA version, nvcc's release, each device's name and compute
    capability, the device count and the store's schema.  ``devices`` is
    a runner key's ``(type, index)`` tuple."""
    import torch
    cards = []
    for kind, index in devices:
        if kind == "cuda":
            cards.append([kind, index, torch.cuda.get_device_name(index),
                          list(torch.cuda.get_device_capability(index))])
        else:
            cards.append([kind, index, kind, None])
    return {
        "schema": AOT_SCHEMA,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "nvcc": nvcc_release(),
        "devices": cards,
        "device_count": torch.cuda.device_count()
        if torch.cuda.is_available() else 0,
    }


def entry_digest(key: Tuple, fingerprint: Dict[str, Any],
                 files: Sequence[str] = ()) -> str:
    canon = repr((tuple(key), sorted(fingerprint.items()),
                  tuple(sorted(files))))
    return hashlib.sha256(canon.encode()).hexdigest()[:32]


# ---------------------------------------------------------------------------
# the envelope: MAGIC + header JSON line + the libraries' bytes
# ---------------------------------------------------------------------------

def _atomic_write(path: str, data: bytes) -> None:
    """Dot-prefixed temporary file in the same directory, fsync, rename: a
    reader (or a crash) sees the old file or the new one, never torn
    bytes."""
    tmp = os.path.join(
        os.path.dirname(path) or ".",
        f".{os.path.basename(path)}.tmp.{os.getpid()}."
        f"{threading.get_ident()}")
    try:
        with open(tmp, "wb") as fh:
            fh.write(data)
            fh.flush()
            os.fsync(fh.fileno())
    except BaseException:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise
    os.replace(tmp, path)


def write_entry(path: str, key_repr: str, fingerprint: Dict[str, Any],
                libraries: Dict[str, str]) -> int:
    """Pack the files of ``libraries`` ({name: path}) into one sealed
    entry and publish it atomically.  Returns the entry's size."""
    table, blobs, offset = [], [], 0
    for name in sorted(libraries):
        with open(libraries[name], "rb") as fh:
            blob = fh.read()
        table.append({"name": name,
                      "file": os.path.basename(libraries[name]),
                      "offset": offset, "len": len(blob),
                      "crc32": zlib.crc32(blob) & 0xFFFFFFFF})
        blobs.append(blob)
        offset += len(blob)
    payload = b"".join(blobs)
    header = {
        "schema": AOT_SCHEMA,
        "key": key_repr,
        "fingerprint": fingerprint,
        "libraries": table,
        "payload_len": len(payload),
        "payload_crc32": zlib.crc32(payload) & 0xFFFFFFFF,
    }
    data = (_MAGIC + json.dumps(header, sort_keys=True).encode()
            + b"\n" + payload)
    _atomic_write(path, data)
    return len(data)


def read_entry(path: str, fingerprint: Dict[str, Any],
               key_repr: Optional[str] = None,
               files: Optional[Dict[str, str]] = None) -> Dict[str, bytes]:
    """Read and verify one entry: {library name: its bytes}.  A missing
    file raises ``FileNotFoundError`` (a clean miss); every other failure
    — truncation, a flipped bit, junk, a foreign schema, a fingerprint,
    key or library table that disagrees with the name (``files``: {name:
    file name} the digest covered) — is :class:`CorruptAotCacheError`."""
    try:
        with open(path, "rb") as fh:
            data = fh.read()
    except FileNotFoundError:
        raise
    except OSError as exc:
        raise CorruptAotCacheError(
            f"aot entry {path!r} is unreadable "
            f"({type(exc).__name__}: {exc})") from exc
    if not data.startswith(_MAGIC):
        raise CorruptAotCacheError(
            f"aot entry {path!r} has no {AOT_SCHEMA} magic — torn, "
            "truncated, or foreign bytes")
    nl = data.find(b"\n", len(_MAGIC))
    if nl < 0:
        raise CorruptAotCacheError(
            f"aot entry {path!r} truncated inside its header")
    try:
        header = json.loads(data[len(_MAGIC):nl])
    except ValueError as exc:
        raise CorruptAotCacheError(
            f"aot entry {path!r} header is not valid JSON — truncated "
            f"or corrupt ({exc})") from exc
    if not isinstance(header, dict) or header.get("schema") != AOT_SCHEMA:
        raise CorruptAotCacheError(
            f"aot entry {path!r} has schema "
            f"{header.get('schema') if isinstance(header, dict) else '?'!r};"
            f" this build reads {AOT_SCHEMA!r}")
    if header.get("fingerprint") != fingerprint:
        # skew lands on a DIFFERENT name (the digest covers the
        # fingerprint): a mismatch under the right name is rot or forgery
        raise CorruptAotCacheError(
            f"aot entry {path!r} carries a fingerprint that does not "
            "match its digest-addressed name — forged or rotted entry")
    if key_repr is not None and header.get("key") != key_repr:
        raise CorruptAotCacheError(
            f"aot entry {path!r} was written for a different runner "
            "key than its name claims — forged or rotted entry")
    payload = data[nl + 1:]
    if len(payload) != header.get("payload_len") \
            or zlib.crc32(payload) & 0xFFFFFFFF \
            != header.get("payload_crc32"):
        raise CorruptAotCacheError(
            f"aot entry {path!r} payload CRC/length mismatch — a "
            "truncated or bit-rotted library must never load")
    table = header.get("libraries")
    out: Dict[str, bytes] = {}
    offset = 0
    try:
        for row in table:
            blob = payload[row["offset"]:row["offset"] + row["len"]]
            if row["offset"] != offset or len(blob) != row["len"] \
                    or zlib.crc32(blob) & 0xFFFFFFFF != row["crc32"]:
                raise ValueError(f"library {row['name']!r}")
            out[row["name"]] = blob
            offset += row["len"]
        names = {row["name"]: row["file"] for row in table}
    except (TypeError, KeyError, ValueError) as exc:
        raise CorruptAotCacheError(
            f"aot entry {path!r} has a library table that does not add "
            f"up ({type(exc).__name__}: {exc})") from exc
    if offset != len(payload) \
            or (files is not None and names != dict(files)):
        raise CorruptAotCacheError(
            f"aot entry {path!r} holds other libraries than its name "
            "claims — forged or rotted entry")
    return out


# ---------------------------------------------------------------------------
# the store
# ---------------------------------------------------------------------------

class AotStore:
    """One directory of ``<digest>.aot`` entries plus the LRU-ordered
    ``manifest.json`` the prewarmer reads, for the devices of one runner
    key (their fingerprint is part of every entry's name)."""

    def __init__(self, root: str,
                 devices: Sequence[Tuple[str, Optional[int]]]):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self.fingerprint = env_fingerprint(devices)
        self._manifest_lock = threading.Lock()

    # -- naming -------------------------------------------------------------

    def entry_path(self, key: Tuple, targets: Dict[str, str]) -> str:
        files = [os.path.basename(p) for p in targets.values()]
        return os.path.join(
            self.root, f"{entry_digest(key, self.fingerprint, files)}.aot")

    @property
    def manifest_path(self) -> str:
        return os.path.join(self.root, "manifest.json")

    # -- load ---------------------------------------------------------------

    def load_into(self, key: Tuple, targets: Dict[str, str]) -> int:
        """Adopt this key's libraries: verify the whole entry, then write
        each library to its ``targets`` path ({name: path}) by a temporary
        file and a rename, unless a file is there already.  Returns the
        number of libraries adopted (0 = clean miss); raises
        :class:`CorruptAotCacheError` on any integrity failure, before
        any byte reaches a target."""
        from tpuprof_torch.testing import faults
        faults.hit("aot_load")
        path = self.entry_path(key, targets)
        t0 = time.perf_counter()
        try:
            blobs = read_entry(
                path, self.fingerprint, repr(tuple(key)),
                {n: os.path.basename(p) for n, p in targets.items()})
        except FileNotFoundError:
            return 0
        for name, target in targets.items():
            if not os.path.exists(target):
                os.makedirs(os.path.dirname(target) or ".", exist_ok=True)
                _atomic_write(target, blobs[name])
        seconds = time.perf_counter() - t0
        _LOAD_SECONDS.observe(seconds)
        _obs_events.emit("aot_load", path=path, status="hit",
                         programs=len(blobs), seconds=round(seconds, 4))
        return len(blobs)

    # -- save ---------------------------------------------------------------

    def save(self, key: Tuple, libraries: Dict[str, str]) -> Dict[str, Any]:
        """Pack the built ``libraries`` ({name: path}) of ``key`` into its
        entry and publish it.  Synchronous; :func:`schedule_save` runs it
        off the hot path."""
        t0 = time.perf_counter()
        path = self.entry_path(key, libraries)
        size = write_entry(path, repr(tuple(key)), self.fingerprint,
                           libraries)
        seconds = time.perf_counter() - t0
        _SAVE_SECONDS.observe(seconds)
        _obs_events.emit("aot_save", path=path, programs=len(libraries),
                         bytes=size, seconds=round(seconds, 4))
        return {"path": path, "libraries": len(libraries), "bytes": size,
                "seconds": seconds}

    # -- manifest (prewarm LRU) ---------------------------------------------

    def read_manifest(self) -> Dict[str, Any]:
        """The CRC-sealed prewarm manifest; a torn or corrupt one reads as
        empty (it is an ordering hint; entries verify themselves)."""
        try:
            with open(self.manifest_path, "rb") as fh:
                data = fh.read()
        except OSError:
            return {"entries": {}}
        try:
            doc = json.loads(data)
            if not isinstance(doc, dict) \
                    or doc.get("schema") != MANIFEST_SCHEMA:
                raise ValueError("foreign schema")
            integrity = doc.pop("integrity")
            canon = json.dumps(doc, sort_keys=True,
                               separators=(",", ":")).encode()
            if zlib.crc32(canon) & 0xFFFFFFFF != integrity["crc32"]:
                raise ValueError("crc mismatch")
        except (ValueError, TypeError, KeyError, AttributeError):
            blackbox.record("aot_manifest_corrupt",
                            path=self.manifest_path)
            return {"entries": {}}
        entries = doc.get("entries")
        return {"entries": entries if isinstance(entries, dict) else {}}

    def touch_manifest(self, key: Tuple, config, n_num: int,
                       n_hash: int) -> None:
        """Bump this key's LRU row, with what rebuilds its runner on
        prewarm: the shape and the key's config fields, resolved now."""
        from tpuprof_torch.config import resolve_profile_passes
        row = {
            "last_used": round(time.time(), 3),
            "n_num": int(n_num),
            "n_hash": int(n_hash),
            "config": {
                "batch_rows": int(config.batch_rows),
                "scan_batches": int(config.scan_batches),
                "mesh_devices": config.mesh_devices,
                "hll_precision": int(config.hll_precision),
                "bins": int(config.bins),
                "pass_b_kernel": config.pass_b,
                "profile_passes": resolve_profile_passes(
                    config.profile_passes),
            },
        }
        with self._manifest_lock:
            doc = self.read_manifest()
            doc["entries"][entry_digest(key, self.fingerprint)] = row
            core = {"schema": MANIFEST_SCHEMA, "entries": doc["entries"]}
            sealed = dict(core)
            sealed["integrity"] = {
                "algorithm": "crc32/canonical-json",
                "crc32": zlib.crc32(json.dumps(
                    core, sort_keys=True,
                    separators=(",", ":")).encode()) & 0xFFFFFFFF,
            }
            _atomic_write(self.manifest_path,
                          json.dumps(sealed, indent=1).encode())

    def entries(self) -> List[str]:
        """Digests of the sealed entries on disk (in-flight dot-prefixed
        temporaries left out)."""
        try:
            names = os.listdir(self.root)
        except OSError:
            return []
        return sorted(n[:-len(".aot")] for n in names
                      if n.endswith(".aot") and not n.startswith("."))


# ---------------------------------------------------------------------------
# the acquire seam (serve/cache.py calls on_runner_miss on every miss)
# ---------------------------------------------------------------------------

def store_from_config(config, devices) -> Optional[AotStore]:
    """The store ``config`` names (``aot_cache_dir``, on unless
    ``aot_cache="off"``), for the key's ``devices``; None without one or
    when its directory cannot be made (the cache off, not down)."""
    from tpuprof_torch.config import resolve_aot_cache, resolve_aot_cache_dir
    if resolve_aot_cache(config.aot_cache) != "on":
        return None
    root = resolve_aot_cache_dir(config.aot_cache_dir)
    if not root:
        return None
    try:
        return AotStore(root, devices)
    except OSError:
        return None


_save_threads: List[threading.Thread] = []
_save_lock = threading.Lock()
_no_save = threading.local()


class no_save:
    """Context manager: no background save on a miss in this thread (the
    prewarmer's mode — prewarm only ever loads)."""

    def __enter__(self):
        _no_save.active = True
        return self

    def __exit__(self, *exc):
        _no_save.active = False


def schedule_save(store: AotStore, key: Tuple, names: Sequence[str]) -> None:
    """Build the key's libraries that are not built yet (nvcc, all at once,
    under the lock ``kernels.library`` builds under) and publish the entry,
    in a background thread.  Non-daemon: a one-shot CLI process finishes
    the publish before it exits, so the next run starts warm."""

    def _run():
        from tpuprof_torch import kernels
        try:
            kernels.build(names)
            store.save(key, library_targets(names))
            _count("saved")
        except Exception as exc:    # noqa: BLE001 — the store is advisory
            logger.warning("aot store: no entry saved for this key: %s",
                           exc)
            blackbox.record("aot_save_failed",
                            error=f"{type(exc).__name__}: {exc}")

    t = threading.Thread(target=_run, name="tpuprof-torch-aot-save")
    with _save_lock:
        _save_threads.append(t)
        del _save_threads[:-32]     # bounded bookkeeping
    t.start()


def wait_pending_saves(timeout: Optional[float] = None) -> None:
    """Block until every scheduled background save finished."""
    with _save_lock:
        threads = list(_save_threads)
    deadline = None if timeout is None else time.monotonic() + timeout
    for t in threads:
        t.join(None if deadline is None
               else max(deadline - time.monotonic(), 0.0))


def on_runner_miss(runner, config, key: Tuple, n_num: int,
                   n_hash: int) -> bool:
    """Called right after a runner is built on a runner-cache miss, before
    its first launch: adopt the key's libraries from the store.  Returns
    True when they were adopted.  Never raises — a rotten entry demotes
    loudly (logged, a flight-recorder record, an ``aot_load`` event with
    ``status="corrupt"``, the entry unlinked) to the nvcc build."""
    store = store_from_config(config, key[2])
    if store is None:
        return False
    names = libraries_for(key)
    targets = library_targets(names)
    loaded = 0
    if names:
        try:
            loaded = store.load_into(key, targets)
        except CorruptAotCacheError as exc:
            path = store.entry_path(key, targets)
            logger.warning("aot store demoted to an nvcc build: %s", exc)
            blackbox.record("aot_load_corrupt", error=str(exc))
            _obs_events.emit("aot_load", path=path, status="corrupt",
                             programs=0, seconds=0.0)
            _count("corrupt")
            try:
                os.unlink(path)
            except OSError:
                pass
        except Exception as exc:    # noqa: BLE001 — the store is advisory
            logger.warning("aot store load failed, building with nvcc: "
                           "%s", exc)
            blackbox.record("aot_load_failed",
                            error=f"{type(exc).__name__}: {exc}")
    try:
        store.touch_manifest(key, config, n_num, n_hash)
    except OSError:
        pass
    if loaded:
        _HITS.inc()
        _count("loaded")
        return True
    _MISSES.inc()
    _count("missed")
    if names and not getattr(_no_save, "active", False):
        schedule_save(store, key, names)
    return False


# ---------------------------------------------------------------------------
# restart prewarm
# ---------------------------------------------------------------------------

def warm(runner, key: Tuple, spearman_grid: int) -> List[str]:
    """Load and bind every library ``key`` needs that is built, and launch
    each once on a one-batch zero input of the runner's shape (CUDA loads
    a module lazily, at its first launch).  Returns the libraries
    launched; none on the CPU."""
    import numpy as np
    import torch

    from tpuprof_torch.config import MAX_SPEAR_GRID
    from tpuprof_torch.runtime.runner import DeviceGroup
    names = libraries_for(key)
    if not names:
        return []
    for r in getattr(runner, "runners", [runner]):
        dev, C = r.device, r.n_num
        g = DeviceGroup(
            torch.zeros((1, C, r.rows), dtype=torch.float32, device=dev),
            torch.zeros((1, r.rows), dtype=torch.bool, device=dev),
            torch.zeros((1, r.n_hash, r.rows), dtype=torch.int16,
                        device=dev), 1)
        zero = r.put_replicated(np.zeros(C))
        r.fold_a(r.init_pass_a(np.zeros(C)), g)
        r.fold_b(r.init_pass_b(), g, zero, zero, zero)
        if "fused_ab" in names:
            r.fold_ab(r.init_pass_a(np.zeros(C)), r.init_pass_b(), g,
                      zero, zero, zero)
        if "rank" in names:
            grid = torch.zeros((C, min(spearman_grid, MAX_SPEAR_GRID)),
                               dtype=torch.float32, device=dev)
            r.fold_spearman(r.init_spearman(), g, (grid,))
        torch.cuda.synchronize(dev)
    return names


class Prewarmer:
    """Background restart prewarm: acquire the manifest's top-K hottest
    runner keys into the process runner cache on ``device`` while the
    daemon already takes jobs.  A key whose libraries the store adopted is
    warmed (:func:`warm`); one the store misses counts as ``missed`` and
    is left for its first job (prewarm never builds).  ``status()``
    reports ``loaded``/``missed``/``pending``/``failed``/``done``."""

    def __init__(self, root: str, top_k: int, device=None):
        self.root = root
        self.top_k = max(int(top_k), 0)
        self.device = device
        self.loaded = 0
        self.missed = 0
        self.failed = 0
        self.pending = 0
        self.seconds = 0.0
        self._done = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "Prewarmer":
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="tpuprof-torch-aot-prewarm")
        self._thread.start()
        return self

    def _run(self) -> None:
        t0 = time.perf_counter()
        try:
            from tpuprof_torch.config import ProfilerConfig
            from tpuprof_torch.serve import cache as _cache
            if self.top_k == 0 or not _cache.cache_enabled():
                return
            devices = [self.device]
            dev_ids = tuple(_cache._device_id(d)
                            for d in _cache._resolved(devices))
            store = AotStore(self.root, dev_ids)
            rows = sorted(store.read_manifest()["entries"].values(),
                          key=lambda r: r.get("last_used") or 0,
                          reverse=True)[: self.top_k]
            self.pending = len(rows)
            for row in rows:
                try:
                    config = ProfilerConfig(aot_cache_dir=self.root,
                                            **(row.get("config") or {}))
                    n_num, n_hash = int(row["n_num"]), int(row["n_hash"])
                    with no_save():
                        runner = _cache.acquire_runner(
                            config, n_num, n_hash, devices=devices)
                    key = _cache.runner_key(config, n_num, n_hash,
                                            devices)
                    targets = library_targets(libraries_for(key))
                    if all(os.path.exists(p) for p in targets.values()):
                        warm(runner, key, config.spearman_grid)
                        self.loaded += 1
                    else:
                        self.missed += 1
                except Exception as exc:    # noqa: BLE001 — advisory
                    blackbox.record(
                        "aot_prewarm_failed",
                        error=f"{type(exc).__name__}: {exc}")
                    self.failed += 1
                finally:
                    self.pending -= 1
        finally:
            self.seconds = time.perf_counter() - t0
            self._done.set()
            _obs_events.emit("aot_prewarm", root=self.root,
                             loaded=self.loaded, failed=self.failed)

    def done(self) -> bool:
        return self._done.is_set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._done.wait(timeout)

    def status(self) -> Dict[str, Any]:
        return {"root": self.root, "top_k": self.top_k,
                "loaded": self.loaded, "missed": self.missed,
                "pending": self.pending, "failed": self.failed,
                "done": self.done(), "seconds": round(self.seconds, 4)}
