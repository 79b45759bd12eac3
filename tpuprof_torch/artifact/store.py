"""Stats artifacts: one profile persisted as one JSON document.

Counterpart of ``tpuprof/artifact/store.py``, the same ``tpuprof-stats-v1``
format, so either package reads the other's stats-only artifacts:

* ``stats`` — :func:`~tpuprof_torch.report.export.stats_to_json`;
* ``sketches`` — per-column histograms (counts, edges), the ranked top-k
  rows and ``bin_seeds``: every numeric lane's exact float32
  ``[lo, hi, mean]`` pass-B bounds, from which the next
  ``profile_passes="fused"`` profile of the source seeds its bin edges
  (``tpuprof_torch/runtime/singlepass.py``);
* ``state`` — ``None``, or for ``write_artifact(profiler=...)`` the
  :class:`~tpuprof_torch.runtime.stream.StreamingProfiler`'s fold state
  (``export_payload``: the device state as a checkpoint's ``.npz``
  archive, the host aggregators and the config, pickled, base64), its own
  CRC32 and length, and the writing package, ``"tpuprof_torch"``;
  :meth:`Artifact.state_payload` decodes it and
  ``artifact.incremental.resume_profiler`` folds on from it;
* ``integrity`` — a CRC32 over the document's canonical serialization.

Writes are atomic (a dot-prefixed temporary file, fsync, rename).  Every
read failure — truncation, a flipped byte, junk, a foreign or missing
schema id, a torn payload — raises
:class:`~tpuprof_torch.errors.CorruptArtifactError`; a missing file raises
``FileNotFoundError``.  A fold state the reference wrote (it names no
package, and its pickle names ``tpuprof`` classes) is refused with
``CorruptArtifactError`` before it is unpickled.
"""

from __future__ import annotations

import base64
import binascii
import dataclasses
import json
import os
import time
import zlib
from typing import Any, Dict, Optional

from tpuprof_torch.errors import CorruptArtifactError
from tpuprof_torch.report.export import SCHEMA_ID, json_scalar, stats_to_json
from tpuprof_torch.testing import faults

# the package an embedded fold state names
PACKAGE = "tpuprof_torch"

# ranked top-k rows per CAT column in the sketches section
TOPK_SKETCH_ROWS = 50

# the canonical serialization the CRC covers: key-sorted, no whitespace
_CANON = {"sort_keys": True, "separators": (",", ":")}

@dataclasses.dataclass
class Artifact:
    """One artifact, read back and integrity-checked."""

    schema: str
    meta: Dict[str, Any]
    stats: Dict[str, Any]
    sketches: Dict[str, Any]
    state_bytes: Optional[bytes] = None
    path: Optional[str] = None
    crc32: Optional[int] = None     # the verified document CRC
    state_package: Optional[str] = None     # who wrote the fold state

    @property
    def foldable(self) -> bool:
        return self.state_bytes is not None

    @property
    def rows(self) -> int:
        return int(self.meta.get("rows") or 0)

    @property
    def columns(self) -> Dict[str, str]:
        """Column name -> refined kind, in profile order."""
        return dict(self.meta.get("columns") or {})

    def state_payload(self) -> Dict[str, Any]:
        """The fold-state payload (checkpoint-shaped: ``arrays_npz``,
        ``host_blob``, ``config``, ``cursor``, ``meta``).  Raises
        :class:`CorruptArtifactError` for a stats-only artifact, for a
        fold state another package wrote (before unpickling it) and for
        one that does not decode."""
        from tpuprof_torch.runtime.checkpoint import safe_loads
        if self.state_bytes is None:
            raise CorruptArtifactError(
                f"artifact {self.path!r} carries no fold state — written "
                "by a one-shot profile (stats-only); incremental resume "
                "needs an artifact written from a StreamingProfiler")
        if self.state_package != PACKAGE:
            raise CorruptArtifactError(
                f"artifact {self.path!r} fold state was written by "
                f"{self.state_package or 'another package'}, not "
                f"{PACKAGE}; it is not unpickled (it names that package's "
                "classes)")
        try:
            payload = safe_loads(self.state_bytes)
        except Exception as exc:
            raise CorruptArtifactError(
                f"artifact {self.path!r} fold-state payload does not "
                f"decode ({type(exc).__name__}: {exc})") from exc
        if not isinstance(payload, dict) or "host_blob" not in payload:
            raise CorruptArtifactError(
                f"artifact {self.path!r} fold-state payload decodes to "
                "an unexpected layout")
        return payload


def _config_meta(config) -> Dict[str, Any]:
    """The config knobs two artifacts must agree on to be comparable."""
    if config is None:
        return {}
    keys = ("bins", "hll_precision", "topk_capacity",
            "quantile_sketch_size", "seed", "batch_rows", "nested",
            "exact_distinct", "top_freq")
    out = {k: getattr(config, k, None) for k in keys}
    out["fingerprint"] = config.fingerprint()
    return out


def build_sketches(stats: Dict[str, Any]) -> Dict[str, Any]:
    """The JSON-readable drift inputs the export leaves out: per-column
    histograms, ranked top-k rows, and the pass-B bound seeds (the stats
    dict's private ``_bin_seeds``)."""
    hists: Dict[str, Any] = {}
    for name, var in stats["variables"].items():
        h = var.get("histogram")
        if h is None:
            continue
        counts, edges = h
        hists[str(name)] = {"counts": [int(c) for c in counts],
                            "edges": [float(e) for e in edges]}
    topk: Dict[str, Any] = {}
    for col, vc in (stats.get("freq") or {}).items():
        topk[str(col)] = [
            {"value": json_scalar(idx), "count": int(cnt)}
            for idx, cnt in list(vc.items())[:TOPK_SKETCH_ROWS]]
    out = {"histograms": hists, "topk": topk}
    seeds = stats.get("_bin_seeds")
    if seeds:
        out["bin_seeds"] = {str(k): [float(x) for x in v]
                            for k, v in seeds.items()}
    return out


def _encode_state(payload: Dict[str, Any]) -> Dict[str, Any]:
    """A profiler's ``export_payload`` as the document's ``state`` entry:
    the device state as one ``.npz`` archive, as a checkpoint holds it, so
    a resume takes the checkpoint's restore path."""
    import pickle

    from tpuprof_torch.runtime.checkpoint import encode_state
    wire = {
        "arrays_npz": encode_state(payload.get("state")),
        "host_blob": payload["host_blob"],
        # resume_profiler rebuilds the writer's geometry from it
        "config": payload.get("config"),
        "cursor": int(payload["cursor"]),
        "meta": payload["meta"],
    }
    raw = pickle.dumps(wire, protocol=pickle.HIGHEST_PROTOCOL)
    return {
        "encoding": "npz+pickle/base64",
        "package": PACKAGE,
        "crc32": zlib.crc32(raw) & 0xFFFFFFFF,
        "length": len(raw),
        "payload": base64.b64encode(raw).decode("ascii"),
    }


def write_artifact(path: str, stats: Optional[Dict[str, Any]] = None,
                   config=None, profiler=None,
                   source: Optional[str] = None) -> Dict[str, Any]:
    """Write one ``tpuprof-stats-v1`` artifact at ``path``, atomically:

    * ``write_artifact(path, profiler=prof)`` — a snapshot of a
      :class:`~tpuprof_torch.runtime.stream.StreamingProfiler` (its buffer
      folds first) with its fold state embedded: ``resume_profiler`` folds
      on from it;
    * ``write_artifact(path, stats=stats, config=cfg)`` — a stats dict
      already computed: stats-only, what ``diff`` compares.

    Returns a copy of the document's ``meta`` with its ``crc32``."""
    if (profiler is None) == (stats is None):
        raise ValueError("pass exactly one of profiler= or stats=")
    state_entry = None
    if profiler is not None:
        config = profiler.config
        state_entry = _encode_state(profiler.export_payload())
        stats = profiler.stats()
    meta = {
        "format": SCHEMA_ID,
        "tpuprof_version": _version(),
        "created_unix": round(time.time(), 3),
        "rows": int(stats["table"]["n"]),
        "columns": {str(name): var["type"]
                    for name, var in stats["variables"].items()},
        "config": _config_meta(config),
        "foldable": state_entry is not None,
        "degraded": bool(stats.get("_quarantine")),
        "source": source,
    }
    core = {
        "schema": SCHEMA_ID,
        "meta": meta,
        "stats": stats_to_json(stats),
        "sketches": build_sketches(stats),
        "state": state_entry,
    }
    doc = dict(core)
    doc["integrity"] = {
        "algorithm": "crc32/canonical-json",
        "crc32": zlib.crc32(json.dumps(core, **_CANON).encode()) & 0xFFFFFFFF,
    }
    data = json.dumps(doc, indent=1).encode()
    # dot-prefixed, so a directory scan never sees the write in flight
    tmp = os.path.join(os.path.dirname(path) or ".",
                       f".{os.path.basename(path)}.tmp")
    try:
        with open(tmp, "wb") as fh:
            faults.hit("artifact_write", key=meta["rows"])
            fh.write(faults.mangle("artifact_write", data))
            fh.flush()
            os.fsync(fh.fileno())       # data on disk before the rename
    except BaseException:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise
    os.replace(tmp, path)
    out = dict(meta)
    out["crc32"] = doc["integrity"]["crc32"]
    return out


def read_artifact(path: str) -> Artifact:
    """Read and integrity-check one artifact (``CorruptArtifactError`` on
    any failure but a missing file, which raises ``FileNotFoundError``)."""
    try:
        with open(path, "rb") as fh:
            data = fh.read()
    except FileNotFoundError:
        raise
    except OSError as exc:
        raise CorruptArtifactError(
            f"artifact {path!r} is unreadable "
            f"({type(exc).__name__}: {exc})") from exc
    try:
        doc = json.loads(data)
    except Exception as exc:
        raise CorruptArtifactError(
            f"artifact {path!r} is not valid JSON — truncated or corrupt "
            f"({type(exc).__name__}: {exc})") from exc
    if not isinstance(doc, dict):
        raise CorruptArtifactError(
            f"artifact {path!r} decodes to {type(doc).__name__}, not an "
            "artifact document")
    if doc.get("schema") != SCHEMA_ID:
        raise CorruptArtifactError(
            f"artifact {path!r} has schema {doc.get('schema')!r}; this "
            f"build reads {SCHEMA_ID!r}")
    integrity = doc.pop("integrity", None)
    if not isinstance(integrity, dict) or "crc32" not in integrity:
        raise CorruptArtifactError(
            f"artifact {path!r} lacks its integrity envelope — torn or "
            "hand-edited")
    canon = json.dumps(doc, **_CANON).encode()
    if zlib.crc32(canon) & 0xFFFFFFFF != integrity["crc32"]:
        raise CorruptArtifactError(
            f"artifact {path!r} CRC mismatch — corrupt artifact")
    state_bytes = None
    state_package = None
    state = doc.get("state")
    if state is not None:
        try:
            state_bytes = base64.b64decode(
                state["payload"].encode("ascii"), validate=True)
        except (KeyError, TypeError, AttributeError,
                binascii.Error) as exc:
            raise CorruptArtifactError(
                f"artifact {path!r} fold-state payload does not decode "
                f"({type(exc).__name__}: {exc})") from exc
        if len(state_bytes) != state.get("length") or \
                zlib.crc32(state_bytes) & 0xFFFFFFFF != state.get("crc32"):
            raise CorruptArtifactError(
                f"artifact {path!r} fold-state payload fails its CRC — "
                "torn write")
        state_package = state.get("package")
    return Artifact(schema=doc["schema"], meta=doc.get("meta") or {},
                    stats=doc.get("stats") or {},
                    sketches=doc.get("sketches") or {},
                    state_bytes=state_bytes, path=path,
                    crc32=int(integrity["crc32"]),
                    state_package=state_package)


def _version() -> str:
    from tpuprof_torch import __version__
    return __version__
