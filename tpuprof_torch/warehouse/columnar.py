"""Columnar stats files — ``tpuprof-stats-parquet-v1``.

Counterpart of ``tpuprof/warehouse/columnar.py``, with its Parquet schema,
its ``tpuprof.``-prefixed footer metadata and its integrity checks, so a
file either package wrote reads in the other.  The one difference is the
version stamp: ``tpuprof_version`` in the metadata is this package's
``__version__``.

The JSON artifact (artifact/store.py) is ONE document: reading the mean of
one column out of a 10k-column profile costs parsing the whole thing.  The
warehouse twin stores the same ``variables`` numbers as a Parquet table —
one row per profiled column, one typed Parquet column per stat — so a
``["column", "mean"]`` read touches two column chunks, not the document.

Layout of one file:

* rows: the profile's columns, in profile order, keyed by the ``column``
  string column; ``type`` carries the refined kind.
* stat columns: every numeric stat the export produced, as int64 when every
  present value is an integer, else float64 — the VALUES are the raw
  ``variables`` numbers bit for bit.
* ``hist_counts`` (list<int64>) / ``hist_edges`` (list<float64>): the
  per-column histogram sketch, so PSI/KS trend extraction
  (warehouse/history.py) never needs the JSON chain.
* file metadata: schema id, source, generation, created/rows/config
  provenance, and the CRC32 of the JSON artifact this file was derived
  from (``artifact_crc32``).

Durability is the artifact store's contract: the Parquet bytes are built in
memory and published through ONE atomic tmp+fsync+rename seam with a
dot-prefixed temp name (the warehouse directory is chain-scanned).  Every
read failure — truncation at any byte offset, a bit flip in the footer,
junk, a foreign schema — is the typed
:class:`~tpuprof_torch.errors.CorruptWarehouseError`, never a raw pyarrow
traceback.  pyarrow itself is imported lazily: an environment without it
raises the typed :class:`~tpuprof_torch.errors.WarehouseUnavailableError`
(CLI exit code 10) and the JSON artifact path is unaffected.
"""

from __future__ import annotations

import dataclasses
import io
import json
import os
import time
from typing import Any, Dict, List, Optional, Sequence

from tpuprof_torch.errors import (CorruptWarehouseError,
                            WarehouseUnavailableError)
from tpuprof_torch.obs import metrics as _obs_metrics
from tpuprof_torch.testing import faults as _faults

STATS_PARQUET_SCHEMA = "tpuprof-stats-parquet-v1"

#: metadata keys (all UTF-8 strings in the Parquet file footer)
_META_PREFIX = "tpuprof."

_WRITES = _obs_metrics.counter(
    "tpuprof_warehouse_writes_total", "columnar stats files written")
_READS = _obs_metrics.counter(
    "tpuprof_warehouse_reads_total",
    "columnar stats files read back (full or column-pruned)")
_CORRUPT = _obs_metrics.counter(
    "tpuprof_warehouse_corrupt_total",
    "columnar reads rejected by the integrity checks")
_WRITE_SECONDS = _obs_metrics.histogram(
    "tpuprof_warehouse_write_seconds",
    "wall seconds per atomic columnar write (encode + fsync + rename)")
_BYTES = _obs_metrics.gauge(
    "tpuprof_warehouse_bytes", "size of the newest columnar file written")


def import_pyarrow():
    """The lazy pyarrow gate: every warehouse
    entry point draws pyarrow through here, so a box without it gets
    ONE typed, actionable error instead of an ImportError traceback —
    and the JSON artifact path, which never calls this, is unaffected."""
    try:
        import pyarrow
        import pyarrow.parquet  # noqa: F401 — the submodule the IO uses
    except Exception as exc:
        raise WarehouseUnavailableError(
            "the columnar profile warehouse needs pyarrow, which this "
            f"environment cannot import ({type(exc).__name__}: {exc}) "
            "— install pyarrow>=16 or set warehouse_format=off "
            "(TPUPROF_WAREHOUSE_FORMAT=off); JSON artifacts are "
            "unaffected") from exc
    return pyarrow


@dataclasses.dataclass
class Generation:
    """One columnar stats file read back: provenance metadata plus the
    requested columns as plain Python dicts."""

    schema: str
    meta: Dict[str, Any]
    columns: List[str]              # profiled column names, file order
    stats: Dict[str, Dict[str, Any]]  # column -> {stat: raw value}
    path: Optional[str] = None

    @property
    def generation(self) -> int:
        return int(self.meta.get("generation") or 0)

    @property
    def created_unix(self) -> float:
        return float(self.meta.get("created_unix") or 0.0)


def _is_int(v: Any) -> bool:
    return isinstance(v, int) and not isinstance(v, bool)


def _is_num(v: Any) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def stat_columns(variables: Dict[str, Dict[str, Any]]) -> List[str]:
    """The union of numeric stat keys across every column, in first-
    appearance order — the file's stat column set.  Non-numeric stats
    (mode strings, the histogram tuple, nested display blobs) stay out;
    the histogram rides the dedicated ``hist_*`` list columns."""
    out: List[str] = []
    seen = set()
    for var in variables.values():
        for key, val in var.items():
            if key in seen or key.startswith("_"):
                continue
            if _is_num(val) or val is None:
                # a key that is None everywhere is undecidable; admit
                # it only once some column gives it a number
                if val is None and not any(
                        _is_num(v.get(key)) for v in variables.values()):
                    continue
                seen.add(key)
                out.append(key)
    return out


def write_stats_parquet(path: str, stats_json: Dict[str, Any],
                        sketches: Optional[Dict[str, Any]] = None, *,
                        source: Optional[str] = None,
                        generation: int = 0,
                        rows: Optional[int] = None,
                        config_fingerprint: Optional[str] = None,
                        artifact_crc32: Optional[int] = None,
                        created_unix: Optional[float] = None) -> Dict[str, Any]:
    """Write one ``tpuprof-stats-parquet-v1`` file atomically.

    ``stats_json`` is the artifact's ``stats`` section (the
    ``stats_to_json`` export — raw JSON numbers); ``sketches`` the
    artifact's ``sketches`` section (histograms feed the ``hist_*``
    columns).  Returns the metadata dict stamped into the file."""
    pa = import_pyarrow()
    import pyarrow.parquet as pq

    t0 = time.perf_counter()
    variables: Dict[str, Dict[str, Any]] = stats_json.get("variables") or {}
    names = [str(n) for n in variables]
    stats_keys = stat_columns(variables)
    hists = (sketches or {}).get("histograms") or {}

    arrays: Dict[str, Any] = {
        "column": pa.array(names, type=pa.string()),
        "type": pa.array([variables[n].get("type") for n in names],
                         type=pa.string()),
    }
    for key in stats_keys:
        vals = [variables[n].get(key) for n in names]
        vals = [v if _is_num(v) else None for v in vals]
        # int64 only when every present value is an int — a mixed
        # int/float stat must not silently truncate, and float64 holds
        # every json float bit-for-bit
        typ = pa.int64() if all(v is None or _is_int(v) for v in vals) \
            else pa.float64()
        arrays[key] = pa.array(
            [v if v is None or typ == pa.int64() else float(v)
             for v in vals], type=typ)
    arrays["hist_counts"] = pa.array(
        [[int(c) for c in (hists.get(n) or {}).get("counts") or []] or None
         for n in names], type=pa.list_(pa.int64()))
    arrays["hist_edges"] = pa.array(
        [[float(e) for e in (hists.get(n) or {}).get("edges") or []] or None
         for n in names], type=pa.list_(pa.float64()))

    meta = {
        "schema": STATS_PARQUET_SCHEMA,
        "tpuprof_version": _version(),
        "source": source,
        "generation": int(generation),
        "created_unix": round(created_unix if created_unix is not None
                              else time.time(), 3),
        "rows": int(rows) if rows is not None else None,
        "config_fingerprint": config_fingerprint,
        "artifact_crc32": artifact_crc32,
        "stat_columns": stats_keys,
    }
    table = pa.table(arrays, metadata={
        (_META_PREFIX + k).encode(): json.dumps(v).encode()
        for k, v in meta.items()})
    buf = io.BytesIO()
    pq.write_table(table, buf)
    data = _faults.mangle("warehouse_write", buf.getvalue())
    _faults.hit("warehouse_write", key=int(generation))
    _atomic_write(path, data)
    if _obs_metrics.enabled():
        _WRITES.inc()
        _WRITE_SECONDS.observe(time.perf_counter() - t0)
        _BYTES.set(len(data))
        from tpuprof_torch.obs import events
        events.emit("warehouse_write", path=path, source=source,
                    generation=int(generation), columns=len(names),
                    bytes=len(data),
                    seconds=round(time.perf_counter() - t0, 4))
    return meta


def _atomic_write(path: str, data: bytes) -> None:
    # dot-prefixed temp: the warehouse
    # directory is chain-scanned (store.py GEN_RE walk), so the
    # in-flight write must be invisible to every name filter
    tmp = os.path.join(os.path.dirname(path) or ".",
                       f".{os.path.basename(path)}.tmp.{os.getpid()}")
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


def read_stats_parquet(path: str,
                       columns: Optional[Sequence[str]] = None,
                       stats: Optional[Sequence[str]] = None
                       ) -> Generation:
    """Read one columnar stats file, optionally column-pruned.

    ``columns`` filters the profiled-column ROWS; ``stats`` prunes
    which stat columns are materialized (the 10k-column win: a
    ``stats=["mean"]`` read touches the ``column`` and ``mean`` chunks
    only).  A genuinely missing file raises ``FileNotFoundError``
    ("never written" and "rotted" are different operator problems);
    EVERY other failure is the typed :class:`CorruptWarehouseError`."""
    import_pyarrow()
    import pyarrow.parquet as pq

    if not os.path.exists(path):
        raise FileNotFoundError(path)
    try:
        pf = pq.ParquetFile(path)
        raw_meta = pf.schema_arrow.metadata or {}
        meta = _decode_meta(path, raw_meta)
        read_cols = None
        if stats is not None:
            available = set(pf.schema_arrow.names)
            read_cols = ["column"] + [
                s for s in stats if s in available and s != "column"]
        table = pf.read(columns=read_cols)
    except (FileNotFoundError, CorruptWarehouseError):
        raise
    except Exception as exc:
        # pyarrow raises a zoo (ArrowInvalid, ArrowIOError, OSError,
        # ValueError) depending on WHERE the bytes are torn — one typed
        # shape for all of it, like every other store in the tree
        _mark_corrupt()
        raise CorruptWarehouseError(
            f"columnar stats file {path!r} is unreadable — truncated "
            f"or corrupt ({type(exc).__name__}: {exc})") from exc
    data = table.to_pydict()
    names = [str(n) for n in data.get("column") or []]
    keep = None if columns is None else {str(c) for c in columns}
    per_col: Dict[str, Dict[str, Any]] = {}
    for i, name in enumerate(names):
        if keep is not None and name not in keep:
            continue
        per_col[name] = {k: v[i] for k, v in data.items()
                        if k != "column"}
    if _obs_metrics.enabled():
        _READS.inc()
    return Generation(schema=STATS_PARQUET_SCHEMA, meta=meta,
                      columns=[n for n in names
                               if keep is None or n in keep],
                      stats=per_col, path=path)


def _decode_meta(path: str, raw: Dict[bytes, bytes]) -> Dict[str, Any]:
    meta: Dict[str, Any] = {}
    for k, v in raw.items():
        key = k.decode("utf-8", "replace")
        if not key.startswith(_META_PREFIX):
            continue
        try:
            meta[key[len(_META_PREFIX):]] = json.loads(v.decode())
        except ValueError:
            meta[key[len(_META_PREFIX):]] = v.decode("utf-8", "replace")
    if meta.get("schema") != STATS_PARQUET_SCHEMA:
        _mark_corrupt()
        raise CorruptWarehouseError(
            f"columnar stats file {path!r} has schema "
            f"{meta.get('schema')!r}; this build reads "
            f"{STATS_PARQUET_SCHEMA!r}")
    return meta


def _mark_corrupt() -> None:
    _CORRUPT.inc()
    from tpuprof_torch.obs import blackbox
    blackbox.record("warehouse_corrupt")


def _version() -> str:
    # the port's own version, as its JSON artifacts stamp it
    from tpuprof_torch import __version__
    return __version__
