"""Arrow -> device-batch preparation, the host side of the scan.

Counterpart of ``tpuprof/ingest/arrow.py`` for a pandas DataFrame, a
pyarrow Table, a ``pyarrow.dataset.Dataset`` or the path of a Parquet file
or directory.  Per record batch it produces fixed-shape numpy planes the
device step consumes:

* ``x``         (G, n_num) float32, Fortran order (so ``x.T`` is a
  C-contiguous (cols, rows) view) — numeric and boolean lanes, NaN missing;
* ``row_valid`` (G,) bool — masks the padding rows;
* ``hll``       (G, n_hash) uint16 — packed HLL observations for every
  column with a hash lane (``kernels.hll.pack``), 0 = null or padding;
  a lane hashed on the device (``device_lanes``) stays 0 here;

plus the host-only side channels: dictionary codes of categorical columns
(Misra-Gries, recount), the row-hash aggregation of high-cardinality plain
strings, int64-nanosecond dates, Arrow buffer sizes, the null counts of
opaque nested columns and, with ``full_hashes`` (``config.exact_distinct``),
the unpacked 64-bit hashes of numeric and date columns.  The hashing is the
reference's, bit for bit (native C++ when it builds, pandas otherwise), so
distinct counts and top-k keys agree with it.  A caller may name float32
lanes whose hashing moves to the device (``device_lanes``: the GPU backend
on a CUDA runner without ``exact_distinct``, when the native library
builds; :func:`float32_hash_lanes`): their key is a pure function of the
value the ``x`` plane carries, so ``fused.hll_regs`` hashes it there with
the same splitmix64 and pack, and the registers stay the reference's bit
for bit.  Every other lane, and every other caller, hashes here.

Nested (list, struct, map) columns follow ``config.nested``: "stringify"
profiles the ``str()`` of each value as a categorical column (a Python
loop a row, warned once a column); "opaque" records count, missing and
memory only, from Arrow metadata, with no hash lane.

Parallelism has two tiers, both byte-deterministic.  Within a batch, one
task a column, plus row-chunk tasks for numeric columns when columns alone
cannot fill the pool, run on the shared column pool (``ingest/prep.py``;
by default only while one batch is prepared at a time:
``config.resolve_prep_workers``); tasks write disjoint slices of
preallocated planes.  Across batches,
:func:`prefetch_prepared` keeps up to ``workers`` prepares in flight and
delivers them in stream order; every order-sensitive fold (sampler,
Misra-Gries, HLL registers) happens in the consumer.  Each leaf task
times its decode and its hashing apart; a prepare adds their sums to the
profile's phase totals as thread-seconds (``decode_a`` and ``hash_a``
with hashes, ``decode_b`` without: ``obs/spans.add``), never as ranges
of a trace.  Each prepare runs
under the ingest guard (``runtime/guard.py``): transient errors retry, and
a batch that keeps failing arrives as a ``PoisonBatch`` when quarantine is
on.  A dataset streams through its scanner; after the scanner's first
``OSError`` it drops to per-fragment reads with retry, skipping what was
already delivered.  Fragment striping across processes comes with the
multi-GPU slice.
"""

from __future__ import annotations

import dataclasses
import logging
import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.compute as pc
import pyarrow.dataset as pads

from tpuprof_torch import native, schema
from tpuprof_torch.config import NESTED_POLICIES, resolve_prep_workers
from tpuprof_torch.errors import InputError
from tpuprof_torch.ingest import prep
from tpuprof_torch.kernels import hll as khll
from tpuprof_torch.obs import metrics as _obs_metrics
from tpuprof_torch.obs import spans as _spans

logger = logging.getLogger("tpuprof_torch")

# ---- ingest telemetry (OBSERVABILITY.md; off = one branch a batch) ------
_ROWS_INGESTED = _obs_metrics.counter(
    "tpuprof_ingest_rows_total", "rows decoded into HostBatch planes")
_BYTES_INGESTED = _obs_metrics.counter(
    "tpuprof_ingest_bytes_total",
    "Arrow buffer bytes decoded (indices + dictionaries)")
_BATCHES_INGESTED = _obs_metrics.counter(
    "tpuprof_ingest_batches_total", "record batches prepared")
_NUM_PATHS = _obs_metrics.counter(
    "tpuprof_prep_numeric_path_total",
    "numeric column-chunk decodes by path: zero_copy (no-null f64/int "
    "view) vs slow (cast/fill_null chain)")
_PREP_SECONDS = _obs_metrics.histogram(
    "tpuprof_prep_batch_seconds", "wall seconds per prepare_batch call")
_QUEUE_DEPTH = _obs_metrics.gauge(
    "tpuprof_prep_queue_depth",
    "prepared batches (futures) buffered ahead of the consumer in "
    "prefetch_prepared")

# plain-string columns leave the per-batch dictionary_encode for the native
# row hash + factorize once their previous batch showed more distinct
# values than this (the reference's threshold: the row-hash path wins
# clearly only at ID-like cardinality)
ROWHASH_MIN_DISTINCT = 16384

# numeric columns split into row-chunk tasks once a batch is tall enough
# that the split's task overhead is noise
ROW_CHUNK_ROWS = 16384

# nested columns warned once per column name per process (set.add is
# GIL-atomic)
_NESTED_WARNED: set = set()


@dataclasses.dataclass
class ColumnSpec:
    name: str
    role: str                 # "num" | "date" | "cat"
    base_kind: str            # schema.{NUM,BOOL,DATE,CAT} before refinement
    num_lane: int = -1        # lane in the x plane ("num" role only)
    hash_lane: int = -1       # lane in the hll plane (-1: opaque)
    arrow_type: Optional[pa.DataType] = None
    opaque: bool = False      # nested column under nested="opaque": count,
                              # missing and memory only, never decoded


@dataclasses.dataclass
class ColumnPlan:
    specs: List[ColumnSpec]

    @property
    def n_num(self) -> int:
        return sum(1 for s in self.specs if s.role == "num")

    @property
    def n_hash(self) -> int:
        return sum(1 for s in self.specs if s.hash_lane >= 0)

    def by_role(self, role: str) -> List[ColumnSpec]:
        return [s for s in self.specs if s.role == role]

    @classmethod
    def from_schema(cls, arrow_schema: pa.Schema,
                    nested: str = "stringify") -> "ColumnPlan":
        if nested not in NESTED_POLICIES:
            raise ValueError(f"nested={nested!r} — use one of "
                             f"{NESTED_POLICIES}")
        specs: List[ColumnSpec] = []
        num_lane = hash_lane = 0
        for field in arrow_schema:
            t = field.type
            inner = t.value_type if isinstance(t, pa.DictionaryType) else t
            if nested == "opaque" and pa.types.is_nested(inner):
                # no hash lane: nothing of the column ships to the device
                specs.append(ColumnSpec(field.name, "cat", schema.CAT,
                                        arrow_type=t, opaque=True))
                continue
            if pa.types.is_boolean(inner):
                spec = ColumnSpec(field.name, "num", schema.BOOL,
                                  num_lane=num_lane, arrow_type=t)
                num_lane += 1
            elif (pa.types.is_integer(inner) or pa.types.is_floating(inner)
                  or pa.types.is_decimal(inner)):
                spec = ColumnSpec(field.name, "num", schema.NUM,
                                  num_lane=num_lane, arrow_type=t)
                num_lane += 1
            elif (pa.types.is_timestamp(inner) or pa.types.is_date(inner)
                  or pa.types.is_time(inner)):
                spec = ColumnSpec(field.name, "date", schema.DATE,
                                  arrow_type=t)
            else:
                spec = ColumnSpec(field.name, "cat", schema.CAT, arrow_type=t)
            spec.hash_lane = hash_lane
            hash_lane += 1
            specs.append(spec)
        return cls(specs)


@dataclasses.dataclass
class HostBatch:
    """One device-ready batch plus host-side raw views."""

    nrows: int
    x: np.ndarray             # (G, n_num) float32, F-order, NaN missing
    row_valid: np.ndarray     # (G,) bool
    hll: np.ndarray           # (G, n_hash) uint16 packed observations
    cat_codes: Dict[str, Tuple[np.ndarray, np.ndarray]]  # (codes, values)
    date_ints: Dict[str, Tuple[np.ndarray, np.ndarray]]  # (int64 ns, valid)
    # uint64 hashes of each categorical column's dictionary values and the
    # implementation that made them ("native" | "pandas"); None when the
    # batch was prepared without hashes (pass B)
    cat_hashes: Optional[Dict[str, np.ndarray]] = None
    cat_hash_kind: Optional[Dict[str, str]] = None
    # the plain-string row-hash path (pass A, native library): per-batch
    # (unique hashes u64, counts i64, a first row of each unique, row
    # hashes u64, valid bool or None = no nulls, the Arrow array); values
    # materialize only for what the consumer keeps.  A column prepared
    # this way has no cat_codes entry in the batch
    cat_hashed: Optional[Dict[str, Tuple]] = None
    # the full 64-bit hashes of each numeric and date column's valid rows
    # (owned arrays), only when prepared with full_hashes
    # (config.exact_distinct): the HLL plane keeps 16 packed bits, exact
    # counting needs the whole hash
    num_hashes: Optional[Dict[str, np.ndarray]] = None
    # null counts of opaque nested columns: their only statistic
    opaque_nulls: Optional[Dict[str, int]] = None
    hll_precision: int = 11
    col_nbytes: Optional[Dict[str, int]] = None       # Arrow buffer bytes
    col_dict_nbytes: Optional[Dict[str, int]] = None  # shared dictionaries
    # (fragment, batch) of a positioned stream: a checkpoint records the
    # last folded one, so a resume skips whole fragments' reads
    frag_pos: Optional[Tuple[int, int]] = None


def _hash64(keys: np.ndarray) -> np.ndarray:
    """64-bit hashes of canonical uint64 keys (native when available)."""
    keys = np.ascontiguousarray(keys, dtype=np.uint64)
    h = native.hash_u64_array(keys)
    if h is not None:
        return h
    return pd.util.hash_array(keys).astype(np.uint64)


def _num_keys(values: np.ndarray) -> np.ndarray:
    """Canonical uint64 hash keys of numeric values: the bit pattern,
    widened, with -0.0 folded into +0.0."""
    if values.dtype == np.float32:
        bits = np.where(values == 0.0, np.float32(0.0), values
                        ).view(np.uint32)
        return bits.astype(np.uint64)
    if values.dtype == np.float64:
        return np.where(values == 0.0, 0.0, values).view(np.uint64)
    return values.astype(np.int64, copy=False).view(np.uint64)


def _packed_obs(keys: np.ndarray, valid: np.ndarray,
                precision: int) -> np.ndarray:
    """Packed HLL observations from canonical keys: one fused native pass
    when available, else hash then numpy pack (bit-identical)."""
    keys = np.ascontiguousarray(keys, dtype=np.uint64)
    packed = native.hash_pack_u64(keys, valid, precision)
    if packed is not None:
        return packed
    return khll.pack(_hash64(keys), valid, precision)


def float32_hash_lanes(plan: ColumnPlan) -> List[ColumnSpec]:
    """The numeric columns whose Arrow type is float32 (not dictionary
    encoded): the lanes whose HLL observations the device can make from
    the ``x`` plane alone, since that plane carries their values' bits
    exactly."""
    return [s for s in plan.by_role("num")
            if s.arrow_type is not None and pa.types.is_float32(s.arrow_type)]


def _fill_num_rows(arr: pa.Array, spec: ColumnSpec, x: np.ndarray,
                   hll_packed: np.ndarray, hashes: bool,
                   hll_precision: int, lo: int,
                   nh: Optional[Tuple[np.ndarray, np.ndarray]] = None
                   ) -> Tuple[float, float]:
    """Decode one numeric or boolean Arrow slice into plane rows
    [lo, lo + len(arr)) and, with ``hashes``, its packed HLL lane; with
    ``nh`` (a column's preallocated (hashes, valid) pair) also the rows'
    full 64-bit hashes and validity, the very hashes the lane packs.  Every
    operation is elementwise, so any row partition of a column gives
    byte-identical planes.  Nulls are NaN.  Returns the seconds of the
    decode and of the hashing."""
    t0 = time.perf_counter()
    hi = lo + len(arr)
    t = arr.type
    lane = spec.num_lane
    if pa.types.is_floating(t) and t.bit_width == 32:
        vals = arr.to_numpy(zero_copy_only=False)    # f32, NaN = null
        x[lo:hi, lane] = vals
        valid = ~np.isnan(vals)
        _NUM_PATHS.inc(path="zero_copy" if arr.null_count == 0
                       else "slow")
    elif pa.types.is_floating(t) and t.bit_width == 64 \
            and arr.null_count == 0:
        vals = arr.to_numpy()                        # a zero-copy view
        x[lo:hi, lane] = vals
        valid = ~np.isnan(vals)
        _NUM_PATHS.inc(path="zero_copy")
    elif pa.types.is_floating(t) or pa.types.is_decimal(t):
        vals = arr.cast(pa.float64(), safe=False).to_numpy(
            zero_copy_only=False)
        x[lo:hi, lane] = vals.astype(np.float32)
        valid = ~np.isnan(vals)
        _NUM_PATHS.inc(path="slow")
    elif arr.null_count == 0 and not pa.types.is_boolean(t):
        # ints stay int64 so ids above 2^53 hash exactly
        vals = arr.to_numpy().astype(np.int64, copy=False)
        x[lo:hi, lane] = vals.astype(np.float32)
        valid = np.ones(len(arr), dtype=bool)
        _NUM_PATHS.inc(path="zero_copy")
    else:                           # bools, and ints carrying nulls
        valid = (arr.is_valid().to_numpy(zero_copy_only=False)
                 if arr.null_count else np.ones(len(arr), dtype=bool))
        vals = arr.cast(pa.int64(), safe=False).fill_null(0) \
            .to_numpy(zero_copy_only=False)
        xf = vals.astype(np.float32)
        if arr.null_count:
            xf = np.where(valid, xf, np.nan)
        x[lo:hi, lane] = xf
        _NUM_PATHS.inc(path="slow")
    t1 = time.perf_counter()
    if not hashes:
        return t1 - t0, 0.0
    keys = _num_keys(vals)
    if nh is None:
        hll_packed[lo:hi, spec.hash_lane] = _packed_obs(keys, valid,
                                                        hll_precision)
    else:
        # one native pass writes the full hashes into the pair's slice and
        # returns the packed observations
        packed = native.hash_pack_keep_u64(keys, valid, hll_precision,
                                           nh[0][lo:hi])
        if packed is None:
            packed = _packed_obs(keys, valid, hll_precision)
            nh[0][lo:hi] = _hash64(keys)
        hll_packed[lo:hi, spec.hash_lane] = packed
        nh[1][lo:hi] = valid
    return t1 - t0, time.perf_counter() - t1


def _stringified(name: str, arr: pa.Array) -> pa.Array:
    """A nested column's values as the ``str()`` of each (None stays
    null): no Arrow kernel encodes or casts list, struct and map values,
    so this is a Python loop a row, warned once a column."""
    if name not in _NESTED_WARNED:
        _NESTED_WARNED.add(name)
        logger.warning(
            "column %r holds nested values (%s): profiling its str() form "
            "through a per-row Python loop; expect this column to dominate "
            "ingest time (nested='opaque' records count and missing only)",
            name, arr.type)
    return pa.array([None if v is None else str(v) for v in arr.to_pylist()],
                    type=pa.string())


def _row_hashed(plain: pa.Array, n: int, hll_precision: int):
    """The row-hash path of one plain-string column: (packed HLL lane,
    the ``HostBatch.cat_hashed`` payload), or None when the native library
    cannot hash it.  The row hashes are the dictionary path's value hashes
    (xxHash64 of the bytes), so both paths give the same plane."""
    rh = native.hash_string_array(plain)
    if rh is None:
        return None
    if plain.null_count == 0:
        valid = None                    # all rows valid
        packed = khll.pack(rh, None, hll_precision)
        codes, uniq = pd.factorize(rh)
        base = None
    else:
        valid = plain.is_valid().to_numpy(zero_copy_only=False)
        packed = khll.pack(rh, valid, hll_precision)
        vi = np.flatnonzero(valid)
        if vi.size:
            codes, uniq = pd.factorize(rh[vi])
            base = vi
        else:
            codes = np.zeros(0, dtype=np.int64)
            uniq = np.zeros(0, dtype=np.uint64)
            base = None
    counts = np.bincount(codes, minlength=len(uniq)).astype(np.int64)
    first_row = np.full(len(uniq), n, dtype=np.int64)
    np.minimum.at(first_row, codes, np.arange(codes.size))
    if base is not None:
        first_row = base[first_row]     # masked positions -> row numbers
    return packed, (np.asarray(uniq, dtype=np.uint64), counts, first_row,
                    rh, valid, plain)


class _DictionaryCache:
    """Per-column memo of a batch dictionary's materialized values and
    hashes, keyed on the dictionary's buffers (batches sliced from one
    Arrow dictionary share it).  Entries keep the dictionary alive so the
    buffer addresses cannot be reused while the key stands."""

    def __init__(self):
        self._ents: Dict[str, Dict[str, Any]] = {}

    def views(self, name: str, dictionary, want_hashes: bool):
        bufs = dictionary.buffers()
        key = (len(dictionary), dictionary.offset,
               tuple((b.address, b.size) if b is not None else None
                     for b in bufs))
        ent = self._ents.get(name)
        if ent is None or ent["key"] != key:
            ent = {"key": key, "ref": dictionary,
                   "dvals": np.asarray(dictionary.to_pandas(), dtype=object),
                   "hash": None}
            self._ents[name] = ent
        pair = ent["hash"]
        if want_hashes and pair is None and len(ent["dvals"]):
            h = native.hash_string_dictionary(ent["ref"])
            pair = (h, "native") if h is not None else (
                pd.util.hash_array(ent["dvals"]).astype(np.uint64),
                "pandas")
            ent["hash"] = pair      # one tuple write: readers see a pair
        if pair is None:
            return ent["dvals"], None, ""
        return ent["dvals"], pair[0], pair[1]


def prepare_batch(batch: pa.RecordBatch, plan: ColumnPlan, pad_rows: int,
                  hll_precision: int = 11, hashes: bool = True,
                  dict_cache: Optional[_DictionaryCache] = None,
                  col_stats: Optional[Dict[str, int]] = None,
                  decode_threads: Optional[int] = None,
                  full_hashes: bool = False,
                  device_lanes: frozenset = frozenset()) -> HostBatch:
    """Decode one Arrow record batch into a fixed-shape HostBatch.

    ``hashes=False`` (pass B) skips hashing and leaves a zero-width packed
    plane.  ``full_hashes`` (with ``hashes``) also keeps each numeric and
    date column's 64-bit hashes of its valid rows (``num_hashes``).
    ``device_lanes``, hash lanes of float32 columns
    (:func:`float32_hash_lanes`), are not hashed here: their packed lanes
    stay 0 and the device hashes them from ``x``.  It cannot go with
    ``full_hashes``, which needs every hash on the host.
    ``col_stats`` (owned by the ingest, like ``dict_cache``) holds each
    column's last per-batch distinct count, which moves plain-string
    columns onto the row-hash path once they prove high-cardinality.
    ``decode_threads`` is the number of leaf tasks run at once
    (``resolve_prep_workers``); the planes are byte-identical at any
    number."""
    t0 = time.perf_counter() if _obs_metrics.enabled() else None
    if dict_cache is None:
        dict_cache = _DictionaryCache()
    n = batch.num_rows
    g = pad_rows
    x = np.full((g, plan.n_num), np.nan, dtype=np.float32, order="F")
    hll_packed = np.zeros((g, plan.n_hash if hashes else 0),
                          dtype=np.uint16, order="F")
    row_valid = np.zeros((g,), dtype=bool)
    row_valid[:n] = True
    cat_codes: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
    cat_hashes: Dict[str, np.ndarray] = {}
    cat_hash_kind: Dict[str, str] = {}
    cat_hashed: Dict[str, Tuple] = {}
    date_ints: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
    # name -> (hashes, valid) while the tasks fill them
    num_hashes: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
    full_hashes = hashes and full_hashes
    opaque_nulls: Dict[str, int] = {}
    col_nbytes: Dict[str, int] = {}
    col_dict_nbytes: Dict[str, int] = {}

    def decode_column(i: int, spec: ColumnSpec) -> Tuple[float, float]:
        """One column's leaf task; the seconds of its decode and of its
        hashing (a dictionary's memoized values and hashes count as
        decode)."""
        arr = batch.column(i)
        if spec.role == "num":
            return _fill_num_rows(arr, spec, x, hll_packed,
                                  hashes and spec.hash_lane
                                  not in device_lanes, hll_precision, 0,
                                  num_hashes.get(spec.name))
        t0 = time.perf_counter()
        if spec.role == "date":
            valid = arr.is_valid().to_numpy(zero_copy_only=False)
            ints = arr.cast(pa.timestamp("ns"), safe=False) \
                      .cast(pa.int64(), safe=False) \
                      .fill_null(0).to_numpy(zero_copy_only=False)
            t1 = time.perf_counter()
            if hashes:
                keys = _num_keys(ints)
                hll_packed[:n, spec.hash_lane] = _packed_obs(
                    keys, valid, hll_precision)
                if full_hashes:
                    num_hashes[spec.name] = (_hash64(keys), valid)
            date_ints[spec.name] = (ints, valid)
            return t1 - t0, time.perf_counter() - t1
        if spec.opaque:
            # the null count is Arrow metadata; the values never decode
            opaque_nulls[spec.name] = int(arr.null_count)
            return time.perf_counter() - t0, 0.0
        if pa.types.is_nested(arr.type):
            arr = _stringified(spec.name, arr)
        if hashes and col_stats is not None \
                and col_stats.get(spec.name, 0) > ROWHASH_MIN_DISTINCT \
                and not isinstance(arr.type, pa.DictionaryType):
            # pass B still dictionary-encodes: its recount keys on values
            t1 = time.perf_counter()
            got = _row_hashed(arr, n, hll_precision)
            if got is not None:
                hll_packed[:n, spec.hash_lane], cat_hashed[spec.name] = got
                col_stats[spec.name] = len(got[1][0])
                return t1 - t0, time.perf_counter() - t1
        if not isinstance(arr.type, pa.DictionaryType):
            arr = pc.dictionary_encode(arr)
        if col_stats is not None:
            col_stats[spec.name] = len(arr.dictionary)
        valid = arr.is_valid().to_numpy(zero_copy_only=False)
        codes = arr.indices.fill_null(0).to_numpy(
            zero_copy_only=False).astype(np.int64)
        dvals, dh, hkind = dict_cache.views(spec.name, arr.dictionary,
                                            want_hashes=hashes)
        cat_codes[spec.name] = (np.where(valid, codes, -1), dvals)
        t1 = time.perf_counter()
        if hashes:
            if dvals.size:
                packed = native.pack_gather(dh, codes, valid, hll_precision)
                if packed is None:
                    packed = khll.pack(dh[codes], valid, hll_precision)
            else:
                dh = np.zeros(0, dtype=np.uint64)
                packed = np.zeros(n, dtype=np.uint16)
            cat_hashes[spec.name] = dh
            cat_hash_kind[spec.name] = hkind
            hll_packed[:n, spec.hash_lane] = packed
        return t1 - t0, time.perf_counter() - t1

    if device_lanes and hashes:
        if full_hashes:
            raise ValueError("device_lanes cannot go with full_hashes: the "
                             "exact tracker needs every hash on the host")
        wrong = device_lanes - {s.hash_lane
                                for s in float32_hash_lanes(plan)}
        if wrong:
            raise ValueError(f"hash lanes {sorted(wrong)} are not float32 "
                             "lanes: only those hash on the device")
    workers = resolve_prep_workers(decode_threads)
    num_split = 1
    if workers > 1 and n >= 2 * ROW_CHUNK_ROWS and plan.specs:
        # about ``workers`` tasks in all, never chunks below ROW_CHUNK_ROWS
        num_split = min(-(-workers // len(plan.specs)) + 1,
                        n // ROW_CHUNK_ROWS)
    tasks = []
    clock: List[Tuple[float, float]] = []   # each task's decode, hashing
    for i, spec in enumerate(plan.specs):
        arr = batch.column(i)
        # byte accounting is O(1) metadata: here, off the pool
        if isinstance(arr, pa.DictionaryArray):
            col_nbytes[spec.name] = arr.indices.nbytes
            col_dict_nbytes[spec.name] = arr.dictionary.nbytes
        else:
            col_nbytes[spec.name] = arr.nbytes
        if spec.role == "num" and full_hashes:
            # row-chunk tasks fill disjoint slices of one pair
            num_hashes[spec.name] = (np.empty(n, dtype=np.uint64),
                                     np.empty(n, dtype=bool))
        if spec.role == "num" and num_split > 1:
            step = -(-n // num_split)
            lane_hashes = hashes and spec.hash_lane not in device_lanes
            for lo in range(0, n, step):
                tasks.append(
                    lambda lo=lo, arr=arr, spec=spec, h=lane_hashes:
                    clock.append(_fill_num_rows(
                        arr.slice(lo, step), spec, x, hll_packed, h,
                        hll_precision, lo, num_hashes.get(spec.name))))
        else:
            tasks.append(
                lambda i=i, spec=spec: clock.append(decode_column(i, spec)))
    prep.run_tasks(tasks, workers)
    if hashes:
        _spans.add("decode_a", sum(d for d, _ in clock))
        _spans.add("hash_a", sum(h for _, h in clock))
    else:
        _spans.add("decode_b", sum(d for d, _ in clock))
    # compact to the valid rows here, on the prepare's thread, not on the
    # ordered fold thread: the tracker gets owned valid-only arrays, and an
    # all-valid lane passes its filled array as it is
    valid_hashes = {name: harr if hvalid.all() else harr[hvalid]
                    for name, (harr, hvalid) in num_hashes.items()}
    if t0 is not None:
        _ROWS_INGESTED.inc(n)
        _BATCHES_INGESTED.inc()
        _BYTES_INGESTED.inc(sum(col_nbytes.values())
                            + sum(col_dict_nbytes.values()))
        _PREP_SECONDS.observe(time.perf_counter() - t0)

    return HostBatch(nrows=n, x=x, row_valid=row_valid, hll=hll_packed,
                     cat_codes=cat_codes, date_ints=date_ints,
                     cat_hashes=cat_hashes if hashes else None,
                     cat_hash_kind=cat_hash_kind if hashes else None,
                     cat_hashed=cat_hashed if hashes else None,
                     num_hashes=valid_hashes if full_hashes else None,
                     opaque_nulls=opaque_nulls or None,
                     hll_precision=hll_precision, col_nbytes=col_nbytes,
                     col_dict_nbytes=col_dict_nbytes)


def prefetch_prepared(ingest: "ArrowIngest", pad: int, hll_precision: int,
                      depth: int = 2, hashes: bool = True,
                      workers: int = 1, prep_workers: Optional[int] = None,
                      batch_guard=None, skip_keys=frozenset(),
                      positions: bool = False,
                      resume_pos: Optional[Tuple[int, int]] = None,
                      full_hashes: bool = False,
                      raw_stream=None,
                      device_lanes: frozenset = frozenset()) -> Iterator:
    """Prepared batches in stream order, ``workers`` prepares in flight.

    A reader thread enumerates the raw batches and queues prepare futures
    in stream order on a bounded queue, so delivery order is the stream's
    whatever finishes first; errors of the reader and of any prepare
    re-raise in the consumer, in order.  A consumer that stops early (an
    error mid-scan, the generator closed) stops the reader.  Each prepare
    runs under ``batch_guard`` (``runtime/guard.BatchGuard``) keyed on the
    batch's stream position, so a seeded fault plan fires on the same
    batches at any worker count; with quarantine on, a batch that keeps
    failing arrives as a ``PoisonBatch``.  Batches whose position is in
    ``skip_keys`` (those pass A quarantined) are not read into a prepare
    and do not arrive.

    ``positions=True`` (a checkpointed scan) streams fragment by fragment
    (``ArrowIngest.raw_batches_positioned``), stamps each batch's
    ``frag_pos`` and keys the guard on it, as the reference does; with
    ``resume_pos=(fi, done)`` the first ``fi`` fragments are never opened
    and fragment ``fi``'s first ``done`` batches are skipped unprepared
    (zero-copy slices of a table).

    ``raw_stream``, an iterator of ``(fragment, batch, record batch)``,
    replaces the ingest's own enumeration (an elastic member's claimed
    fragments, ``ArrowIngest.read_fragment``): it is pulled as the queue
    drains, positions are stamped and the guard keys on them.

    ``full_hashes`` (``config.exact_distinct``) has every batch keep its
    numeric and date columns' 64-bit hashes, about 9 bytes a row a column
    more, so the queue holds no more than the ``workers`` prepares in
    flight.

    ``device_lanes`` passes to every prepare (:func:`prepare_batch`)."""
    depth = workers if full_hashes else max(depth, workers)
    col_threads = resolve_prep_workers(prep_workers, batch_workers=workers)
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    sentinel = object()
    failure: List[BaseException] = []
    cancelled = threading.Event()

    def _put(item) -> bool:
        # a bounded put that notices the consumer has gone: the reader
        # must not block on a full queue forever
        while not cancelled.is_set():
            try:
                q.put(item, timeout=0.5)
                _QUEUE_DEPTH.set(q.qsize())
                return True
            except queue.Full:
                continue
        return False

    pool = ThreadPoolExecutor(max_workers=workers,
                              thread_name_prefix="tpuprof-torch-prep")

    def _prep(rb, key, frag_pos=None):
        def _do():
            hb = prepare_batch(rb, ingest.plan, pad, hll_precision,
                               hashes, ingest.dict_cache,
                               ingest.col_stats, col_threads,
                               full_hashes=full_hashes,
                               device_lanes=device_lanes)
            hb.frag_pos = frag_pos
            return hb
        if batch_guard is None:
            return _do()
        return batch_guard.run(_do, site="prep", key=key,
                               rows=rb.num_rows, frag_pos=frag_pos)

    def reader():
        try:
            if raw_stream is not None:
                for fi, bi, rb in raw_stream:
                    if not _put(pool.submit(_prep, rb, (fi, bi),
                                            (fi, bi))):
                        return
                return
            if positions:
                start, done = resume_pos or (0, 0)
                for fi, bi, rb in ingest.raw_batches_positioned(start):
                    if fi == start and bi < done:
                        continue
                    if not _put(pool.submit(_prep, rb, (fi, bi),
                                            (fi, bi))):
                        return
                return
            for k, rb in enumerate(ingest.raw_batches()):
                if k in skip_keys:
                    continue
                if not _put(pool.submit(_prep, rb, k)):
                    return
        except BaseException as exc:          # re-raised consumer-side
            failure.append(exc)
        finally:
            _put(sentinel)

    threading.Thread(target=reader, daemon=True,
                     name="tpuprof-torch-prep-reader").start()
    try:
        while True:
            item = q.get()
            _QUEUE_DEPTH.set(q.qsize())
            if item is sentinel:
                break
            yield item.result()     # in order; re-raises prepare errors
        if failure:
            raise failure[0]
    finally:
        cancelled.set()
        pool.shutdown(wait=False, cancel_futures=True)


def validate_projection(columns: Sequence[str],
                        available: Sequence[str]) -> List[str]:
    """Unknown ``columns=`` names raise before any data is read."""
    available = [str(c) for c in available]
    unknown = [c for c in columns if c not in available]
    if unknown:
        raise InputError(
            f"columns not in the source: {sorted(unknown)} "
            f"(available: {sorted(set(available))})")
    return list(columns)


def _open_path_dataset(path: str) -> pads.Dataset:
    """Open a file path as a dataset, asking the Parquet reader for string
    columns dictionary-encoded straight from their dictionary pages, so
    prepare hashes a dictionary a row group instead of building one a batch
    (reference: ``_open_path_dataset``).  Other formats open as they are."""
    ds = pads.dataset(path)
    if not isinstance(getattr(ds, "format", None), pads.ParquetFileFormat):
        return ds
    str_cols = [f.name for f in ds.schema
                if pa.types.is_string(f.type)
                or pa.types.is_large_string(f.type)]
    if not str_cols:
        return ds
    fmt = pads.ParquetFileFormat(
        read_options=pads.ParquetReadOptions(dictionary_columns=str_cols))
    # the first discovery's file list, not a second listing; discover
    # again where the rebuilt schema loses columns (hive partition fields
    # live in the paths)
    files = getattr(ds, "files", None)
    fs = getattr(ds, "filesystem", None)
    if files and fs is not None:
        try:
            ds2 = pads.dataset(files, filesystem=fs, format=fmt)
            if ds2.schema.names == ds.schema.names:
                return ds2
        except (pa.ArrowInvalid, OSError):
            pass
    return pads.dataset(path, format=fmt)


class ArrowIngest:
    """A source as a repeatable stream of record batches of at most
    ``batch_rows`` rows: in-memory tables in fixed windows, datasets
    through their scanner with the projection pushed into it.
    ``max_retries`` bounds the re-reads of one fragment after an
    ``OSError``.  ``process_shard=(i, n)`` stripes a dataset's fragments
    over ``n`` processes: this one reads fragments i, i+n, i+2n, ... (an
    in-memory table cannot be striped)."""

    def __init__(self, source: Any, batch_rows: int,
                 columns: Optional[Sequence[str]] = None,
                 nested: str = "stringify", max_retries: int = 2,
                 process_shard: Tuple[int, int] = (0, 1)):
        self.batch_rows = int(batch_rows)
        self.max_retries = int(max_retries)
        self.process_shard = (int(process_shard[0]), int(process_shard[1]))
        if isinstance(source, pd.DataFrame):
            if columns is not None:
                validate_projection(columns, source.columns)
                by_str = {str(c): c for c in source.columns}
                source = source[[by_str[c] for c in columns]]
                columns = None
            table = pa.Table.from_pandas(source, preserve_index=False)
        elif isinstance(source, pa.Table):
            table = source
        elif isinstance(source, pa.RecordBatch):
            table = pa.Table.from_batches([source])
        elif isinstance(source, (pads.Dataset, str)):
            table = None
        else:
            raise TypeError(
                f"cannot ingest {type(source)!r}; expected a pandas "
                "DataFrame, a pyarrow Table or Dataset, or a Parquet path")
        self._table: Optional[pa.Table] = table
        self._dataset: Optional[pads.Dataset] = None
        # a dataset reads only the projected columns: an excluded column
        # costs no I/O and no plan entry
        self._columns: Optional[List[str]] = None
        if table is not None:
            if columns is not None:
                table = self._table = table.select(
                    validate_projection(columns, table.schema.names))
            arrow_schema = table.schema
        else:
            self._dataset = source if isinstance(source, pads.Dataset) \
                else _open_path_dataset(source)
            arrow_schema = self._dataset.schema
            if columns is not None:
                self._columns = validate_projection(columns,
                                                    arrow_schema.names)
                arrow_schema = pa.schema([arrow_schema.field(c)
                                          for c in self._columns])
        self.arrow_schema = arrow_schema
        self.plan = ColumnPlan.from_schema(arrow_schema, nested=nested)
        self.rescannable = True
        self.dict_cache = _DictionaryCache()
        # each column's last per-batch distinct count (the row-hash path)
        self.col_stats: Dict[str, int] = {}

    def raw_batches(self) -> Iterator[pa.RecordBatch]:
        """Batches of at most ``batch_rows`` rows.  A table streams in
        fixed windows, chunks combined per window (a window never splits at
        a column-chunk boundary); a dataset in its scanner's batches, which
        also end at row-group and file edges.  After the scanner's first
        ``OSError`` the rest comes from per-fragment reads with retry,
        skipping the batches already delivered (batch edges within a
        fragment are the same either way)."""
        if self._dataset is None:
            yield from (rb for _fi, _bi, rb in
                        self.raw_batches_positioned())
            return
        delivered = 0
        if self.process_shard[1] > 1:
            # a stripe reads its fragments one by one
            for _fi, _bi, rb in self.raw_batches_positioned():
                yield rb
            return
        try:
            for rb in self._dataset.to_batches(batch_size=self.batch_rows,
                                               columns=self._columns):
                yield rb
                delivered += 1
            return
        except OSError:
            pass                # the per-fragment path takes over
        for seen, (_fi, _bi, rb) in enumerate(
                self.raw_batches_positioned(), start=1):
            if seen > delivered:
                yield rb

    def _table_windows(self) -> Iterator[pa.RecordBatch]:
        tbl, pos = self._table, 0
        while pos < tbl.num_rows:
            window = tbl.slice(pos, self.batch_rows).combine_chunks()
            yield from window.to_batches()
            pos += self.batch_rows

    def raw_batches_positioned(self, skip_fragments: int = 0
                               ) -> Iterator[Tuple[int, int,
                                                   pa.RecordBatch]]:
        """The batches fragment by fragment as (fragment, batch, record
        batch); the first ``skip_fragments`` fragments are never opened.
        A table is one fragment of :meth:`raw_batches`'s windows (zero-copy
        slices until a window's chunks combine).  A fragment whose read
        raises ``OSError`` is read again, up to ``max_retries`` times,
        skipping the batches it already gave; then the error stands.  Under
        ``process_shard`` the fragments are this process's stripe, numbered
        within it."""
        if self._dataset is None:
            if self.process_shard[1] != 1:
                raise ValueError(
                    "multi-process profiling requires a file-backed "
                    "dataset (each process streams its own fragments); "
                    "got an in-memory table")
            if skip_fragments < 1:
                for bi, rb in enumerate(self._table_windows()):
                    yield 0, bi, rb
            return
        for fi, fragment in enumerate(self._my_fragments()):
            if fi < skip_fragments:
                continue
            yield from self._fragment_batches(fi, fragment)

    def _my_fragments(self):
        from tpuprof_torch.runtime.distributed import assign_fragments
        return assign_fragments(self._dataset.get_fragments(),
                                *self.process_shard)

    def _fragment_batches(self, fi: int, fragment, skip_batches: int = 0
                          ) -> Iterator[Tuple[int, int, pa.RecordBatch]]:
        """``(fi, batch, record batch)`` of one fragment from batch
        ``skip_batches`` on, re-read after an ``OSError`` as
        :meth:`raw_batches_positioned` says."""
        delivered = int(skip_batches)
        for attempt in range(self.max_retries + 1):
            try:
                for bi, rb in enumerate(fragment.to_batches(
                        batch_size=self.batch_rows, columns=self._columns)):
                    if bi < delivered:
                        continue        # skipped, or given before a failure
                    yield fi, bi, rb
                    delivered = bi + 1
                break
            except OSError:
                if attempt == self.max_retries:
                    raise

    def fragment_count(self) -> int:
        """The fragments of the whole source, not of this process's stripe
        (an elastic fleet's units of work); a table is one."""
        if self._dataset is None:
            return 1
        return sum(1 for _ in self._dataset.get_fragments())

    def read_fragment(self, fi: int, skip_batches: int = 0
                      ) -> Iterator[Tuple[int, int, pa.RecordBatch]]:
        """The batches of fragment ``fi`` of the whole source, whatever
        the stripe (an elastic member's pull unit), from batch
        ``skip_batches`` on."""
        if self._dataset is None:
            if fi != 0:
                raise ValueError(
                    f"an in-memory table has one fragment; got {fi}")
            for _fi, bi, rb in self.raw_batches_positioned():
                if bi >= skip_batches:
                    yield fi, bi, rb
            return
        for k, fragment in enumerate(self._dataset.get_fragments()):
            if k == fi:
                yield from self._fragment_batches(fi, fragment,
                                                  skip_batches)
                return
        raise ValueError(f"the dataset has no fragment {fi}")

    def fingerprint(self) -> str:
        """The source's identity (the reference's recipe): the projected
        column names and types (dictionary encoding normalized away), then
        for a table its row count and the IPC bytes of its first 4,096
        rows, for a dataset each fragment's path, size and mtime.  A
        checkpoint carries it, so a resume on other data is refused."""
        import hashlib
        import os
        h = hashlib.sha256()
        for field in self.arrow_schema:
            t = field.type
            if isinstance(t, pa.DictionaryType):
                t = t.value_type
            h.update(f"{field.name}:{t}".encode())
        if self._table is not None:
            h.update(f"rows={self._table.num_rows}".encode())
            head = self._table.slice(0, 4096).combine_chunks()
            sink = pa.BufferOutputStream()
            with pa.ipc.new_stream(sink, head.schema) as writer:
                writer.write_table(head)
            h.update(memoryview(sink.getvalue()))
        else:
            for frag in self._dataset.get_fragments():
                path = getattr(frag, "path", "")
                try:
                    stat = os.stat(path) if path else None
                except OSError:
                    stat = None
                size = stat.st_size if stat else 0
                mtime = int(stat.st_mtime_ns) if stat else 0
                h.update(f"{path}:{size}:{mtime}".encode())
        return h.hexdigest()

    def sample(self, n_rows: int) -> pd.DataFrame:
        if self._dataset is not None:
            return self._dataset.head(n_rows,
                                      columns=self._columns).to_pandas()
        return self._table.slice(0, n_rows).to_pandas()
