"""Arrow -> device-batch preparation, the host side of the scan.

Counterpart of ``tpuprof/ingest/arrow.py`` for a pandas DataFrame, a
pyarrow Table, a ``pyarrow.dataset.Dataset`` or the path of a Parquet file
or directory.  Per record batch it produces fixed-shape numpy planes the
device step consumes:

* ``x``         (G, n_num) float32, Fortran order (so ``x.T`` is a
  C-contiguous (cols, rows) view) — numeric and boolean lanes, NaN missing;
* ``row_valid`` (G,) bool — masks the padding rows;
* ``hll``       (G, n_hash) uint16 — packed HLL observations for every
  column (``kernels.hll.pack``), 0 = null or padding;

plus the host-only side channels: dictionary codes of categorical columns
(Misra-Gries, recount), int64-nanosecond dates, Arrow buffer sizes.  The
hashing is the reference's, bit for bit (native C++ when it builds, pandas
otherwise), so distinct counts and top-k keys agree with it.

Batches are prepared on a small thread pool and delivered in stream order
(:func:`prefetch_prepared`); every order-sensitive fold happens in the
consumer.  A dataset streams through its scanner: batches end at row-group
and file edges, so short batches come mid-stream, and Parquet string
columns arrive dictionary-encoded with one dictionary a row group.  The
reference's retry after an ``OSError``, fragment striping across processes,
nested columns and the plain-string row-hash path are later slices.
"""

from __future__ import annotations

import collections
import dataclasses
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.compute as pc
import pyarrow.dataset as pads

from tpuprof_torch import native, schema
from tpuprof_torch.errors import InputError
from tpuprof_torch.kernels import hll as khll


@dataclasses.dataclass
class ColumnSpec:
    name: str
    role: str                 # "num" | "date" | "cat"
    base_kind: str            # schema.{NUM,BOOL,DATE,CAT} before refinement
    num_lane: int = -1        # lane in the x plane ("num" role only)
    hash_lane: int = -1       # lane in the hll plane (every column)
    arrow_type: Optional[pa.DataType] = None


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
    def from_schema(cls, arrow_schema: pa.Schema) -> "ColumnPlan":
        specs: List[ColumnSpec] = []
        num_lane = 0
        for hash_lane, field in enumerate(arrow_schema):
            t = field.type
            inner = t.value_type if isinstance(t, pa.DictionaryType) else t
            if pa.types.is_nested(inner):
                raise NotImplementedError(
                    f"column {field.name!r} holds nested values ({t}): "
                    "nested columns are a later slice of the PyTorch port "
                    "(exclude it with columns=...)")
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
    hll_precision: int = 11
    col_nbytes: Optional[Dict[str, int]] = None       # Arrow buffer bytes
    col_dict_nbytes: Optional[Dict[str, int]] = None  # shared dictionaries


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


def _fill_num(arr: pa.Array, lane: int, x: np.ndarray) -> np.ndarray:
    """Decode one numeric/bool Arrow column into plane lane ``lane``;
    returns the decoded values (for hashing) and writes NaN for nulls."""
    t = arr.type
    n = len(arr)
    if pa.types.is_floating(t) and t.bit_width == 32:
        vals = arr.to_numpy(zero_copy_only=False)    # f32, NaN = null
        x[:n, lane] = vals
    elif pa.types.is_floating(t) and t.bit_width == 64 \
            and arr.null_count == 0:
        vals = arr.to_numpy()
        x[:n, lane] = vals
    elif pa.types.is_floating(t) or pa.types.is_decimal(t):
        vals = arr.cast(pa.float64(), safe=False).to_numpy(
            zero_copy_only=False)
        x[:n, lane] = vals.astype(np.float32)
    elif arr.null_count == 0 and not pa.types.is_boolean(t):
        # ints stay int64 so ids above 2^53 hash exactly
        vals = arr.to_numpy().astype(np.int64, copy=False)
        x[:n, lane] = vals.astype(np.float32)
    else:                           # bools, and ints carrying nulls
        vals = arr.cast(pa.int64(), safe=False).fill_null(0) \
            .to_numpy(zero_copy_only=False)
        xf = vals.astype(np.float32)
        if arr.null_count:
            valid = arr.is_valid().to_numpy(zero_copy_only=False)
            xf = np.where(valid, xf, np.nan)
        x[:n, lane] = xf
    return vals


def _num_valid(arr: pa.Array, vals: np.ndarray) -> np.ndarray:
    t = arr.type
    if pa.types.is_floating(t) or pa.types.is_decimal(t):
        return ~np.isnan(vals.astype(np.float64, copy=False))
    if arr.null_count:
        return arr.is_valid().to_numpy(zero_copy_only=False)
    return np.ones(len(arr), dtype=bool)


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
                  dict_cache: Optional[_DictionaryCache] = None
                  ) -> HostBatch:
    """Decode one Arrow record batch into a fixed-shape HostBatch.
    ``hashes=False`` (pass B) skips hashing and leaves a zero-width
    packed plane."""
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
    date_ints: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
    col_nbytes: Dict[str, int] = {}
    col_dict_nbytes: Dict[str, int] = {}

    for i, spec in enumerate(plan.specs):
        arr = batch.column(i)
        if isinstance(arr, pa.DictionaryArray):
            col_nbytes[spec.name] = arr.indices.nbytes
            col_dict_nbytes[spec.name] = arr.dictionary.nbytes
        else:
            col_nbytes[spec.name] = arr.nbytes
        if spec.role == "num":
            vals = _fill_num(arr, spec.num_lane, x)
            if hashes:
                hll_packed[:n, spec.hash_lane] = _packed_obs(
                    _num_keys(vals), _num_valid(arr, vals), hll_precision)
        elif spec.role == "date":
            valid = arr.is_valid().to_numpy(zero_copy_only=False)
            ints = arr.cast(pa.timestamp("ns"), safe=False) \
                      .cast(pa.int64(), safe=False) \
                      .fill_null(0).to_numpy(zero_copy_only=False)
            if hashes:
                hll_packed[:n, spec.hash_lane] = _packed_obs(
                    _num_keys(ints), valid, hll_precision)
            date_ints[spec.name] = (ints, valid)
        else:
            if not isinstance(arr.type, pa.DictionaryType):
                arr = pc.dictionary_encode(arr)
            valid = arr.is_valid().to_numpy(zero_copy_only=False)
            codes = arr.indices.fill_null(0).to_numpy(
                zero_copy_only=False).astype(np.int64)
            dvals, dh, hkind = dict_cache.views(spec.name, arr.dictionary,
                                                want_hashes=hashes)
            if hashes:
                if dvals.size:
                    packed = native.pack_gather(dh, codes, valid,
                                                hll_precision)
                    if packed is None:
                        packed = khll.pack(dh[codes], valid, hll_precision)
                else:
                    dh = np.zeros(0, dtype=np.uint64)
                    packed = np.zeros(n, dtype=np.uint16)
                cat_hashes[spec.name] = dh
                cat_hash_kind[spec.name] = hkind
                hll_packed[:n, spec.hash_lane] = packed
            cat_codes[spec.name] = (np.where(valid, codes, -1), dvals)

    return HostBatch(nrows=n, x=x, row_valid=row_valid, hll=hll_packed,
                     cat_codes=cat_codes, date_ints=date_ints,
                     cat_hashes=cat_hashes if hashes else None,
                     cat_hash_kind=cat_hash_kind if hashes else None,
                     hll_precision=hll_precision, col_nbytes=col_nbytes,
                     col_dict_nbytes=col_dict_nbytes)


def prefetch_prepared(ingest: "ArrowIngest", pad: int, hll_precision: int,
                      depth: int = 2, hashes: bool = True,
                      workers: int = 1) -> Iterator[HostBatch]:
    """Prepared batches in stream order, ``workers`` prepares in flight
    (Arrow decode and the native hashing release the GIL), at most
    ``max(depth, workers)`` buffered ahead of the consumer."""
    ahead = max(depth, workers)
    with ThreadPoolExecutor(max_workers=workers,
                            thread_name_prefix="tpuprof-torch-prep") as pool:
        pending: collections.deque = collections.deque()
        try:
            for rb in ingest.raw_batches():
                pending.append(pool.submit(
                    prepare_batch, rb, ingest.plan, pad, hll_precision,
                    hashes, ingest.dict_cache))
                if len(pending) >= ahead:
                    yield pending.popleft().result()
            while pending:
                yield pending.popleft().result()
        finally:
            for fut in pending:
                fut.cancel()


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
    through their scanner with the projection pushed into it."""

    def __init__(self, source: Any, batch_rows: int,
                 columns: Optional[Sequence[str]] = None):
        self.batch_rows = int(batch_rows)
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
        # a dataset reads only the projected columns: an excluded nested
        # column costs no I/O and no plan entry
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
        self.plan = ColumnPlan.from_schema(arrow_schema)
        self.rescannable = True
        self.dict_cache = _DictionaryCache()

    def raw_batches(self) -> Iterator[pa.RecordBatch]:
        """Batches of at most ``batch_rows`` rows.  A table streams in
        fixed windows, chunks combined per window (a window never splits at
        a column-chunk boundary); a dataset in its scanner's batches, which
        also end at row-group and file edges."""
        if self._dataset is not None:
            yield from self._dataset.to_batches(batch_size=self.batch_rows,
                                                columns=self._columns)
            return
        tbl, pos = self._table, 0
        while pos < tbl.num_rows:
            window = tbl.slice(pos, self.batch_rows).combine_chunks()
            yield from window.to_batches()
            pos += self.batch_rows

    def sample(self, n_rows: int) -> pd.DataFrame:
        if self._dataset is not None:
            return self._dataset.head(n_rows,
                                      columns=self._columns).to_pandas()
        return self._table.slice(0, n_rows).to_pandas()
