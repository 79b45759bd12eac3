"""The one generator of the benchmark's tables.

A configuration's ``columns`` list says what to make; this module makes
it from a seed, on the host, with numpy's generators.  Each entry is one
column, or with ``"kind": "wide"`` a block of float32 columns.  Kinds:

* ``wide``: ``count`` float32 columns named ``prefix`` + index, of rising
  scale and offset (``scale`` and ``offset`` are [first, last]), the first
  ``shared_columns`` sharing ``shared_strength`` times one common normal,
  ``nan_share`` of the cells NaN;
* ``choice``: ``values`` drawn with probabilities ``p``;
* ``integers``: uniform over ``low``..``high``, both included;
* ``gamma`` (``shape``, ``scale``), ``exponential`` (``scale``);
* ``linear``: ``factor`` times column ``of`` plus a normal of sd ``noise``;
* ``sum``: the sum of the columns ``of``;
* ``datetime``: whole seconds uniform over ``span_s`` from ``start``;
* ``datetime_after``: column ``of`` plus an exponential of mean
  ``mean_s`` seconds.

``dtype`` is ``int64``, ``float32``, ``float64``, ``string`` or
``datetime``.  ``null_share`` turns that share of a column's rows missing
after every column is made, so a derived column is derived from whole
values.  The same seed gives the same table.
"""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np
import pandas as pd


def _wide(rng, rows: int, spec: Dict) -> Dict[str, np.ndarray]:
    cols = int(spec["count"])
    base = rng.standard_normal((rows, 1), dtype=np.float32)
    data = rng.standard_normal((rows, cols), dtype=np.float32)
    data *= np.linspace(*spec["scale"], cols, dtype=np.float32)[None, :]
    data += np.linspace(*spec["offset"], cols, dtype=np.float32)[None, :]
    block = int(spec["shared_columns"])
    data[:, :block] += np.float32(spec["shared_strength"]) * base
    data[rng.random((rows, cols), dtype=np.float32)
         < np.float32(spec["nan_share"])] = np.nan
    return {"__block__": data}


def _column(rng, rows: int, spec: Dict, made: Dict) -> np.ndarray:
    kind = spec["kind"]
    if kind == "choice":
        idx = rng.choice(len(spec["values"]), rows, p=spec["p"])
        return np.asarray(spec["values"], dtype=object
                          if spec["dtype"] == "string" else None)[idx]
    if kind == "integers":
        return rng.integers(spec["low"], spec["high"] + 1, rows)
    if kind == "gamma":
        return rng.gamma(spec["shape"], spec["scale"], rows)
    if kind == "exponential":
        return rng.exponential(spec["scale"], rows)
    if kind == "linear":
        return (spec["factor"] * made[spec["of"]]
                + rng.normal(0.0, spec["noise"], rows))
    if kind == "sum":
        return np.sum([made[c] for c in spec["of"]], axis=0)
    if kind == "datetime":
        secs = rng.integers(0, int(spec["span_s"]), rows)
        return (np.datetime64(spec["start"], "ns")
                + secs.astype("timedelta64[s]").astype("timedelta64[ns]"))
    if kind == "datetime_after":
        secs = np.rint(rng.exponential(spec["mean_s"], rows)).astype(np.int64)
        return made[spec["of"]] + secs.astype("timedelta64[s]").astype(
            "timedelta64[ns]")
    raise ValueError(f"unknown column kind {kind!r}")


_DTYPES = {"int64": np.int64, "float32": np.float32, "float64": np.float64}


def make_table(config: Dict, rows: int, seed: int) -> pd.DataFrame:
    """The table of ``config`` at ``rows`` rows, from ``seed``."""
    rng = np.random.default_rng(seed)
    made: Dict[str, np.ndarray] = {}
    names: List[str] = []
    blocks = []
    for spec in config["columns"]:
        if spec["kind"] == "wide":
            data = _wide(rng, rows, spec)["__block__"]
            prefix, n = spec["prefix"], int(spec["count"])
            blocks.append(pd.DataFrame(
                data, columns=[f"{prefix}{i:04d}" for i in range(n)],
                copy=False))
            continue
        made[spec["name"]] = _column(rng, rows, spec, made)
        names.append(spec["name"])
    out = {}
    for spec in config["columns"]:
        if spec["kind"] == "wide":
            continue
        name, dtype = spec["name"], spec["dtype"]
        values = made[name]
        share = float(spec.get("null_share", 0.0))
        missing = (rng.random(rows) < share) if share else None
        if dtype in ("float32", "float64"):
            values = values.astype(_DTYPES[dtype])
            if missing is not None:
                values[missing] = np.nan
        elif dtype == "int64":
            if missing is not None:
                raise ValueError(f"{name}: an int64 column holds no nulls")
            values = values.astype(np.int64)
        elif dtype == "string":
            if missing is not None:
                values = values.copy()
                values[missing] = None
        elif dtype == "datetime":
            values = values.astype("datetime64[ns]")
            if missing is not None:
                values[missing] = np.datetime64("NaT")
        else:
            raise ValueError(f"{name}: unknown dtype {dtype!r}")
        out[name] = values
    frames = blocks + ([pd.DataFrame(out)] if out else [])
    if len(frames) == 1:
        return frames[0]
    return pd.concat(frames, axis=1, copy=False)


def write_parquet(df: pd.DataFrame, path: str) -> str:
    """``df`` as one Parquet file at ``path``, with pyarrow's defaults."""
    import pyarrow as pa
    import pyarrow.parquet as pq
    os.makedirs(os.path.dirname(path), exist_ok=True)
    pq.write_table(pa.Table.from_pandas(df, preserve_index=False), path)
    return path


def batch_sizes(source, batch_rows: int) -> List[int]:
    """The rows of each batch the engine reads from ``source``: a frame in
    windows of ``batch_rows``, a Parquet file's row groups each in such
    windows (a batch never spans two)."""
    if isinstance(source, pd.DataFrame):
        groups = [len(source)]
    else:
        import pyarrow.parquet as pq
        meta = pq.ParquetFile(source).metadata
        groups = [meta.row_group(g).num_rows
                  for g in range(meta.num_row_groups)]
    out = []
    for rows in groups:
        out += [batch_rows] * (rows // batch_rows)
        if rows % batch_rows:
            out.append(rows % batch_rows)
    return out
