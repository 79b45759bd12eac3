"""The CPU oracle backend — exact numpy/pandas semantics.

Counterpart of ``tpuprof/backends/cpu.py``, with its arithmetic line for
line, so the two oracles give equal stats on the same frame.  It is the
ground truth the engine's statistics are held to (exact stats to float
tolerance, sketches within their bounds), and it mirrors the
``describe()``/``describe_*_1d()`` dispatch of the original Spark profiler
on a pandas DataFrame.  It runs only when ``backend="cpu"`` is named
(``describe``, ``ProfileReport``, ``profile --backend cpu``), imports no
``torch`` and launches nothing.

Statistical conventions (chosen so the engine's kernels can reproduce them
exactly from merged central moments):

* ``count``       = non-null values;  ``n_missing`` = nulls.
* moments (mean/std/variance/skewness/kurtosis/sum/mad/cv) are over
  *finite* values; ±inf is tallied in ``n_infinite`` (Spark's avg() would
  propagate inf — deliberately diverging so moments stay informative).
* ``min``/``max``/``range`` are over non-null values including ±inf
  (matches Spark min/max).
* ``skewness`` is population skewness g1 = m3 / m2^1.5 and ``kurtosis`` is
  population *excess* kurtosis m4 / m2² − 3 — the same estimators Spark
  SQL's skewness()/kurtosis() aggregates use.
* quantiles use numpy linear interpolation (the oracle is exact where the
  reference's approxQuantile was itself approximate).
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import pandas as pd

from tpuprof_torch import schema
from tpuprof_torch.config import ProfilerConfig


def _central_moments(x: np.ndarray):
    """(n, mean, m2, m3, m4) population central moments of a 1-D array."""
    n = x.size
    if n == 0:
        return 0, np.nan, np.nan, np.nan, np.nan
    mean = float(np.mean(x))
    d = x - mean
    m2 = float(np.mean(d * d))
    m3 = float(np.mean(d ** 3))
    m4 = float(np.mean(d ** 4))
    return n, mean, m2, m3, m4


def describe_numeric_1d(series: pd.Series, config: ProfilerConfig,
                        common: Dict[str, Any],
                        vc: pd.Series) -> Dict[str, Any]:
    """Reference: describe_numeric_1d — one Spark agg + approxQuantile +
    histogram per column (SURVEY §3.1 hot loop); here plain numpy."""
    values = series.dropna().to_numpy(dtype=np.float64, na_value=np.nan)
    finite = values[np.isfinite(values)]
    n_inf = int(np.isinf(values).sum())
    stats = dict(common)

    n, mean, m2, m3, m4 = _central_moments(finite)
    variance = m2 * n / (n - 1) if n > 1 else np.nan   # sample variance,
    std = float(np.sqrt(variance)) if n > 1 else np.nan  # ddof=1 (Spark stddev)
    stats.update({
        "mean": mean if n else np.nan,
        "std": std,
        "variance": variance,
        "sum": float(np.sum(finite)) if n else np.nan,
        "mad": float(np.mean(np.abs(finite - mean))) if n else np.nan,
        "cv": std / mean if n > 1 and mean != 0 else np.nan,
        "skewness": m3 / m2 ** 1.5 if n and m2 > 0 else np.nan,
        "kurtosis": m4 / (m2 * m2) - 3.0 if n and m2 > 0 else np.nan,
        "n_zeros": int((values == 0).sum()),
        "n_infinite": n_inf,
    })
    stats["p_zeros"] = stats["n_zeros"] / common["count"] if common["count"] else 0.0
    stats["p_infinite"] = n_inf / common["count"] if common["count"] else 0.0

    vmin = float(np.min(values)) if values.size else np.nan
    vmax = float(np.max(values)) if values.size else np.nan
    stats.update({"min": vmin, "max": vmax, "range": vmax - vmin})

    if finite.size:
        probes = list(config.quantile_probes)
        qs = np.quantile(finite, probes)
        for p, q in zip(probes, qs):
            stats[schema.QUANTILE_FIELDS[p]] = float(q)
        stats["iqr"] = stats["p75"] - stats["p25"]
        counts, edges = np.histogram(finite, bins=config.bins)
        stats["histogram"] = (counts.astype(np.int64), edges)
        stats["mini_histogram"] = stats["histogram"]
    else:
        for field in schema.QUANTILE_FIELDS.values():
            stats[field] = np.nan
        stats["iqr"] = np.nan
        stats["histogram"] = stats["mini_histogram"] = None

    stats["mode"] = vc.index[0] if len(vc) else np.nan
    stats["mode_approx"] = False      # oracle mode is exact value-counts
    return stats


def describe_date_1d(series: pd.Series, common: Dict[str, Any]) -> Dict[str, Any]:
    """Reference: describe_date_1d — min/max (+range) only (SURVEY §2.1)."""
    stats = dict(common)
    values = series.dropna()
    if len(values):
        vmin, vmax = values.min(), values.max()
        stats.update({"min": vmin, "max": vmax, "range": vmax - vmin})
    else:
        stats.update({"min": pd.NaT, "max": pd.NaT, "range": pd.NaT})
    return stats


def describe_categorical_1d(series: pd.Series, common: Dict[str, Any],
                            vc: pd.Series) -> Dict[str, Any]:
    """Reference: describe_categorical_1d — groupBy(col).count() descending,
    the 'top frequencies' table (SURVEY §2.1)."""
    stats = dict(common)
    stats["mode"] = vc.index[0] if len(vc) else np.nan
    stats["top"] = vc.index[0] if len(vc) else np.nan
    stats["freq"] = int(vc.iloc[0]) if len(vc) else 0
    return stats


def describe_bool_1d(series: pd.Series, common: Dict[str, Any],
                     vc: pd.Series) -> Dict[str, Any]:
    stats = describe_categorical_1d(series, common, vc)
    values = series.dropna()
    stats["mean"] = float(values.astype("float64").mean()) if len(values) else np.nan
    stats["mode_approx"] = False      # exact value-counts
    return stats


def describe_constant_1d(series: pd.Series, common: Dict[str, Any]) -> Dict[str, Any]:
    stats = dict(common)
    values = series.dropna()
    stats["mode"] = values.iloc[0] if len(values) else np.nan
    return stats


def describe_unique_1d(series: pd.Series, common: Dict[str, Any]) -> Dict[str, Any]:
    stats = dict(common)
    stats["first_rows"] = series.dropna().head(5).tolist()
    return stats


_UNHASHABLE = (list, dict, set, bytearray, np.ndarray)


def _nested_str(x):
    # ndarray cells (Table.to_pandas turns arrow lists into arrays)
    # print "[1 2]"; going through .tolist() matches the engine's ingest,
    # whose to_pylist() yields python containers ("[1, 2]")
    return str(x.tolist() if isinstance(x, np.ndarray) else x)


def _is_unhashable_col(s: pd.Series) -> bool:
    """True for columns holding unhashable cells (lists/dicts/arrays —
    nested parquet data lands here).  ``infer_dtype`` (one C pass)
    screens first; only mixed/unknown columns pay the per-cell probe."""
    hashable_kinds = frozenset((
        "string", "unicode", "bytes", "empty", "boolean", "integer",
        "floating", "mixed-integer-float", "decimal", "complex",
        "categorical", "date", "datetime", "datetime64", "time",
        "timedelta", "timedelta64", "period", "interval"))
    return s.dtype == object \
        and pd.api.types.infer_dtype(s, skipna=True) \
        not in hashable_kinds \
        and any(issubclass(t, _UNHASHABLE) for t in set(s.map(type)))


def _opaque_stub(series: pd.Series, n: int) -> Dict[str, Any]:
    """nested="opaque" stats for one column: count/missing/memory only,
    cardinality declared unknown — mirrors the engine's opaque assembly
    field for field."""
    count = int(series.count())
    return {
        "type": schema.CAT,
        "count": count,
        "n_missing": n - count,
        "p_missing": (n - count) / n if n else 0.0,
        "distinct_count": None,
        "p_unique": None,
        "is_unique": False,
        "distinct_approx": True,
        "memorysize": float(series.memory_usage(index=False, deep=True)),
        "mode": None,
        "top": None,
        "freq": 0,
    }


def _stringify_unhashable(df: pd.DataFrame) -> pd.DataFrame:
    """Columns holding unhashable values (lists/dicts/arrays — nested
    parquet data lands here) profile as their string form: one exotic
    column must not crash the whole profile, and a stringified
    categorical is the useful degradation (distincts/top-k still mean
    something).  Mirrored by the engine's ingest (ingest/arrow.py).  The
    whole column is type-probed (a mixed column whose FIRST value is
    hashable still crashes nunique otherwise); NaN/None stay missing
    (na_action) instead of becoming the string "nan".

    Cost control: see ``_is_unhashable_col``."""
    out = {}
    for col in df.columns:
        s = df[col]
        if _is_unhashable_col(s):
            s = s.map(_nested_str, na_action="ignore")
        out[col] = s
    return pd.DataFrame(out, index=df.index)


def _common_fields(series: pd.Series, n: int) -> Dict[str, Any]:
    count = int(series.count())
    distinct = int(series.nunique(dropna=True))
    return {
        "count": count,
        "n_missing": n - count,
        "p_missing": (n - count) / n if n else 0.0,
        "distinct_count": distinct,
        "p_unique": distinct / count if count else 0.0,
        "is_unique": count > 0 and distinct == count,
        # the oracle counts distincts exactly; the engine sets this
        # when a column's distinct count fell back to the HLL estimate
        "distinct_approx": False,
        "memorysize": float(series.memory_usage(index=False, deep=True)),
    }


def pearson_rejection(df: pd.DataFrame, numeric_cols: List[str],
                      config: ProfilerConfig):
    """Pairwise Pearson over numeric columns + reference rejection rule:
    scanning columns in order, a column whose |ρ| vs an *earlier kept*
    column exceeds corr_reject is flagged CORR (SURVEY §2.1)."""
    if len(numeric_cols) < 2:
        return pd.DataFrame(), {}
    corr = df[numeric_cols].corr(method="pearson")
    return corr, schema.reject_by_correlation(corr, numeric_cols, config)


class CPUStatsBackend:
    """Exact oracle over a pandas DataFrame (SURVEY §3.5 CPUStatsBackend)."""

    name = "cpu"

    def collect(self, source: Any, config: ProfilerConfig) -> Dict[str, Any]:
        # _as_pandas owns the projection (the reference's df.select
        # idiom): unknown names raise BEFORE any file-backed read
        raw = _as_pandas(source, columns=config.columns)
        n = len(raw)
        order = list(raw.columns)
        opaque_stubs: Dict[Any, Dict[str, Any]] = {}
        if config.nested == "opaque":
            keep = []
            for col in raw.columns:
                if _is_unhashable_col(raw[col]):
                    opaque_stubs[col] = _opaque_stub(raw[col], n)
                else:
                    keep.append(col)
            # every kept column was just probed hashable, so the
            # stringify pass would be the identity — skip its re-probe
            df = raw[keep]
        else:
            df = _stringify_unhashable(raw)

        base_kinds: Dict[str, str] = {}
        commons: Dict[str, Dict[str, Any]] = {}
        kinds: Dict[str, str] = {}
        for col in df.columns:
            series = df[col]
            commons[col] = _common_fields(series, n)
            base_kinds[col] = schema.classify_dtype(series)
            kinds[col] = schema.classify(
                base_kinds[col], commons[col]["distinct_count"],
                commons[col]["count"])

        numeric_cols = [c for c in df.columns if kinds[c] == schema.NUM]
        corr_matrix, rejected = pearson_rejection(df, numeric_cols, config)
        for col, (other, rho) in rejected.items():
            kinds[col] = schema.CORR

        variables: Dict[str, Dict[str, Any]] = {}
        freq: Dict[str, pd.Series] = {}
        for col in df.columns:
            series, kind, common = df[col], kinds[col], commons[col]
            if kind in (schema.NUM, schema.CAT, schema.BOOL):
                vc = series.dropna().value_counts()
            if kind == schema.NUM:
                stats = describe_numeric_1d(series, config, common, vc)
            elif kind == schema.CAT:
                stats = describe_categorical_1d(series, common, vc)
                # reference shows the top-N frequencies table; the dict
                # carries what the renderer needs, not the full distribution
                freq[col] = vc.head(config.top_freq)
            elif kind == schema.BOOL:
                stats = describe_bool_1d(series, common, vc)
                freq[col] = vc.head(config.top_freq)
            elif kind == schema.DATE:
                stats = describe_date_1d(series, common)
            elif kind == schema.CONST:
                stats = describe_constant_1d(series, common)
            elif kind == schema.CORR:
                other, rho = rejected[col]
                stats = dict(common)
                stats.update({"correlation_var": other, "correlation": rho})
            else:  # UNIQUE
                stats = describe_unique_1d(series, common)
            stats["type"] = kind
            variables[col] = stats

        if opaque_stubs:
            # stubs slot back into the SOURCE column order
            variables = {c: (opaque_stubs[c] if c in opaque_stubs
                             else variables[c]) for c in order}
        # table total = sum of what each column REPORTS: the profiled
        # frame's (possibly stringified) bytes plus the opaque columns'
        # raw bytes — keeps table vs per-column memory consistent in
        # both modes
        mem_total = float(df.memory_usage(deep=True).sum()) + sum(
            s["memorysize"] for s in opaque_stubs.values())
        table = schema.make_table_stats(n, variables, memorysize=mem_total)
        messages = schema.derive_messages(variables, config)
        correlations = {"pearson": corr_matrix}
        if config.spearman and len(numeric_cols) >= 2:
            correlations["spearman"] = df[numeric_cols].corr(method="spearman")
        if opaque_stubs:
            # the sample keeps the opaque columns (5 head rows of raw
            # values — the reference's sample section, not a decode)
            sample = raw.head(config.sample_rows)
        else:
            sample = df.head(config.sample_rows)
        return {
            "table": table,
            "variables": variables,
            "freq": freq,
            "correlations": correlations,
            "messages": messages,
            "sample": sample,
        }


def _as_pandas(source: Any, columns=None) -> pd.DataFrame:
    """``columns`` projects (in the caller's order), validated up front;
    file-backed reads push it into the scanner so excluded columns'
    pages are never read — the nested-column escape hatch works for the
    oracle too."""
    from tpuprof_torch.ingest.arrow import validate_projection
    if isinstance(source, pd.DataFrame):
        if columns is not None:
            # match on STRINGIFIED labels (the engine sees pyarrow's
            # stringified names, e.g. int labels from header-less CSVs)
            # but index with the originals — source[["0"]] on int labels
            # would KeyError
            validate_projection(columns, source.columns)
            by_str = {str(c): c for c in source.columns}
            return source[[by_str[c] for c in columns]]
        return source
    try:
        import pyarrow as pa
        import pyarrow.dataset as ds
        if isinstance(source, pa.Table):
            if columns is not None:
                return source.select(
                    validate_projection(columns, source.schema.names)
                ).to_pandas()
            return source.to_pandas()
        if isinstance(source, str):
            source = ds.dataset(source)
        if isinstance(source, ds.Dataset):
            if columns is not None:
                return source.to_table(columns=validate_projection(
                    columns, source.schema.names)).to_pandas()
            return source.to_table().to_pandas()
    except ImportError:
        pass
    raise TypeError(f"CPUStatsBackend cannot profile {type(source)!r}")
