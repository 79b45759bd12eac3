"""History queries over a per-source warehouse directory.

Counterpart of ``tpuprof/warehouse/history.py``, with its
``tpuprof-history-v1`` documents.  ``history SOURCE --stat mean --col
price`` answers "how has this column's mean moved across every profiled
generation" from the append-only columnar chain the watch loop feeds —
column-pruned reads (only the ``column`` + requested stat chunks
materialize), corrupt generations walked past (counted on
``tpuprof_warehouse_fallbacks_total`` and reported in the document, never
a raw traceback).

``--trend`` extracts drift over time: PSI/KS between every consecutive pair
of readable generations, computed by the drift engine's statistics
(artifact/drift.py ``psi_statistic``/``ks_statistic``) from the histogram
sketches each generation carries, so the trend reaches past the rotated
``artifact_keep`` window.  ``GET /v1/history/<key>`` serves the same
document off the HTTP edge (serve/http.py).
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

from tpuprof_torch.errors import CorruptWarehouseError, InputError
from tpuprof_torch.obs import blackbox
from tpuprof_torch.obs import events as _obs_events
from tpuprof_torch.obs import metrics as _obs_metrics
from tpuprof_torch.warehouse import columnar, store

HISTORY_SCHEMA = "tpuprof-history-v1"

_QUERIES = _obs_metrics.counter(
    "tpuprof_history_queries_total",
    "warehouse history queries by kind (stat|trend|columns)")
_QUERY_SECONDS = _obs_metrics.histogram(
    "tpuprof_history_query_seconds",
    "wall seconds per history query (chain scan + pruned reads)")
_FALLBACKS = _obs_metrics.counter(
    "tpuprof_warehouse_fallbacks_total",
    "history scans that walked past a corrupt warehouse generation")


def _walk(dirpath: str, columns: Optional[List[str]],
          stats: Optional[List[str]]):
    """Yield ``(generation, Generation|None)`` oldest-first, replacing
    each unreadable file with ``None`` after counting the fallback —
    the caller decides whether a hole is a skip (stat series) or a
    broken pair (trend)."""
    for gen, path in store.chain(dirpath):
        try:
            yield gen, columnar.read_stats_parquet(
                path, columns=columns, stats=stats)
        except (CorruptWarehouseError, OSError) as exc:
            _FALLBACKS.inc()
            blackbox.record("warehouse_fallback", path=path,
                            error=f"{type(exc).__name__}: {exc}")
            yield gen, None


def query_stat(dirpath: str, col: str, stat: str) -> Dict[str, Any]:
    """One column's one stat across every readable generation."""
    t0 = time.perf_counter()
    series: List[Dict[str, Any]] = []
    skipped: List[int] = []
    total = 0
    for gen, g in _walk(dirpath, [col], ["column", stat]):
        total += 1
        if g is None:
            skipped.append(gen)
            continue
        var = g.stats.get(col)
        series.append({
            "generation": gen,
            "created_unix": g.created_unix,
            "rows": g.meta.get("rows"),
            "value": None if var is None else var.get(stat),
        })
    if total == 0:
        raise InputError(
            f"no warehouse generations under {dirpath!r} — nothing "
            "profiled into this warehouse yet (the watch loop feeds "
            "it; one-shot writes need --warehouse-dir)")
    doc = _doc(dirpath, kind="stat", col=col, stat=stat, series=series,
               skipped=skipped)
    _observe("stat", dirpath, len(series), time.perf_counter() - t0)
    return doc


def query_trend(dirpath: str, col: Optional[str] = None
                ) -> Dict[str, Any]:
    """PSI/KS between every consecutive pair of readable generations —
    per column, or for one named column.  A corrupt generation breaks
    its pairs exactly as a corrupt watch artifact would: the next
    readable generation compares against the last readable one (the
    baseline-walk semantics)."""
    t0 = time.perf_counter()
    from tpuprof_torch.artifact.drift import ks_statistic, psi_statistic
    cols = [col] if col else None
    series: List[Dict[str, Any]] = []
    skipped: List[int] = []
    prev = None             # (generation, Generation) — last readable
    total = 0
    for gen, g in _walk(dirpath, cols, ["column", "hist_counts",
                                        "hist_edges"]):
        total += 1
        if g is None:
            skipped.append(gen)
            continue
        if prev is not None:
            pgen, pg = prev
            entry: Dict[str, Any] = {
                "generation": gen, "baseline_generation": pgen,
                "created_unix": g.created_unix, "columns": {}}
            for name in g.columns:
                pvar = pg.stats.get(name)
                var = g.stats.get(name)
                if pvar is None or var is None:
                    continue
                ha = _hist(pvar)
                hb = _hist(var)
                if ha is None or hb is None:
                    continue
                psi = psi_statistic(ha, hb)
                ks = ks_statistic(ha, hb)
                entry["columns"][name] = {
                    "psi": round(psi, 6) if psi is not None else None,
                    "ks": round(ks, 6) if ks is not None else None,
                }
            series.append(entry)
        prev = (gen, g)
    if total == 0:
        raise InputError(
            f"no warehouse generations under {dirpath!r} — nothing "
            "profiled into this warehouse yet")
    doc = _doc(dirpath, kind="trend", col=col, stat=None, series=series,
               skipped=skipped)
    _observe("trend", dirpath, len(series), time.perf_counter() - t0)
    return doc


def query_columns(dirpath: str, cols: List[str],
                  stats: List[str],
                  on_corrupt=None) -> Optional[Dict[str, Any]]:
    """The NEWEST readable generation's values for a column/stat subset
    — the warehouse leg of ``POST /v1/query`` pushdown.

    Walks the chain newest-first so the freshest answer wins; a corrupt
    head generation demotes to the next readable one exactly like the
    stat-series walk (counted, blackboxed, never a raw traceback).
    Column-pruned: only the ``column`` chunk plus the requested stat
    chunks materialize, so a two-stat probe of a wide profile reads
    kilobytes, not the whole Parquet file.

    Returns ``None`` when no generation is readable (the caller falls
    through to the computed tier); otherwise a dict with
    ``generation``/``created_unix``/``rows``/``columns``/``missing``,
    where ``missing`` lists requested columns this generation never
    profiled — a non-empty list also sends the caller to the computed
    tier, since the warehouse cannot answer the whole question.

    ``on_corrupt(path, exc)`` is invoked for every corrupt/unreadable
    generation the walk skips — the HTTP edge's circuit breaker
    counts these to decide when this source's warehouse
    reads stop being worth the disk tax."""
    t0 = time.perf_counter()
    for gen, path in reversed(store.chain(dirpath)):
        try:
            g = columnar.read_stats_parquet(
                path, columns=list(cols),
                stats=["column"] + [s for s in stats if s != "column"])
        except (CorruptWarehouseError, OSError) as exc:
            _FALLBACKS.inc()
            blackbox.record("warehouse_fallback", path=path,
                            error=f"{type(exc).__name__}: {exc}")
            if on_corrupt is not None:
                on_corrupt(path, exc)
            continue
        columns: Dict[str, Any] = {}
        missing: List[str] = []
        for col in cols:
            var = g.stats.get(col)
            if var is None:
                missing.append(col)
                continue
            columns[col] = {s: var.get(s) for s in stats}
        _observe("columns", dirpath, 1, time.perf_counter() - t0)
        return {
            "generation": gen,
            "created_unix": g.created_unix,
            "rows": g.meta.get("rows"),
            "columns": columns,
            "missing": missing,
        }
    return None


def _hist(var: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    counts, edges = var.get("hist_counts"), var.get("hist_edges")
    if not counts or not edges:
        return None
    return {"counts": counts, "edges": edges}


def _doc(dirpath: str, *, kind: str, col, stat, series, skipped
         ) -> Dict[str, Any]:
    return {
        "schema": HISTORY_SCHEMA,
        "kind": kind,
        "warehouse": dirpath,
        "col": col,
        "stat": stat,
        "generations": len(series),
        "skipped_corrupt": skipped,
        "series": series,
    }


def _observe(kind: str, dirpath: str, generations: int,
             seconds: float) -> None:
    if _obs_metrics.enabled():
        _QUERIES.inc(kind=kind)
        _QUERY_SECONDS.observe(seconds)
        _obs_events.emit("history_query", kind=kind, warehouse=dirpath,
                         generations=generations,
                         seconds=round(seconds, 4))
