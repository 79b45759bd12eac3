"""Per-column drift detection over two stats artifacts (``diff``).

Copy of ``tpuprof/artifact/drift.py`` without its metrics counters
(telemetry is a later slice of the port): the same ``tpuprof-drift-v1``
dict for the same two artifacts.

Every metric here is computed from what the artifacts already store —
no source data is re-read:

* **PSI / KS** from the persisted histograms.  Each histogram becomes a
  piecewise-linear empirical CDF over its own edges; KS is the max
  |CDF_A − CDF_B| over the union of both edge sets (the difference of
  two piecewise-linear functions attains its max at a breakpoint), and
  PSI re-bins both CDFs onto a common equal-width grid spanning the
  union range (the standard 10-bucket formulation, probabilities
  floored at ε so empty buckets stay finite).
* **Distinct-count churn** from the exported distinct counts (HLL /
  exact-tier — whatever the profile used; ``distinct_approx`` rides
  along so a consumer can weigh the estimate).
* **Top-k churn** from the ranked top-k sketch rows (Misra-Gries
  survivors): Jaccard distance of the two value sets, plus which values
  entered/exited.
* **Schema changes**: added / dropped columns and refined-kind changes
  (NUM→CAT is drift even when every number still parses).
* **Moment/missing shift**: |Δmean|/σ_A and Δp_missing as cheap
  always-available signals (they catch drift in columns whose
  histograms are degenerate).

Severity: each column gets ``ok``/``warn``/``drift`` by comparing its
metrics against :class:`DriftThresholds` (PSI 0.1/0.25 is the classic
banding); schema changes are always ``drift``.  The output dict is the
machine-readable ``tpuprof-drift-v1`` contract; the HTML twin renders
it through the report template environment (artifact/render.py).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

from tpuprof_torch.artifact.store import Artifact

DRIFT_SCHEMA_ID = "tpuprof-drift-v1"

PSI_BUCKETS = 10
_EPS = 1e-6


@dataclasses.dataclass(frozen=True)
class DriftThresholds:
    """warn/drift bands per metric; ``from_cli`` scales the warn band
    to half the configured drift threshold so one flag moves both."""

    psi_warn: float = 0.1
    psi_drift: float = 0.25
    ks_warn: float = 0.1
    ks_drift: float = 0.2
    missing_warn: float = 0.02
    missing_drift: float = 0.10
    mean_shift_warn: float = 0.5
    mean_shift_drift: float = 2.0
    distinct_ratio_warn: float = 1.5
    distinct_ratio_drift: float = 3.0
    topk_churn_warn: float = 0.34
    topk_churn_drift: float = 0.67

    @classmethod
    def from_cli(cls, psi: Optional[float] = None,
                 ks: Optional[float] = None) -> "DriftThresholds":
        kw = {}
        if psi is not None:
            kw.update(psi_drift=psi, psi_warn=psi / 2.0)
        if ks is not None:
            kw.update(ks_drift=ks, ks_warn=ks / 2.0)
        return cls(**kw)

    def as_dict(self) -> Dict[str, float]:
        return dataclasses.asdict(self)


# ---------------------------------------------------------------------------
# histogram -> CDF machinery
# ---------------------------------------------------------------------------

def _hist_cdf(hist: Dict[str, Any]):
    """(counts, edges) -> a callable empirical CDF, or None for an
    empty/degenerate histogram.  Point-mass histograms (every edge
    equal — constant columns) step from 0 to 1 at the value."""
    counts = [float(c) for c in hist.get("counts") or []]
    edges = [float(e) for e in hist.get("edges") or []]
    total = sum(counts)
    if total <= 0 or len(edges) != len(counts) + 1:
        return None
    if edges[-1] <= edges[0]:
        point = edges[0]

        def cdf_point(x: float) -> float:
            return 1.0 if x >= point else 0.0
        cdf_point.edges = [point]            # type: ignore[attr-defined]
        return cdf_point
    cum = [0.0]
    for c in counts:
        cum.append(cum[-1] + c)

    def cdf(x: float) -> float:
        if x <= edges[0]:
            return 0.0
        if x >= edges[-1]:
            return 1.0
        # bins are few (config.bins, default 10): linear scan is fine
        for i in range(len(counts)):
            if x < edges[i + 1]:
                lo, hi = edges[i], edges[i + 1]
                frac = (x - lo) / (hi - lo) if hi > lo else 1.0
                return (cum[i] + counts[i] * frac) / total
        return 1.0
    cdf.edges = edges                        # type: ignore[attr-defined]
    return cdf


def ks_statistic(hist_a: Dict[str, Any], hist_b: Dict[str, Any]
                 ) -> Optional[float]:
    """Two-sample KS distance between the histogram-implied CDFs (None
    when either side has no mass)."""
    ca, cb = _hist_cdf(hist_a), _hist_cdf(hist_b)
    if ca is None or cb is None:
        return None
    points = sorted(set(ca.edges) | set(cb.edges))
    return max(abs(ca(x) - cb(x)) for x in points)


def psi_statistic(hist_a: Dict[str, Any], hist_b: Dict[str, Any],
                  buckets: int = PSI_BUCKETS) -> Optional[float]:
    """Population stability index over a common equal-width grid
    spanning both ranges (None when either side has no mass)."""
    ca, cb = _hist_cdf(hist_a), _hist_cdf(hist_b)
    if ca is None or cb is None:
        return None
    lo = min(ca.edges[0], cb.edges[0])
    hi = max(ca.edges[-1], cb.edges[-1])
    if hi <= lo:                              # both point masses
        same = ca.edges[0] == cb.edges[0]
        return 0.0 if same else None
    psi = 0.0
    for i in range(buckets):
        b0 = lo + (hi - lo) * i / buckets
        b1 = lo + (hi - lo) * (i + 1) / buckets
        # closed top bucket so the max lands in-grid
        pa = max(ca(b1) - ca(b0), 0.0) if i < buckets - 1 \
            else max(1.0 - ca(b0), 0.0)
        pb = max(cb(b1) - cb(b0), 0.0) if i < buckets - 1 \
            else max(1.0 - cb(b0), 0.0)
        pa, pb = max(pa, _EPS), max(pb, _EPS)
        psi += (pa - pb) * math.log(pa / pb)
    return psi


# ---------------------------------------------------------------------------
# per-column metrics
# ---------------------------------------------------------------------------

def _topk_sets(rows: Optional[List[Dict[str, Any]]]):
    if not rows:
        return None
    # values arrive json_scalar'd; repr-keying keeps 1 and "1" distinct
    return {repr(r.get("value")) for r in rows}


def _topk_churn(rows_a, rows_b) -> Tuple[Optional[float], List, List]:
    sa, sb = _topk_sets(rows_a), _topk_sets(rows_b)
    if sa is None or sb is None:
        return None, [], []
    union = sa | sb
    if not union:
        return None, [], []
    churn = 1.0 - len(sa & sb) / len(union)
    by_val_b = {repr(r.get("value")): r.get("value") for r in rows_b}
    by_val_a = {repr(r.get("value")): r.get("value") for r in rows_a}
    entered = [by_val_b[k] for k in sorted(sb - sa)][:5]
    exited = [by_val_a[k] for k in sorted(sa - sb)][:5]
    return churn, entered, exited


def _num(var: Dict[str, Any], key: str) -> Optional[float]:
    v = var.get(key)
    if isinstance(v, bool) or not isinstance(v, (int, float)):
        return None
    return float(v)


def _severity(metrics: Dict[str, Optional[float]],
              th: DriftThresholds) -> str:
    def band(value, warn, drift):
        if value is None:
            return "ok"
        if value >= drift:
            return "drift"
        return "warn" if value >= warn else "ok"

    ratio = metrics.get("distinct_ratio")
    ratio_dev = max(ratio, 1.0 / ratio) if ratio else None
    missing = metrics.get("missing_delta")
    levels = [
        band(metrics.get("psi"), th.psi_warn, th.psi_drift),
        band(metrics.get("ks"), th.ks_warn, th.ks_drift),
        band(abs(missing) if missing is not None else None,
             th.missing_warn, th.missing_drift),
        band(metrics.get("mean_shift"),
             th.mean_shift_warn, th.mean_shift_drift),
        band(ratio_dev, th.distinct_ratio_warn, th.distinct_ratio_drift),
        band(metrics.get("topk_churn"),
             th.topk_churn_warn, th.topk_churn_drift),
    ]
    if "drift" in levels:
        return "drift"
    return "warn" if "warn" in levels else "ok"


def _column_drift(name: str, var_a: Dict[str, Any], var_b: Dict[str, Any],
                  sk_a: Dict[str, Any], sk_b: Dict[str, Any],
                  th: DriftThresholds) -> Dict[str, Any]:
    out: Dict[str, Any] = {"type": var_b.get("type"),
                           "type_base": var_a.get("type")}
    hist_a = (sk_a.get("histograms") or {}).get(name)
    hist_b = (sk_b.get("histograms") or {}).get(name)
    out["psi"] = psi_statistic(hist_a, hist_b) \
        if hist_a and hist_b else None
    out["ks"] = ks_statistic(hist_a, hist_b) \
        if hist_a and hist_b else None
    if out["psi"] is not None:
        out["psi"] = round(out["psi"], 6)
    if out["ks"] is not None:
        out["ks"] = round(out["ks"], 6)

    mean_a, mean_b = _num(var_a, "mean"), _num(var_b, "mean")
    std_a = _num(var_a, "std")
    out["mean_shift"] = round(abs(mean_b - mean_a) / std_a, 6) \
        if None not in (mean_a, mean_b, std_a) and std_a > 0 else None

    pm_a, pm_b = _num(var_a, "p_missing"), _num(var_b, "p_missing")
    out["missing_delta"] = round(pm_b - pm_a, 6) \
        if None not in (pm_a, pm_b) else None

    d_a, d_b = _num(var_a, "distinct_count"), _num(var_b, "distinct_count")
    out["distinct_base"] = int(d_a) if d_a is not None else None
    out["distinct_current"] = int(d_b) if d_b is not None else None
    out["distinct_ratio"] = round(d_b / d_a, 6) \
        if d_a and d_b is not None else None
    out["distinct_approx"] = bool(var_a.get("distinct_approx")
                                  or var_b.get("distinct_approx"))

    churn, entered, exited = _topk_churn(
        (sk_a.get("topk") or {}).get(name),
        (sk_b.get("topk") or {}).get(name))
    out["topk_churn"] = round(churn, 6) if churn is not None else None
    out["topk_entered"] = entered
    out["topk_exited"] = exited

    if var_a.get("type") != var_b.get("type"):
        out["status"] = "drift"
        out["reason"] = "type_changed"
    else:
        out["status"] = _severity(out, th)
        out["reason"] = None
    return out


# ---------------------------------------------------------------------------
# report assembly
# ---------------------------------------------------------------------------

def _endpoint(art: Artifact) -> Dict[str, Any]:
    return {
        "path": art.path,
        "rows": art.rows,
        "columns": len(art.columns),
        "degraded": bool(art.meta.get("degraded")),
        "tpuprof_version": art.meta.get("tpuprof_version"),
    }


def compute_drift(base: Artifact, current: Artifact,
                  thresholds: Optional[DriftThresholds] = None
                  ) -> Dict[str, Any]:
    """The full drift report (``tpuprof-drift-v1``) comparing ``base``
    (A) to ``current`` (B)."""
    th = thresholds or DriftThresholds()
    cols_a, cols_b = base.columns, current.columns
    vars_a = base.stats.get("variables") or {}
    vars_b = current.stats.get("variables") or {}

    added = [c for c in cols_b if c not in cols_a]
    dropped = [c for c in cols_a if c not in cols_b]

    def _schema_entry(reason: str, type_base, type_cur) -> Dict[str, Any]:
        # added/dropped columns carry the FULL metric key set (all
        # null) so every column entry has one shape — consumers and
        # the HTML template never branch on key presence
        return {
            "status": "drift", "reason": reason,
            "type": type_cur, "type_base": type_base,
            "psi": None, "ks": None, "mean_shift": None,
            "missing_delta": None, "distinct_base": None,
            "distinct_current": None, "distinct_ratio": None,
            "distinct_approx": False, "topk_churn": None,
            "topk_entered": [], "topk_exited": [],
        }

    columns: Dict[str, Any] = {}
    for name in cols_b:
        if name in added:
            columns[name] = _schema_entry("added", None, cols_b[name])
            continue
        columns[name] = _column_drift(
            name, vars_a.get(name) or {}, vars_b.get(name) or {},
            base.sketches, current.sketches, th)
    for name in dropped:
        columns[name] = _schema_entry("dropped", cols_a[name], None)

    type_changed = [c for c, e in columns.items()
                    if e.get("reason") == "type_changed"]
    n_drift = sum(1 for e in columns.values() if e["status"] == "drift")
    n_warn = sum(1 for e in columns.values() if e["status"] == "warn")
    report = {
        "schema": DRIFT_SCHEMA_ID,
        "baseline": _endpoint(base),
        "current": _endpoint(current),
        "summary": {
            "rows_base": base.rows,
            "rows_current": current.rows,
            "row_delta": current.rows - base.rows,
            "columns_compared": len(columns),
            "columns_added": added,
            "columns_dropped": dropped,
            "types_changed": type_changed,
            "n_drift": n_drift,
            "n_warn": n_warn,
            "n_ok": len(columns) - n_drift - n_warn,
            "verdict": ("drift" if n_drift else
                        "warn" if n_warn else "ok"),
        },
        "thresholds": th.as_dict(),
        "columns": columns,
    }
    return report
