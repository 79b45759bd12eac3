"""The comparison that decides ``correct``.

:func:`program_view` reads what the program answered (the stats dict of
``describe``, or a served job's ``tpuprof-stats-v1`` artifact) into the form
that :func:`portbench.reference.stats.reference` gives; :func:`numbers`
compares the two.  Each number has its limit in the configuration's file:

* ``mismatches``: fields that must agree exactly and do not: the row
  count; each column's type, count and missing count; a numeric column's
  min, max, zeros and infinities; a date column's min and max; a string
  column's top-value counts; the rejected columns; and every number the
  answer leaves out: a numeric column without its histogram, a column of
  the reference's Pearson matrix missing from the answer's;
* ``hist_moved``: the largest share of a column's values that the answer
  puts in another bin than the reference does;
* ``moment_err``: the largest error of mean, std, variance, sum,
  skewness, kurtosis and MAD, each over its natural scale (the std for the
  mean and the MAD, count x std for the sum, the value itself for the
  variance and the std, max(|value|, 1) for skewness and kurtosis);
* ``rho_err``: the largest gap of a Pearson coefficient;
* ``distinct_err``: the largest relative error of a distinct count (the
  answer's are HyperLogLog estimates).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np

NUMBERS = ("mismatches", "hist_moved", "moment_err", "rho_err",
           "distinct_err")
NUM_FIELDS = ("min", "max", "n_zeros", "n_infinite", "mean", "std",
              "variance", "sum", "skewness", "kurtosis", "mad")


def _ns(value) -> int:
    import pandas as pd
    return int(pd.Timestamp(value).value)


def program_view(stats: Dict) -> Dict:
    """The answer ``stats`` (a stats dict, or a ``tpuprof-stats-v1``
    artifact whose ``sketches`` carry the histograms) in the reference's
    form."""
    hists = {}
    if "sketches" in stats:             # an artifact
        hists = {name: h["counts"] for name, h in
                 (stats["sketches"].get("histograms") or {}).items()}
        stats = stats["stats"]
    cols: Dict[str, Dict] = {}
    for name, v in stats["variables"].items():
        kind = v["type"]
        fld = {"type": kind}
        for k in ("count", "n_missing", "distinct_count"):
            fld[k] = int(v[k])
        if kind == "NUM":
            for k in NUM_FIELDS:
                fld[k] = float(v[k])
            hist = v.get("histogram")
            counts = hist[0] if hist is not None else hists.get(str(name))
            if counts is not None:
                fld["histogram"] = np.asarray(counts, dtype=np.int64)
        elif kind == "DATE":
            fld["min"], fld["max"] = _ns(v["min"]), _ns(v["max"])
        cols[str(name)] = fld
    freq: Dict[str, Dict] = {}
    for name, f in (stats.get("freq") or {}).items():
        if isinstance(f, list):         # the JSON export
            freq[str(name)] = {str(e["value"]): int(e["count"]) for e in f}
        else:
            freq[str(name)] = {str(k): int(c) for k, c in f.items()}
    pear = (stats.get("correlations") or {}).get("pearson")
    if pear is None:
        rho: Tuple[List[str], np.ndarray] = ([], np.zeros((0, 0)))
    elif isinstance(pear, dict):        # the JSON export
        names = [str(c) for c in pear["columns"]]
        m = pear["matrix"]
        rho = (names, np.array([[np.nan if m[a][b] is None else m[a][b]
                                 for b in names] for a in names],
                               dtype=np.float64))
    else:
        rho = ([str(c) for c in pear.columns],
               pear.to_numpy(dtype=np.float64))
    return {"n": int(stats["table"]["n"]), "columns": cols, "rho": rho,
            "freq": freq}


def _err(got: float, ref: float, scale: float) -> float:
    if not (math.isfinite(got) and math.isfinite(ref)):
        return 0.0 if (math.isnan(got) and math.isnan(ref)) or got == ref \
            else math.inf
    return abs(got - ref) / scale if scale > 0 else \
        (0.0 if got == ref else math.inf)


def numbers(got: Dict, ref: Dict) -> Tuple[Dict[str, float], List[str]]:
    """({number: value}, the first mismatches described) of the answer
    ``got`` against the reference ``ref``, both in the reference's form.
    What the answer leaves out counts as a mismatch, never as nothing to
    compare."""
    bad: List[str] = []

    def exact(what, a, b):
        if a != b:
            bad.append(f"{what}: {a!r} != {b!r}")

    exact("rows", got["n"], ref["n"])
    exact("columns", sorted(got["columns"]), sorted(ref["columns"]))
    moved = moment = distinct = 0.0
    for name, r in ref["columns"].items():
        g = got["columns"].get(name)
        if g is None:
            continue
        for k in ("type", "count", "n_missing"):
            exact(f"{name}.{k}", g[k], r[k])
        if r["distinct_count"]:
            distinct = max(distinct, abs(g["distinct_count"]
                                         - r["distinct_count"])
                           / r["distinct_count"])
        if g["type"] == r["type"] == "DATE":
            for k in ("min", "max"):
                exact(f"{name}.{k}", g[k], r[k])
        if not g["type"] == r["type"] == "NUM":
            continue
        for k in ("min", "max", "n_zeros", "n_infinite"):
            exact(f"{name}.{k}", g[k], r[k])
        std, var = r["std"], r["variance"]
        for k, scale in (("mean", std), ("mad", std),
                         ("sum", r["count"] * std), ("variance", var),
                         ("std", std),
                         ("skewness", max(abs(r["skewness"]), 1.0)),
                         ("kurtosis", max(abs(r["kurtosis"]), 1.0))):
            moment = max(moment, _err(g[k], r[k], scale))
        if "histogram" not in g:
            bad.append(f"{name}: no histogram")
            continue
        diff = np.abs(g["histogram"] - r["histogram"]).sum() / 2
        moved = max(moved, float(diff) / max(r["count"], 1))
    for name, fr in ref["freq"].items():
        fg = got["freq"].get(name)
        if fg is None:
            bad.append(f"{name}: no top values")
            continue
        for value, count in fg.items():
            exact(f"{name}[{value}]", count, fr.get(value))
        top = max(fr.values())
        exact(f"{name}.top", max(fg.values()), top)
    gn, gm = got["rho"]
    rn, rm = ref["rho"]
    at = {c: i for i, c in enumerate(gn)}
    common = [c for c in rn if c in at]
    for c in rn:
        if c not in at:
            bad.append(f"{c}: not in the Pearson matrix")
    rho = 0.0
    if common:
        ri = [rn.index(c) for c in common]
        gi = [at[c] for c in common]
        a, b = gm[np.ix_(gi, gi)], rm[np.ix_(ri, ri)]
        both = np.isfinite(a) & np.isfinite(b)
        exact("pairs whose rho is finite on one side only",
              int((np.isfinite(a) != np.isfinite(b)).sum()), 0)
        rho = float(np.abs(a[both] - b[both]).max()) if both.any() else 0.0
    out = {"mismatches": float(len(bad)), "hist_moved": moved,
           "moment_err": moment, "rho_err": rho, "distinct_err": distinct}
    return out, bad[:8]


def worst(per_answer: List[Dict[str, Optional[float]]]
          ) -> Dict[str, Optional[float]]:
    """The largest reading of each number over several answers."""
    out: Dict[str, Optional[float]] = {}
    for k in NUMBERS:
        vals = [d[k] for d in per_answer if d.get(k) is not None]
        out[k] = max(vals) if vals else None
    return out
