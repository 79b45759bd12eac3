"""The plain reference of a profile: what ``describe`` should answer for a
table, worked out again from the table itself.

Plain PyTorch and numpy, in float64, over blocks of rows, on whatever
device it is given.  It imports nothing of the program under test and
reads nothing the program made.  Its semantics are those of the upstream
``ProfileReport(df, bins, corr_reject)`` as the configuration states
them:

* a numeric column is read as float32 values (the precision the
  configuration states); NaN is missing; moments, min and max are over the
  finite values; variance and std are the sample ones (ddof 1), skewness
  the population g1, kurtosis the excess m4 / m2^2 - 3, the MAD the mean
  absolute deviation from the mean;
* the histogram has ``bins`` equal bins over [min, max], the last one
  closed;
* Pearson is pairwise complete, over the numeric columns that are not
  constant; scanning them in order, a column whose |rho| against an earlier
  kept one exceeds ``corr_reject`` is rejected;
* a column with at most one distinct value is constant; a non-numeric
  column whose values are all distinct is unique;
* a date column's min and max are exact instants; a string column's top
  values are counted exactly.

``round_to="bfloat16"`` rounds every numeric value to bfloat16 before
anything else: the control, the reference in the nearest precision below
the stated float32, as a transfer of the lanes in bfloat16 would see them.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import pandas as pd
import torch

BLOCK_ROWS = 1 << 18


def _family(series: pd.Series) -> str:
    if pd.api.types.is_bool_dtype(series):
        return "BOOL"
    if pd.api.types.is_numeric_dtype(series):
        return "NUM"
    if pd.api.types.is_datetime64_any_dtype(series):
        return "DATE"
    return "CAT"


def _lanes(df: pd.DataFrame, names: List[str], a: int, b: int,
           round_to: Optional[str]) -> np.ndarray:
    """Rows a..b of the numeric columns ``names`` as float32, (rows, C)."""
    block = np.empty((b - a, len(names)), dtype=np.float32)
    for j, name in enumerate(names):
        block[:, j] = df[name].to_numpy()[a:b].astype(np.float32)
    if round_to == "bfloat16":
        block = torch.from_numpy(block).to(torch.bfloat16).float().numpy()
    elif round_to is not None:
        raise ValueError(f"round_to={round_to!r}")
    return block


def _numeric(df: pd.DataFrame, names: List[str], bins: int, device,
             round_to: Optional[str]) -> Dict:
    """Per-column statistics and the pairwise-complete Gram sums."""
    C, n = len(names), len(df)
    f64 = dict(dtype=torch.float64, device=device)
    cnt = torch.zeros(C, **f64)
    zeros = torch.zeros(C, **f64)
    infs = torch.zeros(C, **f64)
    total = torch.zeros(C, **f64)
    lo = torch.full((C,), float("inf"), **f64)
    hi = torch.full((C,), float("-inf"), **f64)
    blocks = [(a, min(a + BLOCK_ROWS, n)) for a in range(0, n, BLOCK_ROWS)]

    def load(a, b):
        x = torch.from_numpy(_lanes(df, names, a, b, round_to)).to(device)
        return x.double()

    for a, b in blocks:
        x = load(a, b)
        fin = torch.isfinite(x)
        cnt += (~torch.isnan(x)).sum(0)
        zeros += (x == 0).sum(0)
        infs += torch.isinf(x).sum(0)
        total += torch.where(fin, x, 0).sum(0)
        lo = torch.minimum(lo, torch.where(fin, x, float("inf")).amin(0))
        hi = torch.maximum(hi, torch.where(fin, x, float("-inf")).amax(0))
    nfin = cnt - infs
    mean = total / nfin.clamp(min=1)
    m2 = torch.zeros(C, **f64)
    m3 = torch.zeros(C, **f64)
    m4 = torch.zeros(C, **f64)
    absdev = torch.zeros(C, **f64)
    hist = torch.zeros((C, bins), dtype=torch.int64, device=device)
    N = torch.zeros((C, C), **f64)
    Sx = torch.zeros((C, C), **f64)
    Sxx = torch.zeros((C, C), **f64)
    Sxy = torch.zeros((C, C), **f64)
    width = (hi - lo)
    scale = torch.where(width > 0, bins / width, 0.0)
    offs = torch.arange(C, device=device) * bins
    for a, b in blocks:
        x = load(a, b)
        fin = torch.isfinite(x)
        d = torch.where(fin, x - mean, 0.0)
        d2 = d * d
        m2 += d2.sum(0)
        m3 += (d2 * d).sum(0)
        m4 += (d2 * d2).sum(0)
        absdev += d.abs().sum(0)
        k = torch.floor((torch.where(fin, x, lo) - lo) * scale)
        k = k.clamp(0, bins - 1).long() + offs
        hist += torch.bincount(k[fin], minlength=C * bins).view(C, bins)
        m = fin.double()
        N += m.T @ m
        Sx += d.T @ m
        Sxx += d2.T @ m
        Sxy += d.T @ d
    m2, m3, m4 = m2 / nfin, m3 / nfin, m4 / nfin
    cov = Sxy - Sx * Sx.T / N
    vi = Sxx - Sx * Sx / N
    rho = cov / torch.sqrt(vi * vi.T)
    out = {k: v.cpu().numpy() for k, v in dict(
        count=cnt, n_zeros=zeros, n_infinite=infs, sum=total, min=lo,
        max=hi, mean=mean, m2=m2, m3=m3, m4=m4, absdev=absdev, nfin=nfin,
        hist=hist, rho=rho).items()}
    out["distinct"] = np.zeros(C, dtype=np.int64)
    for j, name in enumerate(names):
        v = torch.from_numpy(_lanes(df, [name], 0, n, round_to)[:, 0])
        v = v.to(device)
        v = v[~torch.isnan(v)]
        out["distinct"][j] = int(torch.unique(v).numel())
    return out


def _reject(names: List[str], rho: np.ndarray, corr_reject: float) -> set:
    kept: List[int] = []
    rejected = set()
    for i, name in enumerate(names):
        r = rho[i, kept] if kept else np.empty(0)
        if np.any(np.isfinite(r) & (np.abs(r) > corr_reject)):
            rejected.add(name)
        else:
            kept.append(i)
    return rejected


def reference(df: pd.DataFrame, bins: int, corr_reject: float,
              device="cpu", round_to: Optional[str] = None) -> Dict:
    """The reference's view of a profile of ``df``: ``{"n", "columns":
    {name: fields}, "rho": (names, matrix), "freq": {name: {value:
    count}}}``, in the form :mod:`portbench.compare` reads."""
    n = len(df)
    fams = {c: _family(df[c]) for c in df.columns}
    cols: Dict[str, Dict] = {}
    freq: Dict[str, Dict] = {}
    num = [c for c in df.columns if fams[c] in ("NUM", "BOOL")]
    stats = _numeric(df, num, bins, device, round_to) if num else None
    for j, c in enumerate(num):
        count = int(stats["count"][j])
        distinct = int(stats["distinct"][j])
        fld = {"count": count, "n_missing": n - count,
               "distinct_count": distinct}
        if distinct <= 1:
            fld["type"] = "CONST"
        elif fams[c] == "BOOL":
            fld["type"] = "BOOL"
        else:
            nf = stats["nfin"][j]
            m2 = stats["m2"][j]
            var = m2 * nf / (nf - 1) if nf > 1 else float("nan")
            fld.update({
                "type": "NUM",
                "min": float(stats["min"][j]), "max": float(stats["max"][j]),
                "n_zeros": int(stats["n_zeros"][j]),
                "n_infinite": int(stats["n_infinite"][j]),
                "sum": float(stats["sum"][j]),
                "mean": float(stats["mean"][j]),
                "variance": float(var), "std": float(np.sqrt(var)),
                "skewness": float(stats["m3"][j] / m2 ** 1.5),
                "kurtosis": float(stats["m4"][j] / m2 ** 2 - 3.0),
                "mad": float(stats["absdev"][j] / nf),
                "histogram": stats["hist"][j].copy(),
            })
        cols[c] = fld
    for c in df.columns:
        if fams[c] == "DATE":
            v = df[c].to_numpy().astype("datetime64[ns]").view(np.int64)
            v = v[v != np.iinfo(np.int64).min]
            distinct = int(np.unique(v).size)
            cols[c] = {"count": int(v.size), "n_missing": n - int(v.size),
                       "distinct_count": distinct,
                       "type": "CONST" if distinct <= 1 else "DATE"}
            if v.size:
                cols[c].update(min=int(v.min()), max=int(v.max()))
        elif fams[c] == "CAT":
            vc = df[c].value_counts(dropna=True)
            count = int(vc.sum())
            distinct = int(vc.size)
            kind = ("CONST" if distinct <= 1 else
                    "UNIQUE" if distinct == count else "CAT")
            cols[c] = {"count": count, "n_missing": n - count,
                       "distinct_count": distinct, "type": kind}
            freq[c] = {str(k): int(v) for k, v in vc.items()}
    keep = [j for j, c in enumerate(num) if cols[c]["type"] == "NUM"]
    names = [num[j] for j in keep]
    rho = stats["rho"][np.ix_(keep, keep)] if keep else np.zeros((0, 0))
    for c in _reject(names, rho, corr_reject):
        cols[c]["type"] = "CORR"
    return {"n": n, "columns": {c: cols[c] for c in df.columns},
            "rho": (names, rho), "freq": freq}
