"""Fixed-bin histogram state for pass B, on torch tensors.

Counterpart of the state parts of ``tpuprof/kernels/histogram.py``: per
column ``bins`` int32 counts plus the float32 sum |x - mean| (the exact-MAD
numerator).  The per-batch binning itself is kernel K2
(``tpuprof_torch.kernels.hist``).  Merge is elementwise addition.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

HistState = Dict[str, torch.Tensor]


def init(n_cols: int, bins: int, device="cpu") -> HistState:
    return {
        "counts": torch.zeros((n_cols, bins), dtype=torch.int32,
                              device=device),
        "abs_dev": torch.zeros((n_cols,), dtype=torch.float32,
                               device=device),
    }


def counts_from_cumulative(cum: torch.Tensor) -> torch.Tensor:
    """(cols, bins) cumulative >=-edge counts -> per-bin counts:
    ``counts[b] = cum[b] - cum[b+1]`` with ``cum[bins] = 0``, clamped at 0
    so a malformed (non-monotone) input gives an empty bin, never a
    negative count."""
    upper = torch.cat([cum[:, 1:], torch.zeros_like(cum[:, :1])], dim=1)
    return torch.clamp_min(cum - upper, 0)


def merge(a: HistState, b: HistState) -> HistState:
    return {"counts": a["counts"] + b["counts"],
            "abs_dev": a["abs_dev"] + b["abs_dev"]}


def pass_b_bounds(momf) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(lo, hi, mean) for pass B from finalized pass-A moments, with
    non-finite entries (all-missing columns) set to 0 so the binning stays
    defined."""
    lo = np.where(np.isfinite(momf["fmin"]), momf["fmin"], 0.0)
    hi = np.where(np.isfinite(momf["fmax"]), momf["fmax"], 0.0)
    mean = np.where(np.isfinite(momf["mean"]), momf["mean"], 0.0)
    return lo, hi, mean


def finalize(state, lo, hi, n, bins: int
             ) -> Tuple[List[Optional[tuple]], np.ndarray]:
    """Host-side: (per-column (counts, edges) histograms, MAD array)."""
    def host(v, dtype):
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu().numpy()
        return np.asarray(v).astype(dtype)

    counts = host(state["counts"], np.int64)
    abs_dev = host(state["abs_dev"], np.float64)
    n = np.asarray(n, dtype=np.float64)
    hists: List[Optional[tuple]] = []
    for c in range(counts.shape[0]):
        if np.isfinite(lo[c]) and np.isfinite(hi[c]):
            hists.append((counts[c], np.linspace(lo[c], hi[c], bins + 1)))
        else:
            hists.append(None)
    with np.errstate(invalid="ignore", divide="ignore"):
        mad = np.where(n > 0, abs_dev / np.maximum(n, 1.0), np.nan)
    return hists, mad
