"""Per-column moment state (shifted power sums) on torch tensors.

Counterpart of ``tpuprof/kernels/moments.py``: the same state keys, the same
update / rebase / merge laws and the same host ``finalize``.  Power sums are
accumulated about a per-column ``shift`` (d = x - shift) so float32 sums of
large-mean columns stay well conditioned; rebasing onto another shift uses
exact binomial identities.  Moments are over finite values, min/max over
non-null values (inf included), fmin/fmax over finite values only.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

MomentState = Dict[str, torch.Tensor]

_F32 = torch.float32
_I32 = torch.int32


def init(n_cols: int, device="cpu") -> MomentState:
    def f(v):
        return torch.full((n_cols,), v, dtype=_F32, device=device)

    def i():
        return torch.zeros((n_cols,), dtype=_I32, device=device)

    return {
        "shift": f(0.0),
        "n": i(),
        "s1": f(0.0), "s2": f(0.0), "s3": f(0.0), "s4": f(0.0),
        "minv": f(float("inf")), "maxv": f(float("-inf")),
        "fmin": f(float("inf")), "fmax": f(float("-inf")),
        "n_zeros": i(), "n_inf": i(), "n_missing": i(),
    }


def update(state: MomentState, x: torch.Tensor,
           row_valid: torch.Tensor) -> MomentState:
    """Fold one batch in.  ``x``: (rows, cols) float32, NaN where missing;
    ``row_valid``: (rows,) bool masking padding rows.  A state with no
    finite value yet adopts this batch's means as its shift."""
    rv = row_valid[:, None]
    isnan = torch.isnan(x)
    valid = rv & ~isnan
    finite = valid & torch.isfinite(x)
    xf = torch.where(finite, x, 0.0)
    nb = finite.sum(0, dtype=_I32)
    bmean = xf.sum(0) / torch.clamp_min(nb.to(_F32), 1.0)
    shift = torch.where(state["n"] > 0, state["shift"], bmean)
    d = torch.where(finite, x - shift[None, :], 0.0)
    d2 = d * d
    inf = float("inf")
    return {
        "shift": shift,
        "n": state["n"] + nb,
        "s1": state["s1"] + d.sum(0),
        "s2": state["s2"] + d2.sum(0),
        "s3": state["s3"] + (d2 * d).sum(0),
        "s4": state["s4"] + (d2 * d2).sum(0),
        "minv": torch.minimum(state["minv"],
                              _amin(torch.where(valid, x, inf))),
        "maxv": torch.maximum(state["maxv"],
                              _amax(torch.where(valid, x, -inf))),
        "fmin": torch.minimum(state["fmin"],
                              _amin(torch.where(finite, x, inf))),
        "fmax": torch.maximum(state["fmax"],
                              _amax(torch.where(finite, x, -inf))),
        "n_zeros": state["n_zeros"] + (valid & (x == 0.0)).sum(0, dtype=_I32),
        "n_inf": state["n_inf"] + (valid & torch.isinf(x)).sum(0, dtype=_I32),
        "n_missing": state["n_missing"] + (rv & isnan).sum(0, dtype=_I32),
    }


def _amin(a: torch.Tensor) -> torch.Tensor:
    if a.shape[0] == 0:
        return torch.full(a.shape[1:], float("inf"), dtype=a.dtype,
                          device=a.device)
    return a.amin(0)


def _amax(a: torch.Tensor) -> torch.Tensor:
    if a.shape[0] == 0:
        return torch.full(a.shape[1:], float("-inf"), dtype=a.dtype,
                          device=a.device)
    return a.amax(0)


def rebase(s: MomentState, target_shift: torch.Tensor) -> MomentState:
    """Re-express the shifted power sums about ``target_shift``:
    d' = d + t with t = shift - target (exact binomial identities)."""
    t = s["shift"] - target_shift
    n = s["n"].to(_F32)
    s1, s2, s3, s4 = s["s1"], s["s2"], s["s3"], s["s4"]
    out = dict(s)
    out.update({
        "shift": target_shift,
        "s1": s1 + n * t,
        "s2": s2 + 2.0 * t * s1 + n * t * t,
        "s3": s3 + 3.0 * t * s2 + 3.0 * t * t * s1 + n * t ** 3,
        "s4": (s4 + 4.0 * t * s3 + 6.0 * t * t * s2 + 4.0 * t ** 3 * s1
               + n * t ** 4),
    })
    return out


def merge(a: MomentState, b: MomentState) -> MomentState:
    """Commutative-monoid combine; the result adopts the shift of whichever
    input has data (a's when both do)."""
    target = torch.where(a["n"] > 0, a["shift"], b["shift"])
    ar = rebase(a, target)
    br = rebase(b, target)
    out = {"shift": target}
    for k in ("n", "s1", "s2", "s3", "s4", "n_zeros", "n_inf", "n_missing"):
        out[k] = ar[k] + br[k]
    out["minv"] = torch.minimum(ar["minv"], br["minv"])
    out["maxv"] = torch.maximum(ar["maxv"], br["maxv"])
    out["fmin"] = torch.minimum(ar["fmin"], br["fmin"])
    out["fmax"] = torch.maximum(ar["fmax"], br["fmax"])
    return out


def _np(v, dtype=None):
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    return np.asarray(v, dtype=dtype)


def finalize(state) -> Dict[str, np.ndarray]:
    """Host-side central moments from shifted sums (tensors or numpy in,
    float64 numpy out): sample variance/std (ddof=1), population skewness
    g1 and excess kurtosis — the CPU oracle's estimator choices."""
    n = _np(state["n"], np.float64)
    shift = _np(state["shift"], np.float64)
    s1 = _np(state["s1"], np.float64)
    s2 = _np(state["s2"], np.float64)
    s3 = _np(state["s3"], np.float64)
    s4 = _np(state["s4"], np.float64)
    with np.errstate(invalid="ignore", divide="ignore"):
        nz = np.maximum(n, 1.0)
        delta = s1 / nz
        mean = shift + delta
        m2 = np.maximum(s2 / nz - delta ** 2, 0.0)
        m3 = s3 / nz - 3.0 * delta * s2 / nz + 2.0 * delta ** 3
        m4 = (s4 / nz - 4.0 * delta * s3 / nz
              + 6.0 * delta ** 2 * s2 / nz - 3.0 * delta ** 4)
        variance = np.where(n > 1, m2 * n / np.maximum(n - 1.0, 1.0), np.nan)
        std = np.sqrt(variance)
        skew = np.where((n > 0) & (m2 > 0), m3 / np.power(m2, 1.5), np.nan)
        kurt = np.where((n > 0) & (m2 > 0), m4 / (m2 * m2) - 3.0, np.nan)
        total = s1 + n * shift
        mean = np.where(n > 0, mean, np.nan)
        cv = np.where((n > 1) & (mean != 0), std / mean, np.nan)
    return {
        "n": _np(state["n"]).astype(np.int64),
        "mean": mean,
        "variance": variance,
        "std": std,
        "skewness": skew,
        "kurtosis": kurt,
        "sum": np.where(n > 0, total, np.nan),
        "cv": cv,
        "min": _np(state["minv"], np.float64),
        "max": _np(state["maxv"], np.float64),
        "fmin": _np(state["fmin"], np.float64),
        "fmax": _np(state["fmax"], np.float64),
        "n_zeros": _np(state["n_zeros"]).astype(np.int64),
        "n_inf": _np(state["n_inf"]).astype(np.int64),
        "n_missing": _np(state["n_missing"]).astype(np.int64),
    }
