"""Pairwise-complete Pearson correlation state on torch tensors.

Counterpart of ``tpuprof/kernels/corr.py``.  Per batch, with M the finite
mask and D the masked, shift-centred values:

    N += M^T M,  S1 += D^T M,  S2 += (D*D)^T M,  P += D^T D

Each pair (i, j) then sees only rows where both columns are finite (pandas
``df.corr`` semantics).  Merge is addition after an exact rebase onto a
common shift.  Float32 matrix products here run in full float32: the port
never enables TF32, matching the reference's ``precision=HIGHEST``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

CorrState = Dict[str, torch.Tensor]


def init(n_cols: int, device="cpu") -> CorrState:
    c = n_cols
    z = lambda dt: torch.zeros((c, c), dtype=dt, device=device)  # noqa: E731
    return {
        "shift": torch.zeros((c,), dtype=torch.float32, device=device),
        "set": torch.zeros((), dtype=torch.int32, device=device),
        "N": z(torch.int32),
        "S1": z(torch.float32),
        "S2": z(torch.float32),
        "P": z(torch.float32),
    }


def update(state: CorrState, x: torch.Tensor,
           row_valid: torch.Tensor) -> CorrState:
    """Fold one (rows, cols) batch in; an unset state adopts this batch's
    means as its shift."""
    finite = row_valid[:, None] & torch.isfinite(x)
    m = finite.to(torch.float32)
    xf = torch.where(finite, x, 0.0)
    bmean = xf.sum(0) / torch.clamp_min(m.sum(0), 1.0)
    shift = torch.where(state["set"] > 0, state["shift"], bmean)
    d = torch.where(finite, x - shift[None, :], 0.0)
    return {
        "shift": shift,
        "set": torch.ones_like(state["set"]),
        "N": state["N"] + torch.round(m.T @ m).to(torch.int32),
        "S1": state["S1"] + d.T @ m,
        "S2": state["S2"] + (d * d).T @ m,
        "P": state["P"] + d.T @ d,
    }


def rebase(s: CorrState, target: torch.Tensor) -> CorrState:
    """d'_i = d_i + t_i with t = shift - target:
    S1' = S1 + N t_i;  S2' = S2 + 2 t_i S1 + N t_i^2;
    P'  = P + t_j S1 + t_i S1^T + N t_i t_j."""
    t = s["shift"] - target
    n = s["N"].to(torch.float32)
    ti = t[:, None]
    tj = t[None, :]
    s1, s2, p = s["S1"], s["S2"], s["P"]
    out = dict(s)
    out.update({
        "shift": target,
        "S1": s1 + n * ti,
        "S2": s2 + 2.0 * ti * s1 + n * ti * ti,
        "P": p + tj * s1 + ti * s1.T + n * ti * tj,
    })
    return out


def merge(a: CorrState, b: CorrState) -> CorrState:
    target = torch.where(a["set"] > 0, a["shift"], b["shift"])
    ar = rebase(a, target)
    br = rebase(b, target)
    return {
        "shift": target,
        "set": torch.maximum(a["set"], b["set"]),
        "N": ar["N"] + br["N"],
        "S1": ar["S1"] + br["S1"],
        "S2": ar["S2"] + br["S2"],
        "P": ar["P"] + br["P"],
    }


def finalize(state) -> np.ndarray:
    """Host-side pairwise-complete Pearson matrix (float64 numpy):
    rho_ij = (P - S1 S1^T / N) / sqrt((S2 - S1^2/N)(S2^T - S1^T^2/N));
    the shift cancels exactly."""
    def f64(v):
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu().numpy()
        return np.asarray(v, dtype=np.float64)

    n, s1, s2, p = (f64(state[k]) for k in ("N", "S1", "S2", "P"))
    with np.errstate(invalid="ignore", divide="ignore"):
        nz = np.maximum(n, 1.0)
        cov = p - s1 * s1.T / nz
        var_i = s2 - s1 * s1 / nz
        var_j = var_i.T
        rho = cov / np.sqrt(var_i * var_j)
        rho = np.where((n > 1) & (var_i > 0) & (var_j > 0), rho, np.nan)
        rho = np.clip(rho, -1.0, 1.0)
    return rho
