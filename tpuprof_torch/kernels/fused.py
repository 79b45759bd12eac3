"""Pass A: moments and the pairwise-Pearson Gram from one read of a batch.

Counterpart of ``tpuprof/kernels/fused.py`` (narrow tier, at most
``MAX_FUSED_COLS`` columns).  :func:`update` folds one batch, shipped as
``xt`` (cols, rows) float32 plus ``row_valid`` (rows,) bool, into the
``moments`` and ``corr`` states, whose shifts must be pre-set:

* on a CUDA tensor it launches kernel K1 (``csrc/fused_a.cu``), which
  replaces the TPU kernel ``_fused_tiles``;
* on a CPU tensor it runs :func:`update_plain`, the plain PyTorch version
  of the same function (the tests hold it against the reference).

Both return the same state dicts, so merge and finalize never care which
ran.  ``launches`` counts K1 launches.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from tpuprof_torch import kernels as _k

MAX_FUSED_COLS = 512

launches = 0            # K1 launches in this process (see module docstring)

_F32 = torch.float32
_I32 = torch.int32
_TARGET_BLOCKS = 4 * 132        # a few waves over an H100's 132 SMs
_MAX_SPLIT_ROWS = 1 << 20       # keeps each split's f32 pair count exact
_STATS_THREADS = 256

Tiles = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
              torch.Tensor, torch.Tensor]


# ---------------------------------------------------------------------------
# plain PyTorch version
# ---------------------------------------------------------------------------

def tiles_plain(xt: torch.Tensor, row_valid: torch.Tensor,
                shift: torch.Tensor) -> Tiles:
    """What K1 returns, in plain PyTorch: (sums (C,8) f32, counts (C,8)
    i32, P, S1, S2 (C,C) f32, N (C,C) i32) with the semantics of the
    reference's ``_masks`` / ``_accumulate_stats``."""
    C, R = xt.shape
    dev = xt.device
    rv = row_valid[None, :]
    isnan = torch.isnan(xt)
    notnull = rv & ~isnan
    isinf = torch.isinf(xt)
    finite = notnull & ~isinf
    m = finite.to(_F32)
    d = torch.where(finite, xt - shift[:, None], 0.0)
    d2 = d * d
    inf = float("inf")

    def red(a, fn, ident):
        if R == 0:
            return torch.full((C,), ident, dtype=_F32, device=dev)
        return fn(a, dim=1)

    sums = torch.stack([
        d.sum(1), d2.sum(1), (d2 * d).sum(1), (d2 * d2).sum(1),
        red(torch.where(notnull, xt, inf), torch.amin, inf),
        red(torch.where(notnull, xt, -inf), torch.amax, -inf),
        red(torch.where(finite, xt, inf), torch.amin, inf),
        red(torch.where(finite, xt, -inf), torch.amax, -inf)], dim=1)
    z = torch.zeros((C,), dtype=_I32, device=dev)
    counts = torch.stack([
        finite.sum(1, dtype=_I32),
        (notnull & (xt == 0.0)).sum(1, dtype=_I32),
        (notnull & isinf).sum(1, dtype=_I32),
        (rv & isnan).sum(1, dtype=_I32), z, z, z, z], dim=1)
    P = d @ d.T
    S1 = d @ m.T
    S2 = d2 @ m.T
    N = torch.round(m @ m.T).to(_I32)
    return sums, counts, P, S1, S2, N


def update_plain(mom: Dict[str, torch.Tensor], co: Dict[str, torch.Tensor],
                 xt: torch.Tensor, row_valid: torch.Tensor):
    """The plain PyTorch version of :func:`update`."""
    sums, counts, P, S1, S2, N = tiles_plain(xt, row_valid, mom["shift"])
    return _fold_mom(mom, sums, counts), _fold_corr(co, P, S1, S2, N)


# ---------------------------------------------------------------------------
# kernel K1
# ---------------------------------------------------------------------------

def _bind(lib: ctypes.CDLL) -> None:
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.tpt_fused_a.argtypes = [p, p, p, i32, i64, i32, i64, i32, i64,
                                p, p, p, p, p, p, p, p, p, p]
    lib.tpt_fused_a.restype = ctypes.c_int
    lib.tpt_fused_a_tile.restype = ctypes.c_int
    lib.tpt_fused_a_rows.restype = ctypes.c_int
    lib.tpt_error_string.argtypes = [ctypes.c_int]
    lib.tpt_error_string.restype = ctypes.c_char_p


def splits(C: int, R: int, tile: int, tr: int) -> Tuple[int, int, int, int]:
    """(stat_splits, stat_rows, gram_splits, gram_rows): the fixed row
    partition of one batch, for a Gram kernel with ``tile``-column output
    tiles that reads ``tr`` rows per chunk (``tpt_fused_a_tile`` /
    ``tpt_fused_a_rows`` of the built library).  It depends only on the
    shape, so the partial sums, and their fold order, are the same on
    every run."""
    stat_s = max(1, min(-(-_TARGET_BLOCKS // max(C, 1)),
                        -(-R // (_STATS_THREADS * 16))))
    stat_rows = max(-(-R // stat_s), 1)
    stat_s = max(-(-R // stat_rows), 1)
    tiles = (-(-C // tile)) ** 2
    gram_s = max(1, min(-(-_TARGET_BLOCKS // tiles), -(-R // tr)),
                 -(-R // _MAX_SPLIT_ROWS))
    gram_rows = -(-max(-(-R // gram_s), 1) // tr) * tr
    gram_s = max(-(-R // gram_rows), 1)
    return stat_s, stat_rows, gram_s, gram_rows


def _check_inputs(xt, row_valid, shift) -> None:
    if xt.dtype != _F32 or xt.dim() != 2 or not xt.is_contiguous():
        raise ValueError("xt must be a contiguous (cols, rows) float32 "
                         f"tensor, got {xt.dtype} {tuple(xt.shape)}")
    C, R = xt.shape
    if row_valid.dtype != torch.bool or tuple(row_valid.shape) != (R,) \
            or not row_valid.is_contiguous():
        raise ValueError(f"row_valid must be a contiguous ({R},) bool "
                         "tensor")
    if shift.dtype != _F32 or tuple(shift.shape) != (C,) \
            or not shift.is_contiguous():
        raise ValueError(f"shift must be a contiguous ({C},) float32 tensor")
    if row_valid.device != xt.device or shift.device != xt.device:
        raise ValueError("xt, row_valid and shift must share a device")
    if C > MAX_FUSED_COLS:
        raise NotImplementedError(
            f"{C} numeric columns: the column-tiled pass A for more than "
            f"{MAX_FUSED_COLS} columns is a later slice of the port")


def tiles_cuda(xt: torch.Tensor, row_valid: torch.Tensor,
               shift: torch.Tensor) -> Tiles:
    """Launch K1 on the current stream; same outputs as
    :func:`tiles_plain`."""
    global launches
    _check_inputs(xt, row_valid, shift)
    if not xt.is_cuda:
        raise ValueError("tiles_cuda needs CUDA tensors")
    lib = _k.library("fused_a", _bind)
    C, R = xt.shape
    dev = xt.device
    stat_s, stat_rows, gram_s, gram_rows = splits(
        C, R, lib.tpt_fused_a_tile(), lib.tpt_fused_a_rows())
    sums = torch.empty((C, 8), dtype=_F32, device=dev)
    counts = torch.empty((C, 8), dtype=_I32, device=dev)
    P = torch.empty((C, C), dtype=_F32, device=dev)
    S1 = torch.empty((C, C), dtype=_F32, device=dev)
    S2 = torch.empty((C, C), dtype=_F32, device=dev)
    N = torch.empty((C, C), dtype=_I32, device=dev)
    if C == 0:
        return sums, counts, P, S1, S2, N
    psums = torch.empty((C * stat_s * 8,), dtype=_F32, device=dev)
    pcounts = torch.empty((C * stat_s * 4,), dtype=_I32, device=dev)
    partial = torch.empty((gram_s * 4 * C * C,), dtype=_F32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = lib.tpt_fused_a(
            xt.data_ptr(), row_valid.data_ptr(), shift.data_ptr(), C, R,
            stat_s, stat_rows, gram_s, gram_rows, psums.data_ptr(),
            pcounts.data_ptr(), partial.data_ptr(), sums.data_ptr(),
            counts.data_ptr(), P.data_ptr(), S1.data_ptr(), S2.data_ptr(),
            N.data_ptr(), stream)
    launches += 1
    _k.check(status, "fused_a (K1)", lib)
    return sums, counts, P, S1, S2, N


# ---------------------------------------------------------------------------
# entry point and state folds
# ---------------------------------------------------------------------------

def update(mom: Dict[str, torch.Tensor], co: Dict[str, torch.Tensor],
           xt: torch.Tensor, row_valid: torch.Tensor):
    """Fold one batch into the moments and corr states (shifts pre-set):
    K1 for a CUDA tensor, the plain version for a CPU tensor."""
    if xt.is_cuda:
        tiles = tiles_cuda(xt, row_valid, mom["shift"])
        return _fold_mom(mom, tiles[0], tiles[1]), _fold_corr(co, *tiles[2:])
    if xt.device.type != "cpu":
        raise ValueError(f"no pass-A path for device {xt.device}")
    _check_inputs(xt, row_valid, mom["shift"])
    return update_plain(mom, co, xt, row_valid)


def _fold_corr(co, P, S1, S2, N):
    """Add one batch's Gram sums into a corr state (shift pre-set)."""
    return {
        "shift": co["shift"],
        "set": torch.ones_like(co["set"]),
        "N": co["N"] + N,
        "S1": co["S1"] + S1,
        "S2": co["S2"] + S2,
        "P": co["P"] + P,
    }


def _fold_mom(mom, sums, counts):
    """Fold one batch's (C, 8) sums/counts blocks into a moments state."""
    return {
        "shift": mom["shift"],
        "n": mom["n"] + counts[:, 0],
        "s1": mom["s1"] + sums[:, 0],
        "s2": mom["s2"] + sums[:, 1],
        "s3": mom["s3"] + sums[:, 2],
        "s4": mom["s4"] + sums[:, 3],
        "minv": torch.minimum(mom["minv"], sums[:, 4]),
        "maxv": torch.maximum(mom["maxv"], sums[:, 5]),
        "fmin": torch.minimum(mom["fmin"], sums[:, 6]),
        "fmax": torch.maximum(mom["fmax"], sums[:, 7]),
        "n_zeros": mom["n_zeros"] + counts[:, 1],
        "n_inf": mom["n_inf"] + counts[:, 2],
        "n_missing": mom["n_missing"] + counts[:, 3],
    }
