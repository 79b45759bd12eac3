"""Pass A and the Spearman rank pass: moments and pairwise Gram sums.

Counterpart of ``tpuprof/kernels/fused.py``.  Each entry point takes a batch
as the runner ships it, ``xt`` (cols, rows) float32 plus ``row_valid``
(rows,) bool, launches a kernel for a CUDA tensor and runs the kernel's
plain PyTorch version for a CPU tensor (the tests hold the plain versions
against the reference; on the card only ``chip_smoke.py`` runs them):

* :func:`update` folds a batch into the ``moments`` and ``corr`` states
  (shifts pre-set): kernel K1 (``csrc/fused_a.cu``, replaces the TPU kernel
  ``_fused_tiles``) up to ``MAX_FUSED_COLS`` columns, kernel K3
  (``csrc/fused_wide.cu``, replaces ``_fused_tiles_wide``) up to
  ``MAX_FUSED_COLS_WIDE``;
* :func:`spearman_update` folds a batch's grid ranks into a corr state
  whose shift is 0.5: kernel K5 (``csrc/spear.cu``, replaces
  ``_spear_tiles``), up to ``MAX_FUSED_COLS`` columns, which runs K6's
  rank launch into a scratch and K1's Gram over it, bit for bit K6 then
  K3 with ``skip_stats``;
* wider tables rank in two stages: :func:`rank_transform`, kernel K6
  (``csrc/rank.cu``, replaces ``_rank_tiles``), writes the ranks, and
  :func:`spearman_update_wide` runs K3 with ``skip_stats`` over them;
* :func:`update_with_hist` folds a batch into the moments, corr AND
  histogram states in one read, binning on provisional bounds
  (``profile_passes="fused"``): kernel K4 (``csrc/fused_ab.cu``, replaces
  ``_fused_ab_tiles``), up to ``MAX_FUSED_AB_COLS`` columns, bit for bit
  K1 followed by K2.

* :func:`update_xla`, the reference's XLA twin (``moments.update`` then
  ``corr.update``: PyTorch calls, no kernel), folds tables wider than
  ``MAX_FUSED_COLS_WIDE`` columns, and :func:`spearman_update_exact`
  (``searchsorted`` ranks in the row sample, then ``corr.update``) ranks
  them for Spearman: the reference's exact tier.

All return the reference's state dicts, so merge and finalize never care
which ran.  ``launches``, ``launches_wide``, ``launches_spear``,
``launches_rank`` and ``launches_ab`` count the launches of K1, K3, K5, K6
and K4.
"""

from __future__ import annotations

import contextlib
import ctypes
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from tpuprof_torch import kernels as _k
from tpuprof_torch.config import MAX_SPEAR_GRID
from tpuprof_torch.kernels import corr, moments
from tpuprof_torch.kernels import hist as khist

MAX_FUSED_COLS = 512
MAX_FUSED_COLS_WIDE = 2048
# K4 runs K1's Gram and statistics, so it takes what K1 takes; wider tables
# pair K3 and K2 on one shipped batch (runtime/runner.py)
MAX_FUSED_AB_COLS = MAX_FUSED_COLS

launches = 0            # K1 launches in this process (see module docstring)
launches_wide = 0       # K3
launches_spear = 0      # K5
launches_rank = 0       # K6
launches_ab = 0         # K4

_F32 = torch.float32
_I32 = torch.int32
_TARGET_BLOCKS = 4 * 132        # a few waves over an H100's 132 SMs
_MAX_SPLIT_ROWS = 1 << 20       # keeps each split's f32 pair count exact
# K3's row splits each hold (4, C, C) partial Gram sums (64 MiB at
# C=2048), so past MAX_FUSED_COLS columns their count is capped: the
# scratch stays a small multiple of the outputs
_WIDE_MAX_GRAM_SPLITS = 4
_PLAIN_RANK_CHUNK = 1 << 21     # values ranked per step of the plain rank

Tiles = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
              torch.Tensor, torch.Tensor]
Grams = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]
TilesAB = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
                torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]

_WIDER = (f"the kernels take at most {MAX_FUSED_COLS_WIDE} columns; wider "
          "tables fold with update_xla and rank on the exact tier "
          "(runtime/runner.py)")


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------

def _gram_plain(d: torch.Tensor, m: torch.Tensor) -> Grams:
    """P = d d^T, S1 = d m^T, S2 = d^2 m^T, N = m m^T (int32)."""
    return (d @ d.T, d @ m.T, (d * d) @ m.T,
            torch.round(m @ m.T).to(_I32))


def _identity_stats(C: int, dev) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sums, counts) identities: 0, except +inf for the minima (lanes 4,
    6) and -inf for the maxima (lanes 5, 7)."""
    inf = float("inf")
    sums = torch.tensor([0.0, 0.0, 0.0, 0.0, inf, -inf, inf, -inf],
                        dtype=_F32, device=dev).repeat(C, 1)
    return sums, torch.zeros((C, 8), dtype=_I32, device=dev)


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
    return (sums, counts) + _gram_plain(d, m)


def tiles_wide_plain(xt: torch.Tensor, row_valid: torch.Tensor,
                     shift: torch.Tensor, skip_stats: bool = False) -> Tiles:
    """What K3 returns, in plain PyTorch: :func:`tiles_plain`'s outputs;
    with ``skip_stats`` the Gram alone, sums/counts at their identities
    (the reference's ``_fused_tiles_wide(..., skip_stats=True)``)."""
    if not skip_stats:
        return tiles_plain(xt, row_valid, shift)
    finite = row_valid[None, :] & torch.isfinite(xt)
    d = torch.where(finite, xt - shift[:, None], 0.0)
    return (_identity_stats(xt.shape[0], xt.device)
            + _gram_plain(d, finite.to(_F32)))


def _rank_scale(n_grid: int) -> float:
    """float32(0.5 / G), computed in double and rounded once: the
    reference's weak-typed constant."""
    return float(np.float32(0.5 / n_grid))


def grid_ranks_plain(xt: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """(#grid < x + #grid <= x) * float32(0.5 / G) for every value: the
    reference's dense compare (``_grid_ranks``), a column chunk at a
    time."""
    C, R = xt.shape
    G = grid.shape[1]
    scale = torch.tensor(_rank_scale(G), dtype=_F32, device=xt.device)
    out = torch.empty_like(xt)
    step = max(1, _PLAIN_RANK_CHUNK // max(R, 1))
    for c0 in range(0, C, step):
        x = xt[c0:c0 + step]
        g = grid[c0:c0 + step]
        lt = torch.zeros_like(x)
        le = torch.zeros_like(x)
        for j in range(G):
            point = g[:, j:j + 1]
            lt += point < x
            le += point <= x
        out[c0:c0 + step] = (lt + le) * scale
    return out


def rank_transform_plain(xt: torch.Tensor, row_valid: torch.Tensor,
                         grid: torch.Tensor) -> torch.Tensor:
    """What K6 returns, in plain PyTorch: grid ranks where the row is
    valid and the value finite, NaN elsewhere."""
    finite = row_valid[None, :] & torch.isfinite(xt)
    return torch.where(finite, grid_ranks_plain(xt, grid), float("nan"))


def spear_tiles_plain(xt: torch.Tensor, row_valid: torch.Tensor,
                      grid: torch.Tensor) -> Grams:
    """What K5 returns, in plain PyTorch: (P, S1, S2, N) of d = rank - 0.5
    over the finite values (the reference's ``_spear_tiles``)."""
    finite = row_valid[None, :] & torch.isfinite(xt)
    d = torch.where(finite, grid_ranks_plain(xt, grid) - 0.5, 0.0)
    return _gram_plain(d, finite.to(_F32))


def tiles_ab_plain(xt: torch.Tensor, row_valid: torch.Tensor,
                   shift: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                   mean: torch.Tensor, nbins: int) -> TilesAB:
    """What K4 returns, in plain PyTorch: :func:`tiles_plain`'s six outputs
    then :func:`hist.histogram_plain`'s (hist (C, nbins) i32, dev (C,)
    f32) on the provisional ``lo``/``hi``/``mean``."""
    return (tiles_plain(xt, row_valid, shift)
            + khist.histogram_plain(xt, row_valid, lo, hi, mean, nbins))


def update_plain(mom: Dict[str, torch.Tensor], co: Dict[str, torch.Tensor],
                 xt: torch.Tensor, row_valid: torch.Tensor):
    """The plain PyTorch version of :func:`update` (K1's and K3's plain
    versions are one function)."""
    sums, counts, P, S1, S2, N = tiles_plain(xt, row_valid, mom["shift"])
    return _fold_mom(mom, sums, counts), _fold_corr(co, P, S1, S2, N)


def spearman_update_plain(co: Dict[str, torch.Tensor], xt: torch.Tensor,
                          row_valid: torch.Tensor, grid: torch.Tensor):
    """The plain PyTorch version of :func:`spearman_update`."""
    return _fold_corr(co, *spear_tiles_plain(xt, row_valid, grid))


def spearman_update_wide_plain(co: Dict[str, torch.Tensor],
                               ranks_t: torch.Tensor,
                               row_valid: torch.Tensor):
    """The plain PyTorch version of :func:`spearman_update_wide`."""
    tiles = tiles_wide_plain(ranks_t, row_valid, _half(ranks_t),
                             skip_stats=True)
    return _fold_corr(co, *tiles[2:])


# ---------------------------------------------------------------------------
# kernels K1, K3, K5, K6, K4
# ---------------------------------------------------------------------------

def _bind_common(lib: ctypes.CDLL) -> None:
    lib.tpt_error_string.argtypes = [ctypes.c_int]
    lib.tpt_error_string.restype = ctypes.c_char_p


def _bind_gram(lib: ctypes.CDLL) -> None:
    _bind_common(lib)
    for fn in (lib.tpt_tc_tile, lib.tpt_tc_rows):
        fn.argtypes = []
        fn.restype = ctypes.c_int


def _bind(lib: ctypes.CDLL) -> None:
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    _bind_gram(lib)
    lib.tpt_fused_a.argtypes = [p, p, p, i32, i64, i32, i64, i32, i64,
                                p, p, p, p, p, p, p, p, p, p]
    lib.tpt_fused_a.restype = ctypes.c_int


def _bind_wide(lib: ctypes.CDLL) -> None:
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    _bind_gram(lib)
    lib.tpt_fused_wide.argtypes = [p, p, p, i32, i64, i32, i32, i64, i32,
                                   i64, p, p, p, p, p, p, p, p, p, p]
    lib.tpt_fused_wide.restype = ctypes.c_int


def _bind_max_grid(lib: ctypes.CDLL) -> None:
    lib.tpt_max_grid.argtypes = []
    lib.tpt_max_grid.restype = ctypes.c_int
    if lib.tpt_max_grid() != MAX_SPEAR_GRID:
        raise RuntimeError("grid_rank.cuh MAX_GRID disagrees with "
                           "tpuprof_torch.config.MAX_SPEAR_GRID")


def _bind_spear(lib: ctypes.CDLL) -> None:
    p, i32, i64, f32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                        ctypes.c_float)
    _bind_gram(lib)
    _bind_max_grid(lib)
    lib.tpt_spear.argtypes = [p, p, p, i32, i64, i32, f32, i32, i64,
                              p, p, p, p, p, p, p, p]
    lib.tpt_spear.restype = ctypes.c_int


def _bind_rank(lib: ctypes.CDLL) -> None:
    p, i32, i64, f32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                        ctypes.c_float)
    _bind_common(lib)
    _bind_max_grid(lib)
    lib.tpt_rank.argtypes = [p, p, p, i32, i64, i32, f32, p, p]
    lib.tpt_rank.restype = ctypes.c_int


def splits(C: int, R: int, tile: int, tr: int,
           max_gram_splits: Optional[int] = None
           ) -> Tuple[int, int, int, int]:
    """(stat_splits, stat_rows, gram_splits, gram_rows): the fixed row
    partition of one batch, for a Gram kernel with ``tile``-column output
    tiles that reads ``tr`` rows per chunk.  The Gram (``gram_tc``) runs
    one block per pair of tiles of the upper triangle, T (T + 1) / 2 of
    them for T = ceil(C / tile) (``tpt_tc_tile`` / ``tpt_tc_rows`` of the
    built library), and its splits fill at most ``_TARGET_BLOCKS``.  The
    statistics take K2's partition (:func:`hist.splits`), so K4 folds its
    statistics and its MAD partials as K1 and K2 do.  ``max_gram_splits``
    caps the Gram splits, never below what keeps each split under 2^20
    rows.  It depends only on the shape, so the partial sums, and their
    fold order, are the same on every run."""
    stat_s, stat_rows = khist.splits(C, R)
    t = -(-C // tile)
    # gram_tc holds one block per SM: round down, so no wave is left with
    # a stray block
    gram_s = _TARGET_BLOCKS // max(t * (t + 1) // 2, 1)
    gram_s = max(1, min(gram_s, -(-R // tr)))
    if max_gram_splits is not None:
        gram_s = min(gram_s, max_gram_splits)
    gram_s = max(gram_s, -(-R // _MAX_SPLIT_ROWS))
    gram_rows = -(-max(-(-R // gram_s), 1) // tr) * tr
    gram_s = max(-(-R // gram_rows), 1)
    return stat_s, stat_rows, gram_s, gram_rows


def _lib_splits(C: int, R: int, lib: ctypes.CDLL
                ) -> Tuple[int, int, int, int]:
    """:func:`splits` as every Gram kernel runs it at C columns (K1, K3,
    K4, K5): one partition a width, so K4 equals K1 then K2 and K5 equals
    K6 then K3 bit for bit.  The cap on K3's scratch binds only past
    ``MAX_FUSED_COLS``, where K3 is the only Gram kernel of the main
    path.  The uncapped branch serves K3 at ``MAX_FUSED_COLS`` columns or
    fewer, which only ``chip_smoke.py`` and the ``cuda``-marked test run,
    to hold K5 bit for bit against K6 then K3."""
    cap = _WIDE_MAX_GRAM_SPLITS if C > MAX_FUSED_COLS else None
    return splits(C, R, lib.tpt_tc_tile(), lib.tpt_tc_rows(),
                  max_gram_splits=cap)


def _check_batch(xt, row_valid) -> None:
    if xt.dtype != _F32 or xt.dim() != 2 or not xt.is_contiguous():
        raise ValueError("xt must be a contiguous (cols, rows) float32 "
                         f"tensor, got {xt.dtype} {tuple(xt.shape)}")
    R = xt.shape[1]
    if row_valid.dtype != torch.bool or tuple(row_valid.shape) != (R,) \
            or not row_valid.is_contiguous():
        raise ValueError(f"row_valid must be a contiguous ({R},) bool "
                         "tensor")
    if row_valid.device != xt.device:
        raise ValueError("xt and row_valid must share a device")
    if xt.shape[0] > MAX_FUSED_COLS_WIDE:
        raise ValueError(f"{xt.shape[0]} columns: {_WIDER}")


def _check_inputs(xt, row_valid, shift) -> None:
    _check_batch(xt, row_valid)
    C = xt.shape[0]
    if shift.dtype != _F32 or tuple(shift.shape) != (C,) \
            or not shift.is_contiguous():
        raise ValueError(f"shift must be a contiguous ({C},) float32 tensor")
    if shift.device != xt.device:
        raise ValueError("xt, row_valid and shift must share a device")


def _check_grid(xt, row_valid, grid) -> None:
    _check_batch(xt, row_valid)
    C = xt.shape[0]
    if grid.dtype != _F32 or grid.dim() != 2 or grid.shape[0] != C \
            or not grid.is_contiguous():
        raise ValueError(f"grid must be a contiguous ({C}, G) float32 "
                         "tensor")
    if not 1 <= grid.shape[1] <= MAX_SPEAR_GRID:
        raise ValueError(f"grid has {grid.shape[1]} points; the rank "
                         f"kernels take 1..{MAX_SPEAR_GRID}")
    if grid.device != xt.device:
        raise ValueError("xt, row_valid and grid must share a device")


def _narrow_only(C: int, what: str) -> None:
    if C > MAX_FUSED_COLS:
        raise ValueError(
            f"{what} takes at most {MAX_FUSED_COLS} columns, got {C}; "
            "wider tables take the column-tiled path")


def _need_cuda(xt, what: str) -> None:
    if not xt.is_cuda:
        raise ValueError(f"{what} needs CUDA tensors")


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _grams(C: int, dev) -> Grams:
    return (torch.empty((C, C), dtype=_F32, device=dev),
            torch.empty((C, C), dtype=_F32, device=dev),
            torch.empty((C, C), dtype=_F32, device=dev),
            torch.empty((C, C), dtype=_I32, device=dev))


def tiles_cuda(xt: torch.Tensor, row_valid: torch.Tensor,
               shift: torch.Tensor) -> Tiles:
    """Launch K1 on the current stream; same outputs as
    :func:`tiles_plain`."""
    global launches
    _check_inputs(xt, row_valid, shift)
    _narrow_only(xt.shape[0], "kernel K1")
    _need_cuda(xt, "tiles_cuda")
    lib = _k.library("fused_a", _bind)
    C, R = xt.shape
    dev = xt.device
    stat_s, stat_rows, gram_s, gram_rows = _lib_splits(C, R, lib)
    sums = torch.empty((C, 8), dtype=_F32, device=dev)
    counts = torch.empty((C, 8), dtype=_I32, device=dev)
    P, S1, S2, N = _grams(C, dev)
    if C == 0:
        return sums, counts, P, S1, S2, N
    psums = torch.empty((C * stat_s * 8,), dtype=_F32, device=dev)
    pcounts = torch.empty((C * stat_s * 4,), dtype=_I32, device=dev)
    partial = torch.empty((gram_s * 4 * C * C,), dtype=_F32, device=dev)
    with torch.cuda.device(dev):
        status = lib.tpt_fused_a(
            xt.data_ptr(), row_valid.data_ptr(), shift.data_ptr(), C, R,
            stat_s, stat_rows, gram_s, gram_rows, psums.data_ptr(),
            pcounts.data_ptr(), partial.data_ptr(), sums.data_ptr(),
            counts.data_ptr(), P.data_ptr(), S1.data_ptr(), S2.data_ptr(),
            N.data_ptr(), _stream(dev))
    launches += 1
    _k.check(status, "fused_a (K1)", lib)
    return sums, counts, P, S1, S2, N


def tiles_wide_cuda(xt: torch.Tensor, row_valid: torch.Tensor,
                    shift: torch.Tensor, skip_stats: bool = False) -> Tiles:
    """Launch K3 on the current stream; same outputs as
    :func:`tiles_wide_plain`."""
    global launches_wide
    _check_inputs(xt, row_valid, shift)
    _need_cuda(xt, "tiles_wide_cuda")
    lib = _k.library("fused_wide", _bind_wide)
    C, R = xt.shape
    dev = xt.device
    stat_s, stat_rows, gram_s, gram_rows = _lib_splits(C, R, lib)
    sums = torch.empty((C, 8), dtype=_F32, device=dev)
    counts = torch.empty((C, 8), dtype=_I32, device=dev)
    P, S1, S2, N = _grams(C, dev)
    if C == 0:
        return sums, counts, P, S1, S2, N
    n_stat = 0 if skip_stats else C * stat_s
    psums = torch.empty((n_stat * 8,), dtype=_F32, device=dev)
    pcounts = torch.empty((n_stat * 4,), dtype=_I32, device=dev)
    partial = torch.empty((gram_s * 4 * C * C,), dtype=_F32, device=dev)
    with torch.cuda.device(dev):
        status = lib.tpt_fused_wide(
            xt.data_ptr(), row_valid.data_ptr(), shift.data_ptr(), C, R,
            int(skip_stats), stat_s, stat_rows, gram_s, gram_rows,
            psums.data_ptr(), pcounts.data_ptr(), partial.data_ptr(),
            sums.data_ptr(), counts.data_ptr(), P.data_ptr(), S1.data_ptr(),
            S2.data_ptr(), N.data_ptr(), _stream(dev))
    launches_wide += 1
    _k.check(status, "fused_wide (K3)", lib)
    return sums, counts, P, S1, S2, N


def spear_tiles_cuda(xt: torch.Tensor, row_valid: torch.Tensor,
                     grid: torch.Tensor) -> Grams:
    """Launch K5 on the current stream; same outputs as
    :func:`spear_tiles_plain`, bit for bit those of :func:`rank_cuda`
    then :func:`tiles_wide_cuda` with ``skip_stats`` on the same inputs.
    ``grid`` rows must be nondecreasing (the backend checks the grid it
    builds)."""
    global launches_spear
    _check_grid(xt, row_valid, grid)
    _narrow_only(xt.shape[0], "kernel K5")
    _need_cuda(xt, "spear_tiles_cuda")
    lib = _k.library("spear", _bind_spear)
    C, R = xt.shape
    G = grid.shape[1]
    dev = xt.device
    _, _, gram_s, gram_rows = _lib_splits(C, R, lib)
    P, S1, S2, N = _grams(C, dev)
    if C == 0:
        return P, S1, S2, N
    ranks = torch.empty_like(xt)
    partial = torch.empty((gram_s * 4 * C * C,), dtype=_F32, device=dev)
    with torch.cuda.device(dev):
        status = lib.tpt_spear(
            xt.data_ptr(), row_valid.data_ptr(), grid.data_ptr(), C, R, G,
            _rank_scale(G), gram_s, gram_rows, _half(xt).data_ptr(),
            ranks.data_ptr(), partial.data_ptr(), P.data_ptr(),
            S1.data_ptr(), S2.data_ptr(), N.data_ptr(), _stream(dev))
    launches_spear += 1
    _k.check(status, "spear (K5)", lib)
    return P, S1, S2, N


def rank_cuda(xt: torch.Tensor, row_valid: torch.Tensor,
              grid: torch.Tensor) -> torch.Tensor:
    """Launch K6 on the current stream; same output as
    :func:`rank_transform_plain`.  ``grid`` rows must be nondecreasing."""
    global launches_rank
    _check_grid(xt, row_valid, grid)
    _need_cuda(xt, "rank_cuda")
    lib = _k.library("rank", _bind_rank)
    C, R = xt.shape
    G = grid.shape[1]
    out = torch.empty_like(xt)
    if C == 0:
        return out
    with torch.cuda.device(xt.device):
        status = lib.tpt_rank(
            xt.data_ptr(), row_valid.data_ptr(), grid.data_ptr(), C, R, G,
            _rank_scale(G), out.data_ptr(), _stream(xt.device))
    launches_rank += 1
    _k.check(status, "rank (K6)", lib)
    return out


def _bind_ab(lib: ctypes.CDLL) -> None:
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    _bind_gram(lib)
    lib.tpt_fused_ab.argtypes = [p, p, p, p, p, p, i32, i64, i32, i32, i64,
                                 i32, i64, p, p, p, p, p, p, p, p, p, p, p,
                                 p, p]
    lib.tpt_fused_ab.restype = ctypes.c_int
    lib.tpt_fused_ab_max_bins.restype = ctypes.c_int
    if lib.tpt_fused_ab_max_bins() != khist.SHARED_MAX_BINS:
        raise RuntimeError("hist.cuh HIST_MAX_BINS disagrees with "
                           "tpuprof_torch/kernels/hist.py")


def _check_ab(xt, row_valid, shift, lo, hi, mean, nbins,
              kernel: str = "cumulative") -> None:
    _check_inputs(xt, row_valid, shift)
    khist.check_inputs(xt, row_valid, lo, hi, mean, nbins, kernel)
    _narrow_only(xt.shape[0], "kernel K4")
    if nbins > khist.SHARED_MAX_BINS:
        raise ValueError(
            f"kernel K4 counts at most {khist.SHARED_MAX_BINS} bins in "
            f"shared memory, got {nbins}; more bins take K1 then K2")


def tiles_ab_cuda(xt: torch.Tensor, row_valid: torch.Tensor,
                  shift: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                  mean: torch.Tensor, nbins: int) -> TilesAB:
    """Launch K4 on the current stream; same outputs as
    :func:`tiles_ab_plain`, bit for bit those of :func:`tiles_cuda` then
    :func:`hist.histogram_cuda` on the same inputs."""
    global launches_ab
    _check_ab(xt, row_valid, shift, lo, hi, mean, nbins)
    _need_cuda(xt, "tiles_ab_cuda")
    lib = _k.library("fused_ab", _bind_ab)
    C, R = xt.shape
    dev = xt.device
    stat_s, stat_rows, gram_s, gram_rows = _lib_splits(C, R, lib)
    sums = torch.empty((C, 8), dtype=_F32, device=dev)
    counts = torch.empty((C, 8), dtype=_I32, device=dev)
    P, S1, S2, N = _grams(C, dev)
    hcounts = torch.zeros((C, nbins), dtype=_I32, device=dev)
    absdev = torch.empty((C,), dtype=_F32, device=dev)
    if C == 0:
        return sums, counts, P, S1, S2, N, hcounts, absdev
    psums = torch.empty((C * stat_s * 8,), dtype=_F32, device=dev)
    pcounts = torch.empty((C * stat_s * 4,), dtype=_I32, device=dev)
    pdev = torch.empty((C * stat_s,), dtype=_F32, device=dev)
    partial = torch.empty((gram_s * 4 * C * C,), dtype=_F32, device=dev)
    with torch.cuda.device(dev):
        status = lib.tpt_fused_ab(
            xt.data_ptr(), row_valid.data_ptr(), shift.data_ptr(),
            lo.data_ptr(), hi.data_ptr(), mean.data_ptr(), C, R, nbins,
            stat_s, stat_rows, gram_s, gram_rows, psums.data_ptr(),
            pcounts.data_ptr(), pdev.data_ptr(), partial.data_ptr(),
            sums.data_ptr(), counts.data_ptr(), P.data_ptr(),
            S1.data_ptr(), S2.data_ptr(), N.data_ptr(), hcounts.data_ptr(),
            absdev.data_ptr(), _stream(dev))
    launches_ab += 1
    _k.check(status, "fused_ab (K4)", lib)
    return sums, counts, P, S1, S2, N, hcounts, absdev


# ---------------------------------------------------------------------------
# entry points and state folds
# ---------------------------------------------------------------------------

def _cpu_only(xt, what: str) -> None:
    if xt.device.type != "cpu":
        raise ValueError(f"no {what} path for device {xt.device}")


_halves: Dict[torch.device, torch.Tensor] = {}


def _half(xt: torch.Tensor) -> torch.Tensor:
    """One 0.5 a column of ``xt``: the shift of d = rank - 0.5.  On a CUDA
    device a view of one vector a device, copied from the host once, so
    no batch launches a fill."""
    if not xt.is_cuda:
        return torch.full((xt.shape[0],), 0.5, dtype=_F32)
    half = _halves.get(xt.device)
    if half is None:
        half = torch.full((MAX_FUSED_COLS_WIDE,), 0.5,
                          dtype=_F32).to(xt.device)
        _halves[xt.device] = half
    return half[:xt.shape[0]]


def update(mom: Dict[str, torch.Tensor], co: Dict[str, torch.Tensor],
           xt: torch.Tensor, row_valid: torch.Tensor):
    """Fold one batch into the moments and corr states (shifts pre-set):
    K1 (K3 past ``MAX_FUSED_COLS`` columns) for a CUDA tensor, the plain
    version for a CPU tensor."""
    _check_inputs(xt, row_valid, mom["shift"])
    if xt.is_cuda:
        if xt.shape[0] <= MAX_FUSED_COLS:
            tiles = tiles_cuda(xt, row_valid, mom["shift"])
        else:
            tiles = tiles_wide_cuda(xt, row_valid, mom["shift"])
        return _fold_mom(mom, tiles[0], tiles[1]), _fold_corr(co, *tiles[2:])
    _cpu_only(xt, "pass-A")
    return update_plain(mom, co, xt, row_valid)


@contextlib.contextmanager
def _full_f32():
    """float32 ``torch.matmul`` in full float32 whatever the caller set:
    ``allow_tf32`` off for the block, restored after (the port's no-TF32
    rule; the reference's ``precision=HIGHEST``)."""
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def update_xla(mom: Dict[str, torch.Tensor], co: Dict[str, torch.Tensor],
               xt: torch.Tensor, row_valid: torch.Tensor):
    """The reference's XLA twin (``tpuprof/kernels/fused.py``
    ``update_xla``): ``moments.update`` then ``corr.update`` of
    ``x = xt.T``, the pass-A fold of tables wider than
    ``MAX_FUSED_COLS_WIDE`` columns, on any device.  Not a kernel of the
    port: the reference computes it in XLA outside any Pallas kernel, and
    here it is PyTorch calls, the Gram's four products ``torch.matmul``.
    Those run in full float32 whatever the caller set
    (``allow_tf32`` off for the call, restored after), as the reference's
    ``precision=HIGHEST``.  Its temporaries are four (rows, cols) float32
    arrays (4.3 GB at 4,096 x 65,536)."""
    if xt.dim() != 2 or tuple(row_valid.shape) != (xt.shape[1],):
        raise ValueError("xt must be (cols, rows) and row_valid (rows,)")
    x = xt.T
    with _full_f32():
        return moments.update(mom, x, row_valid), corr.update(co, x,
                                                              row_valid)


def spearman_update(co: Dict[str, torch.Tensor], xt: torch.Tensor,
                    row_valid: torch.Tensor, grid: torch.Tensor):
    """Fold one batch of grid ranks into a corr state whose shift is 0.5
    (ranks lie in [0, 1]): K5 for a CUDA tensor, the plain version for a
    CPU tensor.  At most ``MAX_FUSED_COLS`` columns; wider
    tables take :func:`rank_transform` + :func:`spearman_update_wide`."""
    _check_grid(xt, row_valid, grid)
    _narrow_only(xt.shape[0], "spearman_update")
    if xt.is_cuda:
        return _fold_corr(co, *spear_tiles_cuda(xt, row_valid, grid))
    _cpu_only(xt, "Spearman")
    return spearman_update_plain(co, xt, row_valid, grid)


def rank_transform(xt: torch.Tensor, row_valid: torch.Tensor,
                   grid: torch.Tensor) -> torch.Tensor:
    """Stage 1 of the wide Spearman tier: (cols, rows) grid ranks in
    [0, 1], NaN where the value is not finite or the row not valid: K6 for
    a CUDA tensor, the plain version for a CPU tensor."""
    _check_grid(xt, row_valid, grid)
    if xt.is_cuda:
        return rank_cuda(xt, row_valid, grid)
    _cpu_only(xt, "rank")
    return rank_transform_plain(xt, row_valid, grid)


def exact_ranks(xt: torch.Tensor, row_valid: torch.Tensor,
                sorted_sample: torch.Tensor,
                kept: torch.Tensor) -> torch.Tensor:
    """The reference's exact rank tier (``mesh.py`` ``local_step_spear``):
    each value's rank in its column's sorted padded row sample,
    ``(left + right) * 0.5 / max(kept, 1)`` with ``left``/``right`` the
    two ``searchsorted`` sides, NaN where the value is not finite or the
    row not valid; (cols, rows) float32.  Not a kernel: batched
    ``torch.searchsorted`` with int32 indices (half the bytes of int64's:
    2.1 GB for both sides at 4,096 x 65,536)."""
    left = torch.searchsorted(sorted_sample, xt, out_int32=True)
    right = torch.searchsorted(sorted_sample, xt, out_int32=True,
                               right=True)
    denom = torch.clamp_min(kept, 1).to(_F32)[:, None]
    ranks = (left + right).to(_F32) * 0.5 / denom
    del left, right
    finite = row_valid[None, :] & torch.isfinite(xt)
    return torch.where(finite, ranks, float("nan"))


def spearman_update_exact(co: Dict[str, torch.Tensor], xt: torch.Tensor,
                          row_valid: torch.Tensor,
                          sorted_sample: torch.Tensor,
                          kept: torch.Tensor):
    """Fold one batch's :func:`exact_ranks` into the corr state with
    ``corr.update`` (full float32 products, as :func:`update_xla`)."""
    ranks = exact_ranks(xt, row_valid, sorted_sample, kept)
    with _full_f32():
        return corr.update(co, ranks.T, row_valid)


def spearman_update_wide(co: Dict[str, torch.Tensor], ranks_t: torch.Tensor,
                         row_valid: torch.Tensor):
    """Stage 2 of the wide Spearman tier: the Gram of ``ranks_t`` (NaN
    masked as a missing value) about 0.5 folded into ``co``: K3 with
    ``skip_stats`` for a CUDA tensor, the plain version for a CPU
    tensor."""
    half = _half(ranks_t)
    _check_inputs(ranks_t, row_valid, half)
    if ranks_t.is_cuda:
        tiles = tiles_wide_cuda(ranks_t, row_valid, half, skip_stats=True)
        return _fold_corr(co, *tiles[2:])
    _cpu_only(ranks_t, "Spearman")
    return spearman_update_wide_plain(co, ranks_t, row_valid)


def update_with_hist(mom: Dict[str, torch.Tensor],
                     co: Dict[str, torch.Tensor],
                     hstate: Dict[str, torch.Tensor], xt: torch.Tensor,
                     row_valid: torch.Tensor, lo: torch.Tensor,
                     hi: torch.Tensor, mean: torch.Tensor,
                     kernel: str = "cumulative"):
    """Fold one batch into the moments, corr and histogram states in one
    read, binning on the provisional ``lo``/``hi``/``mean``: K4 for a CUDA
    tensor (at most ``MAX_FUSED_AB_COLS`` columns), the plain version for a
    CPU tensor.  ``kernel`` names the reference's pass-B formulation (both
    give the same counts).  Returns ``(mom, co, hstate)``."""
    nbins = hstate["counts"].shape[1]
    _check_ab(xt, row_valid, mom["shift"], lo, hi, mean, nbins, kernel)
    if xt.is_cuda:
        tiles = tiles_ab_cuda(xt, row_valid, mom["shift"], lo, hi, mean,
                              nbins)
    else:
        _cpu_only(xt, "single-pass")
        tiles = tiles_ab_plain(xt, row_valid, mom["shift"], lo, hi, mean,
                               nbins)
    return (_fold_mom(mom, tiles[0], tiles[1]), _fold_corr(co, *tiles[2:6]),
            {"counts": hstate["counts"] + tiles[6],
             "abs_dev": hstate["abs_dev"] + tiles[7]})


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
