"""Pass B: fixed-bin histograms and the exact-MAD numerator of one batch.

Counterpart of ``tpuprof/kernels/pallas_hist.py``.  :func:`histogram_batch`
takes ``xt`` (cols, rows) float32, ``row_valid`` (rows,) bool and the
per-column pass-A bounds ``lo``/``hi``/``mean``, and returns
((cols, nbins) int32 per-bin counts, (cols,) float32 sum |x - mean|):

* on a CUDA tensor it launches kernel K2 (``csrc/hist_b.cu``), which
  replaces the TPU kernel ``histogram_tiles``: up to
  :data:`SHARED_MAX_BINS` bins its blocks count in a shared-memory
  histogram, past that straight into the output in device memory (any
  ``nbins >= 1``, as the reference takes);
* on a CPU tensor it runs :func:`histogram_plain`, the plain PyTorch
  version, which follows the reference's cumulative body.

A finite value lands in ``clip(floor((x - lo) * scale), 0, nbins - 1)``
with ``scale = nbins / max(hi - lo, 1e-30)`` in float32 — the reference's
recipe, :func:`bin_scale` here, which K2 repeats in its launch.  Both
``pass_b_kernel`` formulations of the reference give these same counts by
construction (``floor(t) >= b  <=>  t >= b``), so one kernel serves both.
``launches`` counts K2 launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from tpuprof_torch import kernels as _k

KERNELS = ("cumulative", "legacy")
# the bins K2's shared-memory body (and K4) count; K2 takes more in its
# device-memory body
SHARED_MAX_BINS = 8192

launches = 0            # K2 launches in this process (see module docstring)

_TARGET_BLOCKS = 4 * 132
_THREADS = 256


def bin_scale(lo: torch.Tensor, hi: torch.Tensor, nbins: int) -> torch.Tensor:
    """float32 ``nbins / max(hi - lo, 1e-30)`` — the reference's scale,
    rounded the same way (one IEEE subtraction, clamp, one division)."""
    width = torch.clamp_min(hi - lo, 1e-30)
    # a true division: torch evaluates ``nbins / width`` as
    # ``reciprocal(width) * nbins``, which can round one ulp away
    return torch.div(torch.full_like(width, float(nbins)), width)


def histogram_plain(xt: torch.Tensor, row_valid: torch.Tensor,
                    lo: torch.Tensor, hi: torch.Tensor, mean: torch.Tensor,
                    nbins: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of :func:`histogram_batch`: cumulative
    >=-edge counts on ``t = (x - lo) * scale``, differenced per bin.  Each
    column's count of ``t >= b`` is its length less the count below ``b``
    in its sorted ``t`` (one ``searchsorted`` for every edge), so the
    version costs a sort, not a pass a bin."""
    from tpuprof_torch.kernels.histogram import counts_from_cumulative
    C, R = xt.shape
    scale = bin_scale(lo, hi, nbins)
    finite = row_valid[None, :] & torch.isfinite(xt)
    t = (xt - lo[:, None]) * scale[:, None]
    # -inf fails every >= compare: invalid values, and a NaN t (an inf
    # difference times a zero scale, or a NaN scale), count in no edge
    t = torch.where(finite & ~torch.isnan(t), t, float("-inf"))
    edges = torch.arange(1, nbins, dtype=torch.float32,
                         device=xt.device).expand(C, nbins - 1)
    below = torch.searchsorted(torch.sort(t, dim=1).values,
                               edges.contiguous())
    cum = torch.empty((C, nbins), dtype=torch.int32, device=xt.device)
    cum[:, 0] = finite.sum(1, dtype=torch.int32)
    cum[:, 1:] = (R - below).to(torch.int32)
    dev = row_sums(torch.where(finite, (xt - mean[:, None]).abs(), 0.0))
    return counts_from_cumulative(cum), dev


def row_sums(a: torch.Tensor) -> torch.Tensor:
    """Per-row float32 sums of ``a`` (C, R) whose bits do not depend on C:
    on the CPU, torch splits a lone long row across threads (another
    order), so a lone row is summed beside a zero row.  A re-bin of one
    column then gives the MAD numerator of the full-width pass."""
    if a.shape[0] == 1:
        return torch.cat([a, torch.zeros_like(a)]).sum(1)[:1]
    return a.sum(1)


def _bind(lib: ctypes.CDLL) -> None:
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.tpt_hist_b.argtypes = [p, p, p, p, p, i32, i64, i32, i32, i64,
                               p, p, p, p]
    lib.tpt_hist_b.restype = ctypes.c_int
    lib.tpt_hist_b_max_bins.restype = ctypes.c_int
    lib.tpt_error_string.argtypes = [ctypes.c_int]
    lib.tpt_error_string.restype = ctypes.c_char_p
    if lib.tpt_hist_b_max_bins() != SHARED_MAX_BINS:
        raise RuntimeError("hist.cuh HIST_MAX_BINS disagrees with "
                           "tpuprof_torch/kernels/hist.py")


def splits(C: int, R: int) -> Tuple[int, int]:
    """(splits, rows_per_split): the fixed row partition of a batch of ``C``
    columns and ``R`` rows into (column, row-split) blocks.  It depends
    only on the shape, so the partials fold in the same order on every
    run.  K2's MAD partials and the statistics of K1, K3 and K4 all use
    this one partition (``fused.splits``), which K4's identity with K1
    followed by K2 rests on."""
    s = max(1, min(-(-_TARGET_BLOCKS // max(C, 1)),
                   -(-R // (_THREADS * 16))))
    rows = max(-(-R // s), 1)
    return max(-(-R // rows), 1), rows


def histogram_cuda(xt: torch.Tensor, row_valid: torch.Tensor,
                   lo: torch.Tensor, hi: torch.Tensor, mean: torch.Tensor,
                   nbins: int, split_cols: Optional[int] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K2 on the current stream (its blocks form the scale
    :func:`bin_scale` computes, bit for bit); same outputs as
    :func:`histogram_plain`. Past :data:`SHARED_MAX_BINS` bins the launch
    takes K2's device-memory body, whose MAD bits are the shared body's.
    The rows split as a batch of ``split_cols`` columns does (default:
    ``xt``'s own): a re-bin of a few of a table's columns passes the
    table's width, so each column's MAD folds in the order the full-width
    pass folds it, bit for bit."""
    global launches
    if not xt.is_cuda:
        raise ValueError("histogram_cuda needs CUDA tensors")
    lib = _k.library("hist_b", _bind)
    C, R = xt.shape
    dev = xt.device
    counts = torch.zeros((C, nbins), dtype=torch.int32, device=dev)
    absdev = torch.empty((C,), dtype=torch.float32, device=dev)
    if C == 0:
        return counts, absdev
    n_s, rows = splits(split_cols or C, R)
    pdev = torch.empty((C * n_s,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = lib.tpt_hist_b(
            xt.data_ptr(), row_valid.data_ptr(), lo.data_ptr(),
            hi.data_ptr(), mean.data_ptr(), C, R, nbins, n_s, rows,
            counts.data_ptr(), pdev.data_ptr(), absdev.data_ptr(), stream)
    launches += 1
    _k.check(status, "hist_b (K2)", lib)
    return counts, absdev


def check_inputs(xt, row_valid, lo, hi, mean, nbins,
                 kernel: str = "cumulative",
                 split_cols: Optional[int] = None) -> None:
    """Raise ``ValueError`` on inputs K2 (and K4's binning) does not
    take."""
    if split_cols is not None and split_cols < 1:
        raise ValueError(f"split_cols must be >= 1, got {split_cols}")
    if kernel not in KERNELS:
        raise ValueError(f"unknown pass-B kernel {kernel!r} — use "
                         f"{list(KERNELS)}")
    if nbins < 1:
        raise ValueError(f"bins must be >= 1, got {nbins}")
    if xt.dtype != torch.float32 or xt.dim() != 2 or not xt.is_contiguous():
        raise ValueError("xt must be a contiguous (cols, rows) float32 "
                         f"tensor, got {xt.dtype} {tuple(xt.shape)}")
    C, R = xt.shape
    if row_valid.dtype != torch.bool or tuple(row_valid.shape) != (R,) \
            or not row_valid.is_contiguous():
        raise ValueError(f"row_valid must be a contiguous ({R},) bool "
                         "tensor")
    for name, v in (("lo", lo), ("hi", hi), ("mean", mean)):
        if v.dtype != torch.float32 or tuple(v.shape) != (C,) \
                or not v.is_contiguous():
            raise ValueError(f"{name} must be a contiguous ({C},) float32 "
                             "tensor")
    if any(v.device != xt.device for v in (row_valid, lo, hi, mean)):
        raise ValueError("histogram inputs must share a device")


def histogram_batch(xt: torch.Tensor, row_valid: torch.Tensor,
                    lo: torch.Tensor, hi: torch.Tensor, mean: torch.Tensor,
                    nbins: int, kernel: str = "cumulative",
                    split_cols: Optional[int] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One batch's per-bin counts and sum |x - mean|: K2 for a CUDA
    tensor, the plain version for a CPU tensor.  ``kernel`` names the
    reference formulation; both give the same counts.  ``split_cols``:
    see :func:`histogram_cuda` (the plain version's sums do not depend on
    it)."""
    check_inputs(xt, row_valid, lo, hi, mean, nbins, kernel, split_cols)
    if xt.is_cuda:
        return histogram_cuda(xt, row_valid, lo, hi, mean, nbins,
                              split_cols)
    if xt.device.type != "cpu":
        raise ValueError(f"no pass-B path for device {xt.device}")
    return histogram_plain(xt, row_valid, lo, hi, mean, nbins)
