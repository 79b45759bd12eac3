"""Pass B: fixed-bin histograms and the exact-MAD numerator of one batch.

Counterpart of ``tpuprof/kernels/pallas_hist.py``.  :func:`histogram_batch`
takes ``xt`` (cols, rows) float32, ``row_valid`` (rows,) bool and the
per-column pass-A bounds ``lo``/``hi``/``mean``, and returns
((cols, nbins) int32 per-bin counts, (cols,) float32 sum |x - mean|):

* on a CUDA tensor it launches kernel K2 (``csrc/hist_b.cu``), which
  replaces the TPU kernel ``histogram_tiles``, in one of three bodies
  (any ``nbins >= 1``, as the reference takes): up to
  :data:`SHARED_MAX_BINS` bins each block counts in its own shared-memory
  histogram; past that, where :func:`cluster_plan` makes a plan, a
  column's histogram lives in the shared memory of a thread-block
  cluster (a copy in every block, summed over the cluster, where one
  fits a block; else spread over at most :data:`SPREAD_MAX` blocks); else
  the blocks count straight into the output in device memory;
* on a CPU tensor it runs :func:`histogram_plain`, the plain PyTorch
  version, which follows the reference's cumulative body.

A finite value lands in ``clip(floor((x - lo) * scale), 0, nbins - 1)``
with ``scale = nbins / max(hi - lo, 1e-30)`` in float32 — the reference's
recipe, :func:`bin_scale` here, which K2 repeats in its launch.  Both
``pass_b_kernel`` formulations of the reference give these same counts by
construction (``floor(t) >= b  <=>  t >= b``), so one kernel serves both.
``launches`` counts K2 launches, ``launches_cluster`` and
``launches_global`` those of them that took the cluster and the
device-memory body.
"""

from __future__ import annotations

import ctypes
import threading
from typing import NamedTuple, Optional, Tuple

import torch

from tpuprof_torch import kernels as _k

KERNELS = ("cumulative", "legacy")
# the bins K2's shared-memory body (and K4) count; K2 takes more in its
# cluster and device-memory bodies
SHARED_MAX_BINS = 8192
# the cluster body's budget, mirrored from csrc/hist.cuh (checked when the
# library is bound): blocks a cluster (past 8 a non-portable size), and
# the int32 words of shared memory a block holds (a block's 232,448 bytes
# of opt-in shared memory on sm_90 less the 1 KB MAD tree)
CLUSTER_MAX = 16
SLICE_MAX_BINS = 57856
# the most blocks a spread histogram takes: up to 3 it measured 2-4.8x
# faster than the device-memory body on a clean batch (within 1.2x on a
# one-bin one); past 3 it lost at 15 of the 18 shape and batch pairs
# measured (PERF.md, K2).  The cluster body's reach is so 3 slices
SPREAD_MAX = 3
CLUSTER_MAX_BINS = SPREAD_MAX * SLICE_MAX_BINS      # 173,568
# where the cluster body keeps a column's counts (csrc/hist_b.cu), in the
# C entry's numbering: a whole copy of the histogram in every block (two
# 16-bit counters a word, or one 32-bit), or one histogram spread over
# the cluster's blocks (bin b in block b % K at word b // K)
LAYOUTS = ("private16", "private32", "spread")

launches = 0            # K2 launches in this process (see module docstring)
launches_cluster = 0    # of them, launches of the cluster body
launches_global = 0     # of them, launches of the device-memory body
# the counts are read-modify-writes: serve workers launch from two threads
_count_lock = threading.Lock()

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
                               i32, i32, i32, i32, i32, p, p, p, p]
    lib.tpt_hist_b.restype = ctypes.c_int
    lib.tpt_error_string.argtypes = [ctypes.c_int]
    lib.tpt_error_string.restype = ctypes.c_char_p
    for fn, want in (("tpt_hist_b_max_bins", SHARED_MAX_BINS),
                     ("tpt_hist_b_cluster_max", CLUSTER_MAX),
                     ("tpt_hist_b_slice_max_bins", SLICE_MAX_BINS)):
        getattr(lib, fn).restype = ctypes.c_int
        if getattr(lib, fn)() != want:
            raise RuntimeError(f"hist.cuh disagrees with "
                               f"tpuprof_torch/kernels/hist.py: {fn}")


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


class ClusterPlan(NamedTuple):
    """How K2's cluster body covers one batch (:func:`cluster_plan`)."""
    cluster: int        # K: blocks of a cluster, all of one column
    splits: int         # S: row splits of a column (:func:`splits`)
    splits_pad: int     # S padded to a multiple of K; padding blocks walk
                        # no rows
    words: int          # int32 words of shared memory a block holds (a
                        # multiple of 4)
    layout: str         # one of LAYOUTS
    flush: str          # "store": one cluster holds the column, each bin
                        # written once; "atomic": onto a zeroed output


def _round4(n: int) -> int:
    return -(-n // 4) * 4


def cluster_plan(C: int, R: int, nbins: int,
                 split_cols: Optional[int] = None) -> Optional[ClusterPlan]:
    """The cluster body's plan for a batch of ``C`` columns, ``R`` rows
    and ``nbins`` bins, or None for the device-memory body.  The rows
    split as :func:`splits` splits them (the MAD's bits rest on it), and a
    cluster holds K = S of a column's splits (:data:`CLUSTER_MAX` past
    that, several clusters a column).  A private copy of the histogram in
    every block where one fits (:func:`_private_plan`; adds into a peer's
    shared memory cost several times more, PERF.md, K2), else one
    histogram spread over the cluster where it takes at most
    :data:`SPREAD_MAX` blocks (:func:`_spread_plan`; never past
    :data:`CLUSTER_MAX_BINS`)."""
    n_s, rows = splits(split_cols or C, R)
    return _private_plan(n_s, rows, nbins) or _spread_plan(n_s, nbins)


def _private_plan(n_s: int, rows: int, nbins: int) -> Optional[ClusterPlan]:
    """A whole copy of the histogram in every block of a cluster of
    min(S, :data:`CLUSTER_MAX`), summed over the cluster: 16-bit counters
    where a block counts fewer than 2**16 values, else 32-bit; None where
    the copy does not fit a block's :data:`SLICE_MAX_BINS` words."""
    packed = rows < 1 << 16
    words = _round4(-(-nbins // 2) if packed else nbins)
    if words > SLICE_MAX_BINS:
        return None
    return _plan(min(n_s, CLUSTER_MAX), n_s, words,
                 "private16" if packed else "private32")


def _spread_plan(n_s: int, nbins: int) -> Optional[ClusterPlan]:
    """One histogram spread over one cluster a column of K = max(S, the
    blocks whose slices hold ``nbins``) blocks, or None where K passes
    :data:`SPREAD_MAX`."""
    k = max(-(-nbins // SLICE_MAX_BINS), n_s)
    if k > SPREAD_MAX:
        return None
    return _plan(k, n_s, _round4(-(-nbins // k)), "spread")


def _plan(k: int, n_s: int, words: int, layout: str) -> ClusterPlan:
    pad = -(-n_s // k) * k
    return ClusterPlan(k, n_s, pad, words, layout,
                       "store" if pad == k else "atomic")


def histogram_cuda(xt: torch.Tensor, row_valid: torch.Tensor,
                   lo: torch.Tensor, hi: torch.Tensor, mean: torch.Tensor,
                   nbins: int, split_cols: Optional[int] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K2 on the current stream (its blocks form the scale
    :func:`bin_scale` computes, bit for bit); same outputs as
    :func:`histogram_plain`.  Past :data:`SHARED_MAX_BINS` bins the launch
    takes the cluster body on :func:`cluster_plan`'s plan, or the
    device-memory body where it makes none; the MAD bits of both are the
    shared body's.  A launch the card refuses raises: no body
    stands in for another.  The rows split as a batch of ``split_cols``
    columns does (default: ``xt``'s own): a re-bin of a few of a table's
    columns passes the table's width, so each column's MAD folds in the
    order the full-width pass folds it, bit for bit."""
    plan = cluster_plan(xt.shape[0], xt.shape[1], nbins, split_cols) \
        if nbins > SHARED_MAX_BINS else None
    return _launch(xt, row_valid, lo, hi, mean, nbins, split_cols, plan)


def _launch(xt, row_valid, lo, hi, mean, nbins: int,
            split_cols: Optional[int], plan: Optional[ClusterPlan]
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2 on ``plan``: the cluster body, or with None the shared body up
    to :data:`SHARED_MAX_BINS` bins and the device-memory body past it.
    The C entry refuses a plan it cannot launch, and this raises."""
    global launches, launches_cluster, launches_global
    if not xt.is_cuda:
        raise ValueError("histogram_cuda needs CUDA tensors")
    lib = _k.library("hist_b", _bind)
    C, R = xt.shape
    dev = xt.device
    n_s, rows = splits(split_cols or C, R)
    store = plan is not None and plan.flush == "store"
    # a store flush writes every bin once: no zero fill
    counts = (torch.empty if store else torch.zeros)(
        (C, nbins), dtype=torch.int32, device=dev)
    absdev = torch.empty((C,), dtype=torch.float32, device=dev)
    if C == 0:
        return counts, absdev
    pdev = torch.empty((C * n_s,), dtype=torch.float32, device=dev)
    k, pad, words, code = (plan.cluster, plan.splits_pad, plan.words,
                           LAYOUTS.index(plan.layout)) if plan \
        else (0, n_s, 0, 0)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = lib.tpt_hist_b(
            xt.data_ptr(), row_valid.data_ptr(), lo.data_ptr(),
            hi.data_ptr(), mean.data_ptr(), C, R, nbins, n_s, rows,
            k, pad, words, code, int(store),
            counts.data_ptr(), pdev.data_ptr(), absdev.data_ptr(), stream)
    _k.check(status, "hist_b (K2)", lib)
    with _count_lock:
        launches += 1
        if plan is not None:
            launches_cluster += 1
        elif nbins > SHARED_MAX_BINS:
            launches_global += 1
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
