"""The order in which kernel K2 (``csrc/hist_b.cu``) sums its MAD
numerator, and its bin classes, modelled in numpy on the CPU.

The kernel itself needs the card.  What fixes its float32 bits is its
order of additions, modelled here step for step in numpy float32:

* one block of ``HIST_THREADS`` threads per (column, row-split) on the
  partition ``hist.splits(split_cols or C, R)``;
* each thread sums |x - mean| over its rows r0 + t + HIST_THREADS * k in
  that order, up to the split's end;
* the block's tree ``red[t] += red[t + stride]``, stride = 128, ..., 1;
* the column's partials folded in split order from 0.

The model is held to ``histogram_plain`` and to the reference's
interpret-mode ``histogram_tiles`` within rtol 5e-4, and bit for bit to
``chip_smoke.py``'s torch version (which holds the kernel to it on the
card).  A re-bin of a few columns with ``split_cols`` at the table's
width must give the full-width bits.  The block's one shared histogram
must cover every ``nbins`` from 1 to ``HIST_MAX_BINS`` within a launch's
shared memory, and the kernel's in-launch scale must be
``hist.bin_scale``'s float32 recipe.  The constants are read from
``hist.cuh`` itself, so the model follows the kernel's source.
"""

import importlib.util
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuprof.kernels import pallas_hist
from tpuprof_torch.kernels import hist

HIST_CUH = Path(hist.__file__).parent / "csrc" / "hist.cuh"
F32 = np.float32


def _cuh_constant(name: str) -> int:
    """``constexpr int <name> = <value>;`` in hist.cuh."""
    m = re.search(rf"constexpr int {name} = (\d+);", HIST_CUH.read_text())
    assert m, f"{name} not in {HIST_CUH}"
    return int(m.group(1))


THREADS = _cuh_constant("HIST_THREADS")
MAX_BINS = _cuh_constant("HIST_MAX_BINS")
# a launch without the opt-in attribute takes 48 KiB of shared memory;
# K4's block also holds K1's trees (8 + 4 floats/ints a thread) and the
# MAD tree (1 float a thread), static
LAUNCH_SMEM = 48 * 1024
K4_STATIC_SMEM = (8 + 4 + 1) * THREADS * 4 + 4


def mad_model(x, rv, mean, split_cols=None):
    """K2's sum |x - mean| of each column of ``x`` (C, R) over its valid,
    finite values, in the kernel's order of float32 additions."""
    C, R = x.shape
    n_s, rows = hist.splits(split_cols or C, R)
    fin = rv[None, :] & np.isfinite(x)
    with np.errstate(invalid="ignore"):
        v = np.where(fin, np.abs(x - mean[:, None]), F32(0)).astype(F32)
    acc = np.zeros(C, dtype=F32)
    for s in range(n_s):
        r0, r1 = s * rows, min(R, (s + 1) * rows)
        dev = np.zeros((C, THREADS), dtype=F32)
        for r in range(r0, r1, THREADS):
            r = r + np.arange(THREADS)
            ok = r < r1
            # a masked row adds nothing: +0.0 leaves a sum >= 0 as is
            dev += np.where(ok[None, :], v[:, np.minimum(r, R - 1)], F32(0))
        stride = THREADS // 2
        while stride:
            dev[:, :stride] += dev[:, stride:2 * stride]
            stride //= 2
        acc += dev[:, 0]
    return acc


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _inputs(cols, rows, seed):
    """NaN, +-inf, denormals, a constant, an all-NaN and a tiny-scale
    column, invalid tail rows; pass-A style bounds."""
    rng = np.random.default_rng(seed)
    x = rng.normal(10.0, 3.0, (cols, rows)).astype(F32)
    x[rng.random((cols, rows)) < 0.05] = np.nan
    x[rng.random((cols, rows)) < 0.02] = np.inf
    x[rng.random((cols, rows)) < 0.02] = -np.inf
    x[rng.random((cols, rows)) < 0.02] = F32(3e-41)
    x[1] = 4.25
    x[2] = np.nan
    x[4] = rng.normal(0.0, 1e-30, rows).astype(F32)
    rv = np.ones(rows, dtype=bool)
    rv[-rows // 8:] = False
    fin = rv[None, :] & np.isfinite(x)
    with np.errstate(all="ignore"):
        lo = np.where(fin.any(1), np.where(fin, x, np.inf).min(1), 0)
        hi = np.where(fin.any(1), np.where(fin, x, -np.inf).max(1), 0)
        mean = np.where(fin, x, 0).astype(np.float64).sum(1) \
            / np.maximum(fin.sum(1), 1)
    return x, rv, lo.astype(F32), hi.astype(F32), mean.astype(F32)


def _plain(x, rv, lo, hi, mean, nbins=10):
    return hist.histogram_plain(*(torch.from_numpy(np.ascontiguousarray(a))
                                  for a in (x, rv, lo, hi, mean)), nbins)


# (cols, rows): one split; five splits of 4,000 rows; ragged R (the last
# split and each thread's last group cut short)
SHAPES = [(9, 1200), (9, 20000), (7, 20003)]


@pytest.mark.parametrize("cols,rows", SHAPES)
def test_model_matches_plain_and_reference(cols, rows):
    x, rv, lo, hi, mean = _inputs(cols, rows, seed=rows)
    model = mad_model(x, rv, mean)
    _, plain = _plain(x, rv, lo, hi, mean)
    _, ref = pallas_hist.histogram_tiles(
        jnp.asarray(x), jnp.asarray(rv), jnp.asarray(lo), jnp.asarray(hi),
        jnp.asarray(mean), 10, interpret=True, kernel="cumulative")
    # column 4 lives near the denormals, which the reference's XLA CPU
    # flushes (ROADMAP Queue 3): it is held to the plain version only
    keep = np.arange(cols) != 4
    np.testing.assert_allclose(model, plain.numpy(), rtol=5e-4, atol=0)
    np.testing.assert_allclose(model[keep], np.asarray(ref)[keep],
                               rtol=5e-4, atol=0)


@pytest.mark.parametrize("cols,rows", SHAPES)
def test_chip_smoke_torch_model_is_this_model_bit_for_bit(cols, rows):
    x, rv, _, _, mean = _inputs(cols, rows, seed=rows + 1)
    got = _chip_smoke().mad_order(
        torch, torch.from_numpy(x), torch.from_numpy(rv),
        torch.from_numpy(mean))
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  mad_model(x, rv, mean).view(np.int32))


def test_rebin_subset_with_table_width_gives_full_width_bits():
    C, R = 200, 20000
    x, rv, _, _, mean = _inputs(C, R, seed=3)
    lanes = np.array([0, 5, 199])
    full = mad_model(x, rv, mean)
    sub = mad_model(x[lanes], rv, mean[lanes], split_cols=C)
    np.testing.assert_array_equal(sub.view(np.int32),
                                  full[lanes].view(np.int32))
    # without split_cols three columns split the rows otherwise
    assert hist.splits(3, R) != hist.splits(C, R)


def test_one_split_and_an_all_invalid_split():
    C, R = 9, 20000
    x, rv, lo, hi, mean = _inputs(C, R, seed=4)
    n_s, rows = hist.splits(C, R)
    assert n_s > 2
    rv[rows:2 * rows] = False                   # split 1 counts nothing
    model = mad_model(x, rv, mean)
    counts, plain = _plain(x, rv, lo, hi, mean)
    np.testing.assert_allclose(model, plain.numpy(), rtol=5e-4, atol=0)
    one = mad_model(x[:, :rows], rv[:rows], mean)
    assert hist.splits(C, rows)[0] == 1
    np.testing.assert_allclose(one, _plain(x[:, :rows], rv[:rows], lo, hi,
                                           mean)[1].numpy(), rtol=5e-4)
    assert int(counts.sum()) == int((rv[None, :] & np.isfinite(x)).sum())


def test_constants_match_the_wrapper():
    assert (THREADS, MAX_BINS) == (hist._THREADS, hist.SHARED_MAX_BINS)


def test_one_shared_histogram_covers_every_bin_count():
    """Each nbins in 1..HIST_MAX_BINS: the block's histogram of nbins
    words (every bin 0..nbins-1 a word) fits a launch's shared memory with
    K4's static trees beside it, and the bin of any value, clipped to
    [0, nbins - 1], lies in it."""
    edge = np.array([-np.inf, -1.0, 0.0, np.nan, 1e30, np.inf], dtype=F32)
    for nbins in range(1, MAX_BINS + 1):
        assert nbins * 4 + K4_STATIC_SMEM <= LAUNCH_SMEM, nbins
        b = _bin_of(edge, F32(0), F32(1), nbins)
        assert b.min() >= 0 and b.max() <= nbins - 1


def _count_model(b: np.ndarray, nbins: int) -> np.ndarray:
    """One block's counts of bins ``b`` (THREADS, K), -1 where masked, as
    the kernel adds them: thread t's values in its row order, each an
    increment of one shared word (integers: any order gives these)."""
    out = np.zeros(nbins, dtype=np.int64)
    for t in range(THREADS):
        for v in b[t]:
            if v >= 0:
                out[v] += 1
    return out


def _bin_of(x, lo, scale, nbins):
    """hist.cuh bin_of: t = (x - lo) * scale rounded twice, floor, NaN to
    bin 0, clipped."""
    with np.errstate(invalid="ignore", over="ignore"):
        t = ((x - lo) * scale).astype(F32)
        b = np.floor(t)
    return np.clip(np.nan_to_num(b, nan=0.0), 0, nbins - 1).astype(np.int64)


@pytest.mark.parametrize("nbins", [1, 9, 17, 31, 32, 33, 128, MAX_BINS])
def test_block_counts_equal_plain(nbins):
    """The block's counts with the in-launch scale, at the ragged bin
    counts past 8, 16 and 32 and at the limits, are histogram_plain's."""
    x, rv, lo, hi, mean = _inputs(6, THREADS * 40, seed=nbins)
    x[3] = lo[3]                                 # one bin a whole column
    counts, _ = _plain(x, rv, lo, hi, mean, nbins)
    scale = _device_scale(lo, hi, nbins)
    for c in range(x.shape[0]):
        fin = rv & np.isfinite(x[c])
        b = np.where(fin, _bin_of(x[c], lo[c], scale[c], nbins), -1)
        # thread t's rows t, t + THREADS, ... in order
        got = _count_model(b.reshape(-1, THREADS).T, nbins)
        np.testing.assert_array_equal(got, counts[c].numpy())


def _device_scale(lo, hi, nbins):
    """hist.cuh bin_scale: __fsub_rn, fmaxf with 1e-30f unless NaN,
    __fdiv_rn."""
    with np.errstate(all="ignore"):
        width = (hi - lo).astype(F32)
        width = np.where(np.isnan(width), width,
                         np.maximum(width, F32(1e-30))).astype(F32)
        return (F32(nbins) / width).astype(F32)


def test_in_launch_scale_is_bin_scale_bit_for_bit():
    rng = np.random.default_rng(8)
    lo = rng.normal(0, 100, 64).astype(F32)
    hi = lo + np.abs(rng.normal(0, 10, 64)).astype(F32)
    hi[:4] = lo[:4]                              # zero width
    hi[4:8] = lo[4:8] - 1                        # negative width
    lo[8], hi[8] = F32(-3e38), F32(3e38)         # width overflows to inf
    lo[9], hi[9] = np.inf, np.inf                # inf - inf = NaN kept
    lo[10], hi[10] = np.nan, F32(1)
    lo[11], hi[11] = F32(0), F32(1e-45)          # a denormal width
    for nbins in (1, 7, 10, 33, MAX_BINS):
        want = hist.bin_scale(torch.from_numpy(lo), torch.from_numpy(hi),
                              nbins).numpy()
        got = _device_scale(lo, hi, nbins)
        # NaN where bin_scale has NaN (its payload is the host's; any NaN
        # scale puts every value in bin 0), else the same bits
        nan = np.isnan(want)
        np.testing.assert_array_equal(np.isnan(got), nan)
        np.testing.assert_array_equal(got[~nan].view(np.int32),
                                      want[~nan].view(np.int32))
