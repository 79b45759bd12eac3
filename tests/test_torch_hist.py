"""Pass B of the PyTorch port (kernel K2's module) against the reference's
Pallas kernel.

``tpuprof_torch.kernels.hist.histogram_plain`` — the plain version K2 is
held to on the card — against ``tpuprof.kernels.pallas_hist.histogram_tiles
(..., interpret=True)`` for both of its formulations, on inputs with values
exactly on bin edges, denormals, constant and all-NaN columns, +-inf and
invalid rows.  Counts must match exactly; the MAD numerator within rtol
5e-4.  (The comparison is with the Pallas kernel, not the reference's XLA
twin, whose ``(x - lo) / width * bins`` rounds differently.)"""

import jax  # noqa: F401  (JAX stays on the CPU: tests/conftest.py)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuprof.kernels import histogram as ref_histogram
from tpuprof.kernels import pallas_hist
from tpuprof_torch.kernels import hist, histogram


def _inputs(cols, rows, nbins, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(10.0, 3.0, (cols, rows)).astype(np.float32)
    x[rng.random((cols, rows)) < 0.05] = np.nan
    x[rng.random((cols, rows)) < 0.02] = np.inf
    x[rng.random((cols, rows)) < 0.02] = -np.inf
    x[rng.random((cols, rows)) < 0.02] = np.float32(3e-41)   # denormal
    x[1] = 4.25                                  # constant column
    x[2] = np.nan                                # all-NaN column
    x[3] = rng.integers(0, 5, rows).astype(np.float32)   # few values
    x[4] = rng.normal(0.0, 1e-30, rows).astype(np.float32)  # tiny scale
    rv = np.ones(rows, dtype=bool)
    rv[-rows // 8:] = False
    fin = rv[None, :] & np.isfinite(x)
    v = np.where(fin, x, np.nan)
    with np.errstate(all="ignore"):
        lo = np.where(fin.any(1), np.nanmin(np.where(fin, v, np.inf), 1), 0)
        hi = np.where(fin.any(1), np.nanmax(np.where(fin, v, -np.inf), 1), 0)
        mean = np.where(fin.any(1), np.nansum(np.where(fin, v, 0), 1)
                        / np.maximum(fin.sum(1), 1), 0)
    lo, hi, mean = (a.astype(np.float32) for a in (lo, hi, mean))
    # values exactly on the bin edges (as the float32 linspace gives them)
    for c in (0, 3, 5):
        if c < cols:
            edges = np.linspace(lo[c], hi[c], nbins + 1).astype(np.float32)
            pos = rng.choice(rows - rows // 8, edges.size, replace=False)
            x[c, pos] = edges
    return x, rv, lo, hi, mean


def _both(x, rv, lo, hi, mean, nbins, kernel):
    rc, rd = pallas_hist.histogram_tiles(
        jnp.asarray(x), jnp.asarray(rv), jnp.asarray(lo), jnp.asarray(hi),
        jnp.asarray(mean), nbins, interpret=True, kernel=kernel)
    t = [torch.from_numpy(np.ascontiguousarray(a))
         for a in (x, rv, lo, hi, mean)]
    pc, pdv = hist.histogram_plain(*t, nbins)
    return (pc.numpy(), pdv.numpy()), (np.asarray(rc), np.asarray(rd))


@pytest.mark.parametrize("kernel", ["cumulative", "legacy"])
@pytest.mark.parametrize("nbins", [1, 10, 128])
def test_plain_matches_pallas_interpret(kernel, nbins):
    x, rv, lo, hi, mean = _inputs(9, 1200, nbins, seed=nbins)
    (pc, pd_), (rc, rd) = _both(x, rv, lo, hi, mean, nbins, kernel)
    np.testing.assert_array_equal(pc, rc)
    np.testing.assert_allclose(pd_, rd, rtol=5e-4, atol=0)


def test_denormal_column_counts_exact_and_mad_ieee():
    """A column living at the float32 normal/denormal boundary: counts
    equal the reference's; the MAD numerator follows IEEE denormals (the
    reference's XLA CPU backend flushes denormal results to zero, so its
    numerator is held to a float64 computation instead — ROADMAP Queue 3)."""
    x, rv, lo, hi, mean = _inputs(9, 1200, 10, seed=10)
    rng = np.random.default_rng(0)
    x[4] = rng.normal(0.0, 1e-38, x.shape[1]).astype(np.float32)
    fin = rv & np.isfinite(x[4])
    lo[4], hi[4] = x[4][fin].min(), x[4][fin].max()
    mean[4] = np.float32(x[4][fin].astype(np.float64).mean())
    (pc, pd_), (rc, _) = _both(x, rv, lo, hi, mean, 10, "cumulative")
    np.testing.assert_array_equal(pc, rc)
    exact = np.abs(x[4][fin].astype(np.float64) - np.float64(mean[4])).sum()
    np.testing.assert_allclose(pd_[4], exact, rtol=5e-4)


def test_entry_point_serves_both_formulations():
    x, rv, lo, hi, mean = _inputs(6, 700, 10, seed=5)
    t = [torch.from_numpy(np.ascontiguousarray(a))
         for a in (x, rv, lo, hi, mean)]
    a = hist.histogram_batch(*t, 10, kernel="cumulative")
    b = hist.histogram_batch(*t, 10, kernel="legacy")
    c = hist.histogram_plain(*t, 10)
    for u, v in zip(a, b):
        assert torch.equal(u, v)
    for u, v in zip(a, c):
        assert torch.equal(u, v)
    assert int(a[0].sum()) == int((t[1][None, :]
                                   & torch.isfinite(t[0])).sum())


def test_scale_is_the_reference_float32_recipe():
    rng = np.random.default_rng(1)
    lo = rng.normal(0, 100, 64).astype(np.float32)
    hi = lo + np.abs(rng.normal(0, 10, 64)).astype(np.float32)
    hi[:4] = lo[:4]                              # zero width -> 1e-30 clamp
    for nbins in (1, 7, 10, 128):
        ref = nbins / jnp.maximum(jnp.asarray(hi) - jnp.asarray(lo),
                                  1e-30).astype(jnp.float32)
        mine = hist.bin_scale(torch.from_numpy(lo), torch.from_numpy(hi),
                              nbins)
        assert mine.dtype == torch.float32
        np.testing.assert_array_equal(mine.numpy(), np.asarray(ref))


def test_counts_from_cumulative_matches_reference_on_adversarial():
    rng = np.random.default_rng(2)
    cum = rng.integers(0, 50, (7, 10)).astype(np.int32)   # not monotone
    cum[2] = 0
    cum[3] = np.sort(cum[3])[::-1]                        # well formed
    ref = np.asarray(ref_histogram.counts_from_cumulative(jnp.asarray(cum)))
    mine = histogram.counts_from_cumulative(torch.from_numpy(cum)).numpy()
    np.testing.assert_array_equal(mine, ref)
    assert (mine >= 0).all()


@pytest.mark.parametrize("bad", ["kernel", "bins", "dtype", "lo_shape"])
def test_histogram_batch_rejects_bad_inputs(bad):
    x, rv, lo, hi, mean = _inputs(6, 100, 10, seed=0)
    t = [torch.from_numpy(np.ascontiguousarray(a))
         for a in (x, rv, lo, hi, mean)]
    kw = {"kernel": "cumulative"}
    nbins = 10
    if bad == "kernel":
        kw["kernel"] = "scatter"
    elif bad == "bins":
        nbins = 0
    elif bad == "dtype":
        t[0] = t[0].double()
    else:
        t[2] = t[2][:-1]
    with pytest.raises(ValueError):
        hist.histogram_batch(*t, nbins, **kw)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("kernel K2 runs only on a CUDA device")
    return torch.device("cuda:0")


@pytest.mark.cuda
@pytest.mark.parametrize("nbins", [1, 10, 128])
def test_k2_matches_plain_on_card(cuda_device, nbins):
    x, rv, lo, hi, mean = _inputs(200, 65536, nbins, seed=nbins)
    t = [torch.from_numpy(np.ascontiguousarray(a)).to(cuda_device)
         for a in (x, rv, lo, hi, mean)]
    gc, gd = hist.histogram_cuda(*t, nbins)
    pc, pd_ = hist.histogram_plain(*t, nbins)
    torch.cuda.synchronize()
    assert torch.equal(gc, pc)
    np.testing.assert_allclose(gd.cpu().numpy(), pd_.cpu().numpy(),
                               rtol=5e-4)
