"""Past the kernels' limits: more than 2,048 numeric columns and more than
8,192 bins, in the PyTorch port against the JAX reference.

``describe`` of 2,056 numeric columns (NaN and +-inf lanes, a string
column) two-pass, fused and with ``spearman=True`` against one reference
run of the same frame (the reference's stats do not depend on its passes):
counts, min/max and histograms exact, moments at rtol 5e-4 / atol 1e-5,
rho at atol 5e-4.  At runner level the XLA twin's state against the
reference's ``update_xla`` on one batch, and the exact rank tier's ranks
bit for bit against the reference's ``searchsorted`` recipe;
``sorted_padded`` bit for bit; ``bins`` 9,000 and 16,384 (two-pass and
fused) against the reference with the counts exact; the route choices
(twin, exact tier, paired K1 + K2 past K4's bins, the staging cap).  K2's
device-memory body runs only on the card (the ``cuda``-marked test)."""

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import tpuprof_torch
from tpuprof import ProfilerConfig as RefConfig
from tpuprof.backends.tpu import TPUStatsBackend
from tpuprof.ingest.sample import RowSampler as RefSampler
from tpuprof.kernels import corr as ref_corr
from tpuprof.kernels import fused as ref_fused
from tpuprof.kernels import histogram as ref_histogram
from tpuprof.kernels import moments as ref_moments
from tpuprof_torch import ProfilerConfig
from tpuprof_torch.backends import gpu
from tpuprof_torch.ingest.sample import RowSampler
from tpuprof_torch.kernels import corr, fused, hist, moments
from tpuprof_torch.report.export import stats_to_json
from tpuprof_torch.runtime.runner import Runner, state_to_numpy
from torch_route import same_hash_route  # noqa: F401  (autouse)

RTOL, ATOL, ATOL_RHO = 5e-4, 1e-5, 5e-4
N_WIDE = 2056
MOMENTS = ("mean", "std", "variance", "sum", "mad", "skewness", "kurtosis")


def _wide_frame(n=512, cols=N_WIDE, seed=0):
    rng = np.random.default_rng(seed)
    data = rng.normal(0.0, 1.0, (n, cols)) \
        * np.linspace(1.0, 20.0, cols)[None, :] \
        + np.linspace(-100.0, 100.0, cols)[None, :]
    data[:, :8] += 30.0 * rng.normal(0.0, 1.0, n)[:, None]
    data[rng.random((n, cols)) < 0.03] = np.nan
    data[rng.random((n, cols)) < 0.002] = np.inf
    data[rng.random((n, cols)) < 0.002] = -np.inf
    df = pd.DataFrame(data.astype(np.float32),
                      columns=[f"w{i:04d}" for i in range(cols)])
    df["label"] = rng.choice(["p", "q", "r", None], n)
    return df


@pytest.fixture(scope="module")
def wide_df():
    return _wide_frame()


@pytest.fixture(scope="module")
def wide_ref(wide_df):
    return TPUStatsBackend().collect(
        wide_df, RefConfig(backend="tpu", batch_rows=256, spearman=True))


def _held(port, ref, methods):
    assert port["table"]["n"] == ref["table"]["n"]
    assert list(port["variables"]) == list(ref["variables"])
    n_num = 0
    for name, rv in ref["variables"].items():
        pv = port["variables"][name]
        assert pv["type"] == rv["type"], name
        for fld in ("count", "n_missing", "distinct_count"):
            assert pv[fld] == rv[fld], (name, fld)
        if rv["type"] != "NUM":
            continue
        n_num += 1
        for fld in ("n_zeros", "n_infinite", "min", "max"):
            assert pv[fld] == rv[fld], (name, fld)
        for fld in MOMENTS:
            assert np.isclose(pv[fld], rv[fld], rtol=RTOL, atol=ATOL,
                              equal_nan=True), (name, fld)
        np.testing.assert_array_equal(pv["histogram"][0],
                                      rv["histogram"][0], err_msg=name)
    assert n_num > fused.MAX_FUSED_COLS_WIDE
    for method in methods:
        a = port["correlations"][method]
        b = ref["correlations"][method]
        assert list(a.index) == list(b.index)
        np.testing.assert_allclose(a.to_numpy(), b.to_numpy(), rtol=0,
                                   atol=ATOL_RHO, equal_nan=True)
        assert bool(a.attrs.get("approx")) == bool(b.attrs.get("approx"))


@pytest.mark.parametrize("mode", ["two_pass", "fused", "spearman"])
def test_wide_describe_matches_reference(wide_df, wide_ref, mode):
    """2,056 numeric columns: pass A on the XLA twin, K2 for pass B (its
    plain version here), Spearman on the exact tier."""
    kw = {"profile_passes": "fused"} if mode == "fused" else \
        {"spearman": True} if mode == "spearman" else {}
    port = tpuprof_torch.describe(wide_df, device="cpu", batch_rows=256,
                                  **kw)
    _held(port, wide_ref,
          ("pearson", "spearman") if mode == "spearman" else ("pearson",))


def test_wide_fused_equals_two_pass_exactly(wide_df):
    two = tpuprof_torch.describe(wide_df, device="cpu", batch_rows=256)
    one = tpuprof_torch.describe(wide_df, device="cpu", batch_rows=256,
                                 profile_passes="fused")
    assert stats_to_json(one) == stats_to_json(two)


def _batch(rows, cols, seed):
    x = _wide_frame(rows, cols, seed).iloc[:, :cols].to_numpy(
        np.float32).copy()
    rv = np.ones(rows, dtype=bool)
    rv[-rows // 8:] = False
    return np.ascontiguousarray(x.T), rv


def test_twin_state_matches_reference_update_xla():
    """One batch of 2,050 columns through the port's twin and the
    reference's ``update_xla`` from the same shifted initial state."""
    C, R = 2050, 300
    xt, rv = _batch(R, C, seed=3)
    shift = np.nan_to_num(np.nanmean(np.where(np.isfinite(xt), xt, np.nan),
                                      axis=1)).astype(np.float32)
    rmom, rco = ref_moments.init(C), ref_corr.init(C)
    rmom["shift"] = rco["shift"] = jnp.asarray(shift)
    rco["set"] = jnp.ones((), dtype=jnp.int32)
    rm, rc = jax.device_get(ref_fused.update_xla(
        rmom, rco, jnp.asarray(xt), jnp.asarray(rv)))
    mom, co = moments.init(C), corr.init(C)
    mom["shift"] = torch.from_numpy(shift)
    co["shift"] = torch.from_numpy(shift.copy())
    co["set"].fill_(1)
    pm, pc = state_to_numpy(fused.update_xla(
        mom, co, torch.from_numpy(xt.copy()), torch.from_numpy(rv.copy())))
    for k in ("n", "n_zeros", "n_inf", "n_missing", "minv", "maxv", "fmin",
              "fmax"):
        np.testing.assert_array_equal(pm[k], np.asarray(rm[k]), err_msg=k)
    # the first batch's means become the shift: float sums, another order
    np.testing.assert_allclose(pm["shift"], np.asarray(rm["shift"]),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(pc["N"], np.asarray(rc["N"]))
    got, want = moments.finalize(pm), ref_moments.finalize(rm)
    for k in ("mean", "variance", "skewness", "kurtosis"):
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL,
                                   equal_nan=True, err_msg=k)
    np.testing.assert_allclose(corr.finalize(pc), ref_corr.finalize(rc),
                               rtol=0, atol=ATOL_RHO, equal_nan=True)


def _samplers(x, k=64, seed=4):
    port, ref = RowSampler(k, x.shape[1], seed=seed), \
        RefSampler(k, x.shape[1], seed=seed)
    for lo in range(0, len(x), 100):
        part = np.asfortranarray(x[lo:lo + 100])
        port.update(part, len(part))
        ref.update(part, len(part))
    return port, ref


def test_sorted_padded_is_the_reference_bit_for_bit():
    x = _wide_frame(500, 9, seed=5).iloc[:, :9].to_numpy(np.float32).copy()
    x[:, 2] = np.nan                            # nothing kept
    port, ref = _samplers(x)
    (ps, pk), (rs, rk) = port.sorted_padded(), ref.sorted_padded()
    assert ps.dtype == rs.dtype == np.float32
    np.testing.assert_array_equal(ps.view(np.int32), rs.view(np.int32))
    np.testing.assert_array_equal(pk, rk)
    assert pk[2] == 0 and np.isinf(ps[2]).all()


def test_exact_ranks_are_the_reference_recipe_bit_for_bit():
    """``fused.exact_ranks`` against the reference's exact tier
    (``mesh.py`` ``local_step_spear``: the two ``searchsorted`` sides,
    (left + right) * 0.5 / max(kept, 1), NaN off the finite valid
    values), written out with ``jnp`` as there."""
    C, R = 7, 400
    xt, rv = _batch(R, C, seed=6)
    xt[3] = 2.5                                 # ties everywhere
    port_s, _ = _samplers(np.ascontiguousarray(xt.T), k=50)
    srt, kept = port_s.sorted_padded()
    got = fused.exact_ranks(torch.from_numpy(xt), torch.from_numpy(rv),
                            torch.from_numpy(srt),
                            torch.from_numpy(kept.astype(np.int32)))
    x = jnp.asarray(xt).T
    sample = jnp.asarray(srt)
    left = jax.vmap(lambda a, v: jnp.searchsorted(a, v, side="left"))(
        sample, jnp.asarray(xt))
    right = jax.vmap(lambda a, v: jnp.searchsorted(a, v, side="right"))(
        sample, jnp.asarray(xt))
    denom = jnp.maximum(jnp.asarray(kept.astype(np.int32)), 1).astype(
        jnp.float32)[:, None]
    ranks = (left + right).astype(jnp.float32) * 0.5 / denom
    finite = jnp.asarray(rv)[:, None] & jnp.isfinite(x)
    want = np.asarray(jnp.where(finite, ranks.T, jnp.nan)).T
    np.testing.assert_array_equal(np.isnan(got.numpy()), np.isnan(want))
    np.testing.assert_array_equal(
        np.nan_to_num(got.numpy()).view(np.int32),
        np.nan_to_num(want).view(np.int32))


def _bins_frame(n=2000, seed=7):
    rng = np.random.default_rng(seed)
    df = pd.DataFrame({"a": rng.normal(0.0, 1.0, n),
                       "b": rng.exponential(3.0, n),
                       "c": rng.integers(-40, 40, n).astype(np.float64),
                       "d": rng.uniform(-1e3, 1e3, n)}).astype(np.float32)
    df.loc[rng.choice(n, 50, replace=False), "a"] = np.nan
    df.loc[rng.choice(n, 5, replace=False), "b"] = np.inf
    return df


@pytest.fixture(scope="module")
def bins_refs():
    df = _bins_frame()
    return df, {nb: TPUStatsBackend().collect(
        df, RefConfig(backend="tpu", batch_rows=500, bins=nb))
        for nb in (9000, 16384)}


def _recipe_counts(x, nbins):
    """Per-bin counts of the finite values of one column ``x`` on its own
    [min, max] under the two recipes: the port's and the reference's
    Pallas kernel's t = (x - lo) * (bins / width), and the reference's XLA
    tier's t = (x - lo) / width * bins (see
    :func:`test_reference_xla_tier_bins_by_division`)."""
    x = x[np.isfinite(x)].astype(np.float32)
    lo, hi = x.min(), x.max()
    width = np.maximum(np.float32(hi - lo), np.float32(1e-30))
    d = (x - lo).astype(np.float32)
    port_t = (d * np.float32(np.float32(nbins) / width)).astype(np.float32)
    ref_t = ((d / width).astype(np.float32) * np.float32(nbins)).astype(
        np.float32)

    def counts(t):
        b = np.clip(np.floor(t), 0, nbins - 1).astype(np.int64)
        return np.bincount(b, minlength=nbins)
    return counts(port_t), counts(ref_t)


@pytest.mark.parametrize("passes", ["two_pass", "fused"])
@pytest.mark.parametrize("nbins", [9000, 16384])
def test_bins_past_8192_match_reference(bins_refs, nbins, passes):
    """More bins than K2's shared histogram holds: the counts equal the
    reference's exactly, but for the values the reference's XLA tier bins
    one bin away (the standing difference of the two recipes: the counts
    differ by exactly the recipes' difference, column by column); the
    edges and MAD as the reference's; a fused run takes K1 then K2."""
    df, refs = bins_refs
    port = tpuprof_torch.describe(df, device="cpu", batch_rows=500,
                                  bins=nbins, profile_passes=passes)
    ref = refs[nbins]
    for name, rv in ref["variables"].items():
        pv = port["variables"][name]
        assert pv["type"] == rv["type"]
        if rv["type"] != "NUM":
            continue
        got, want = np.asarray(pv["histogram"][0]), \
            np.asarray(rv["histogram"][0])
        assert len(got) == nbins
        port_recipe, ref_recipe = _recipe_counts(
            df[name].to_numpy(np.float32), nbins)
        np.testing.assert_array_equal(got, port_recipe, err_msg=name)
        np.testing.assert_array_equal(want, ref_recipe, err_msg=name)
        np.testing.assert_array_equal(got - want, port_recipe - ref_recipe,
                                      err_msg=name)
        np.testing.assert_array_equal(pv["histogram"][1],
                                      rv["histogram"][1], err_msg=name)
        assert np.isclose(pv["mad"], rv["mad"], rtol=RTOL, atol=ATOL)


def test_bins_past_8192_fused_equals_two_pass(bins_refs):
    df, _ = bins_refs
    for nbins in (9000, 16384):
        two, one = (tpuprof_torch.describe(
            df, device="cpu", batch_rows=500, bins=nbins,
            profile_passes=p) for p in ("two_pass", "fused"))
        assert stats_to_json(one) == stats_to_json(two)


def test_histogram_batch_takes_any_bin_count():
    rng = np.random.default_rng(8)
    x = rng.normal(0, 1, (3, 700)).astype(np.float32)
    xt = torch.from_numpy(x)
    rv = torch.ones(700, dtype=torch.bool)
    lo, hi = xt.amin(1).contiguous(), xt.amax(1).contiguous()
    mean = xt.mean(1).contiguous()
    for nb in (hist.SHARED_MAX_BINS + 1, 20000):
        counts, _ = hist.histogram_batch(xt, rv, lo, hi, mean, nb)
        assert counts.shape == (3, nb) and int(counts.sum()) == 3 * 700
        scale = hist.bin_scale(lo, hi, nb)
        want = torch.clamp(torch.floor((xt - lo[:, None]) * scale[:, None]),
                           0, nb - 1).long()
        for c in range(3):
            np.testing.assert_array_equal(
                counts[c].numpy(), np.bincount(want[c].numpy(),
                                               minlength=nb))


def test_reference_xla_tier_bins_by_division():
    """A standing difference: the reference's XLA histogram tier (its CPU
    backend, and its TPU past 128 bins) bins t = (x - lo) / width * bins;
    its Pallas kernel, and the port at every bin count, bin
    t = (x - lo) * (bins / width).  A value within an ulp of an edge can
    land one bin apart; here is one."""
    nb = 9000
    lo, hi = np.float32(-187.9041), np.float32(-7.583903)
    x = np.float32(-114.83435)
    width = np.float32(hi - lo)
    port_t = np.float32(np.float32(x - lo) * np.float32(np.float32(nb)
                                                        / width))
    ref_t = np.float32(np.float32(np.float32(x - lo) / width) * nb)
    assert np.floor(port_t) == np.floor(ref_t) + 1
    xs = np.array([[x]], dtype=np.float32)
    counts, _ = hist.histogram_plain(
        torch.from_numpy(xs), torch.ones(1, dtype=torch.bool),
        torch.tensor([lo]), torch.tensor([hi]), torch.tensor([x]), nb)
    assert int(torch.argmax(counts[0])) == int(np.floor(port_t))
    st = ref_histogram.update_cumulative(
        ref_histogram.init(1, nb), jnp.asarray(xs), jnp.ones(1, bool),
        jnp.asarray([lo]), jnp.asarray([hi]), jnp.asarray([x]))
    assert int(np.argmax(np.asarray(st["counts"])[0])) == int(
        np.floor(ref_t))


def test_runner_routes_by_width_and_bins():
    wide = Runner(ProfilerConfig(bins=10), 2049, 0, "cpu")
    assert not wide.use_fused and not wide.spear_grid
    assert not wide.ab_combined
    st = wide.init_spearman()
    assert int(st["set"]) == 0                  # the exact tier's: unset
    narrow = Runner(ProfilerConfig(bins=10), 512, 0, "cpu")
    assert narrow.use_fused and narrow.spear_grid and narrow.ab_combined
    many = Runner(ProfilerConfig(bins=hist.SHARED_MAX_BINS + 1), 200, 0,
                  "cpu")
    assert many.use_fused and not many.ab_combined
    hstate = {"counts": torch.zeros((2, hist.SHARED_MAX_BINS + 1),
                                    dtype=torch.int32)}
    with pytest.raises(ValueError, match="K4"):
        fused.update_with_hist(
            {"shift": torch.zeros(2)}, {}, hstate, torch.zeros((2, 8)),
            torch.ones(8, dtype=torch.bool), torch.zeros(2), torch.ones(2),
            torch.zeros(2))


@pytest.mark.parametrize("cols,expect", [(200, 8), (1024, 3), (2048, 1),
                                         (4096, 1)])
def test_staged_group_is_capped_in_bytes(cols, expect):
    """8 batches a copy where they fit in STAGE_BYTES (1 GiB), fewer for
    wide tables, never fewer than one."""
    got = gpu.stage_group(8, 65536, cols, cols, with_hll=False)
    assert got == expect
    assert got * 65536 * (4 * cols + 1) <= gpu.STAGE_BYTES or got == 1


@pytest.mark.cuda
def test_k2_device_memory_body_on_the_card():
    """K2 past 8,192 bins against its plain version, and its MAD bits
    those of the shared body on the same batch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda:0")
    rng = np.random.default_rng(9)
    x = rng.normal(0, 1, (37, 65536)).astype(np.float32)
    xt = torch.from_numpy(x).to(dev)
    rv = torch.ones(65536, dtype=torch.bool, device=dev)
    lo, hi = xt.amin(1).contiguous(), xt.amax(1).contiguous()
    mean = xt.mean(1).contiguous()
    _, dev10 = hist.histogram_cuda(xt, rv, lo, hi, mean, 10)
    for nb in (16384, 65536):
        counts, dev_nb = hist.histogram_cuda(xt, rv, lo, hi, mean, nb)
        want, _ = hist.histogram_plain(xt, rv, lo, hi, mean, nb)
        assert torch.equal(counts, want)
        assert torch.equal(dev_nb.view(torch.int32), dev10.view(torch.int32))
