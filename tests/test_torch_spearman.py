"""The Spearman rank pass of the PyTorch port against the JAX reference.

Kernel by kernel, the plain versions the card's kernels are held to:
K6's ranks (``rank_transform_plain``) against ``_rank_tiles(...,
interpret=True)`` bit for bit, K5's Gram (``spear_tiles_plain``) against
``spearman_update(..., interpret=True)``, the wide tier's composition
against the reference's and against the narrow tier; the CDF grid copy bit
for bit; and the whole narrow slice, ``describe(df, spearman=True)``,
against the reference's grid tier composed by hand (atol 5e-4), its CPU
exact tier and pandas (atol 0.02, the reference's grid-vs-exact
tolerance), and, without a second scan, its sample tier.  Tests that need
the card skip elsewhere."""

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
from tpuprof_torch.config import MAX_SPEAR_GRID, ProfilerConfig
from tpuprof_torch.ingest.sample import RowSampler
from tpuprof_torch.kernels import corr, fused
from tpuprof_torch.runtime.runner import spearman_grid
from torch_route import same_hash_route  # noqa: F401  (autouse)

RHO_ATOL = 5e-4
GRID_VS_EXACT = 0.02        # the reference's own (tests/test_fused.py)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _adversarial(rows, cols, n_grid, seed):
    """(xt (cols, rows), row_valid, grid (cols, G)): NaN, +-inf, invalid
    rows, values equal to grid points, an all-+inf grid column."""
    rng = np.random.default_rng(seed)
    x = rng.normal(10.0, 3.0, (rows, cols)).astype(np.float32)
    x[:, 1] = np.round(x[:, 1])                 # heavy ties
    sampler = RowSampler(4096, cols, seed=seed)
    sampler.update(x, rows)
    grid = sampler.cdf_grid(n_grid)
    grid[2] = np.inf                            # a column with no sample
    xt = np.ascontiguousarray(x.T)
    pick = rng.integers(0, n_grid, (cols, rows // 4))
    xt[:, : rows // 4] = np.take_along_axis(grid, pick, axis=1)   # ties
    xt[2, : rows // 4] = x[: rows // 4, 2]
    xt[rng.random((cols, rows)) < 0.05] = np.nan
    xt[rng.random((cols, rows)) < 0.02] = np.inf
    xt[rng.random((cols, rows)) < 0.02] = -np.inf
    rv = np.ones(rows, dtype=bool)
    rv[-max(rows // 10, 1):] = False
    return xt, rv, grid


def _ref_co(cols):
    co = ref_corr.init(cols)
    co["shift"] = jnp.full((cols,), 0.5, dtype=jnp.float32)
    co["set"] = jnp.ones((), dtype=jnp.int32)
    return co


def _port_co(cols):
    co = corr.init(cols)
    co["shift"].fill_(0.5)
    co["set"].fill_(1)
    return co


# ---------------------------------------------------------------------------
# K6: ranks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_grid", [16, 100, 256])
def test_rank_plain_bit_identical_to_pallas_interpret(n_grid):
    xt, rv, grid = _adversarial(300, 5, n_grid, seed=n_grid)
    ref = np.asarray(ref_fused._rank_tiles(
        jnp.asarray(xt), jnp.asarray(rv), jnp.asarray(grid),
        interpret=True))
    got = fused.rank_transform_plain(_t(xt), _t(rv), _t(grid)).numpy()
    np.testing.assert_array_equal(got, ref)
    assert np.isnan(got[:, -1]).all()           # invalid rows
    assert (got[2][np.isfinite(got[2])] == 0.0).all()   # all-+inf grid
    np.testing.assert_array_equal(
        fused.rank_transform(_t(xt), _t(rv), _t(grid)).numpy(), ref)


def test_rank_scale_is_the_reference_float32_constant():
    """Every count sum 0..2G times the port's float32(0.5 / G) is the
    reference's float32 count times its weak-typed 0.5 / G."""
    for g in (3, 7, 100, 255, 256):
        counts = np.arange(2 * g + 1, dtype=np.float32)
        ref = np.asarray(jnp.asarray(counts) * (0.5 / g))
        got = torch.from_numpy(counts) * torch.tensor(fused._rank_scale(g),
                                                      dtype=torch.float32)
        np.testing.assert_array_equal(got.numpy(), ref)


# ---------------------------------------------------------------------------
# K5: narrow Spearman Gram in one read
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cols", [5, 37])
def test_spear_plain_matches_pallas_interpret(cols):
    xt, rv, grid = _adversarial(400, cols, 64, seed=cols)
    ref = ref_fused.spearman_update(_ref_co(cols), jnp.asarray(xt),
                                    jnp.asarray(rv), jnp.asarray(grid),
                                    interpret=True)
    got = fused.spearman_update_plain(_port_co(cols), _t(xt), _t(rv),
                                      _t(grid))
    np.testing.assert_array_equal(got["N"].numpy(), np.asarray(ref["N"]))
    for k in ("P", "S1", "S2"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   rtol=5e-4, atol=1e-5, err_msg=k)
    np.testing.assert_allclose(corr.finalize(got),
                               ref_corr.finalize(jax.device_get(ref)),
                               rtol=0, atol=RHO_ATOL, equal_nan=True)
    same = fused.spearman_update(_port_co(cols), _t(xt), _t(rv), _t(grid))
    for k in got:
        assert torch.equal(got[k], same[k]), k


# ---------------------------------------------------------------------------
# the wide tier: K6 then K3 with skip_stats
# ---------------------------------------------------------------------------

# 37 and 200: K5's widths, where the card runs K5 as K6 then K3's Gram;
# 300 > 256: multi-tile
@pytest.mark.parametrize("cols", [5, 37, 200, 300])
def test_wide_composition_matches_reference_and_narrow(cols):
    rng = np.random.default_rng(1)
    n = 600
    base = rng.normal(0, 1, n)
    x = np.stack([base + rng.normal(0, 0.5, n) * ((c % 7) + 1)
                  for c in range(cols)], axis=1).astype(np.float32)
    x[rng.random((n, cols)) < 0.05] = np.nan
    rv = np.ones(n, dtype=bool)
    rv[-20:] = False
    sampler = RowSampler(4096, cols)
    sampler.update(x, n)
    grid = sampler.cdf_grid(128)
    xt = np.ascontiguousarray(x.T)

    ranks = fused.rank_transform_plain(_t(xt), _t(rv), _t(grid))
    wide = fused.spearman_update_wide_plain(_port_co(cols), ranks, _t(rv))
    rranks = ref_fused.rank_transform(jnp.asarray(xt), jnp.asarray(rv),
                                      jnp.asarray(grid), interpret=True)
    np.testing.assert_array_equal(ranks.numpy(), np.asarray(rranks))
    rwide = ref_fused.spearman_update_wide(_ref_co(cols), rranks,
                                           jnp.asarray(rv), interpret=True)
    np.testing.assert_array_equal(wide["N"].numpy(), np.asarray(rwide["N"]))
    np.testing.assert_allclose(corr.finalize(wide),
                               ref_corr.finalize(jax.device_get(rwide)),
                               rtol=0, atol=RHO_ATOL, equal_nan=True)
    narrow = fused.spearman_update_plain(_port_co(cols), _t(xt), _t(rv),
                                         _t(grid))
    assert torch.equal(wide["N"], narrow["N"])
    np.testing.assert_allclose(corr.finalize(wide), corr.finalize(narrow),
                               rtol=0, atol=1e-5, equal_nan=True)
    routed = fused.spearman_update_wide(
        _port_co(cols), fused.rank_transform(_t(xt), _t(rv), _t(grid)),
        _t(rv))
    for k in wide:
        assert torch.equal(wide[k], routed[k]), k


# ---------------------------------------------------------------------------
# host: the CDF grid
# ---------------------------------------------------------------------------

def test_cdf_grid_and_sample_spearman_are_the_reference_bits():
    rng = np.random.default_rng(8)
    x = rng.gamma(2.0, 3.0, (5000, 4)).astype(np.float32)
    x[rng.random((5000, 4)) < 0.1] = np.nan
    x[:, 3] = np.nan                            # no finite sample
    x[:, 2] = np.round(x[:, 2])                 # ties
    mine, ref = RowSampler(512, 4, seed=5), RefSampler(512, 4, seed=5)
    for lo in range(0, 5000, 900):
        mine.update(x[lo:lo + 900], min(900, 5000 - lo))
        ref.update(x[lo:lo + 900], min(900, 5000 - lo))
    for g in (2, 100, 256):
        grid = mine.cdf_grid(g)
        np.testing.assert_array_equal(grid, ref.cdf_grid(g))
        assert grid.dtype == np.float32 and grid.shape == (4, g)
        assert (grid[:, 1:] >= grid[:, :-1]).all()      # nondecreasing
        assert np.isposinf(grid[3]).all()
    np.testing.assert_array_equal(mine.spearman(), ref.spearman())


def test_backend_grid_clamps_and_rejects_unsorted(caplog, monkeypatch):
    sampler = RowSampler(64, 2)
    sampler.update(np.random.default_rng(0).normal(
        size=(64, 2)).astype(np.float32), 64)
    with caplog.at_level("WARNING", logger="tpuprof_torch"):
        grid = spearman_grid(sampler, 1000)
    assert grid.shape == (2, MAX_SPEAR_GRID)
    assert "clamped" in caplog.text
    bad = grid.copy()
    bad[1, 10] = bad[1, 9] - 1.0
    monkeypatch.setattr(sampler, "cdf_grid", lambda g: bad)
    with pytest.raises(ValueError, match="not sorted"):
        spearman_grid(sampler, 256)
    bad = grid.copy()
    bad[0, 0] = np.nan
    with pytest.raises(ValueError, match="NaN"):
        spearman_grid(sampler, 256)


@pytest.mark.parametrize("bad", ["grid_rows", "grid_points", "grid_dtype",
                                 "narrow"])
def test_spearman_entry_points_reject_bad_inputs(bad):
    cols, rows = 4, 32
    xt = torch.zeros((cols, rows))
    rv = torch.ones(rows, dtype=torch.bool)
    grid = torch.zeros((cols, 8))
    if bad == "grid_rows":
        grid = grid[:-1]
    elif bad == "grid_points":
        grid = torch.zeros((cols, MAX_SPEAR_GRID + 1))
    elif bad == "grid_dtype":
        grid = grid.double()
    else:
        cols = fused.MAX_FUSED_COLS + 1
        xt = torch.zeros((cols, rows))
        grid = torch.zeros((cols, 8))
    with pytest.raises(ValueError):
        fused.spearman_update(_port_co(cols), xt, rv, grid)
    if bad != "narrow":
        with pytest.raises(ValueError):
            fused.rank_transform(xt, rv, grid)


def test_spearman_grid_config_validated():
    with pytest.raises(ValueError, match="spearman_grid"):
        ProfilerConfig(spearman_grid=1)
    with pytest.raises(ValueError, match="spearman_grid"):
        ProfilerConfig(spearman_grid=5000)
    assert ProfilerConfig(spearman=True, spearman_grid=300).spearman_grid \
        == 300


# ---------------------------------------------------------------------------
# the whole narrow slice
# ---------------------------------------------------------------------------

def _numeric_frame(n=1500, seed=11):
    rng = np.random.default_rng(seed)
    x = rng.gamma(2.0, 5.0, n)
    df = pd.DataFrame({
        "x": x,
        "y_mono": np.exp(x / 10) + rng.normal(0, 0.1, n),
        "z": rng.normal(0, 1, n),
        "w": np.round(rng.normal(0, 2, n)) - 0.3 * x,      # ties
        "f32": (x + rng.normal(0, 4, n)).astype(np.float32),
    })
    for col in ("x", "z", "w"):
        df.loc[rng.choice(n, n // 15, replace=False), col] = np.nan
    return df


def _ref_grid_tier(df, batch_rows, k=4096, n_grid=256):
    """The reference's grid tier by hand: its sampler over the float32
    batches, cdf_grid, spearman_update (interpret) per batch, finalize."""
    x = df.to_numpy(dtype=np.float32)
    n, cols = x.shape
    sampler = RefSampler(k, cols)
    for lo in range(0, n, batch_rows):
        sampler.update(x[lo:lo + batch_rows], min(batch_rows, n - lo))
    grid = jnp.asarray(sampler.cdf_grid(n_grid))
    co = _ref_co(cols)
    for lo in range(0, n, batch_rows):
        xb = np.full((batch_rows, cols), np.nan, dtype=np.float32)
        part = x[lo:lo + batch_rows]
        xb[: len(part)] = part
        rv = np.arange(batch_rows) < len(part)
        co = ref_fused.spearman_update(
            co, jnp.asarray(np.ascontiguousarray(xb.T)), jnp.asarray(rv),
            grid, interpret=True)
    return ref_corr.finalize(jax.device_get(co))


@pytest.fixture(scope="module")
def narrow_df():
    return _numeric_frame()


@pytest.fixture(scope="module")
def narrow_port(narrow_df):
    return tpuprof_torch.describe(narrow_df, device="cpu", batch_rows=512,
                                  spearman=True)


def test_narrow_describe_matches_reference_grid_tier(narrow_df, narrow_port):
    sp = narrow_port["correlations"]["spearman"]
    assert sp.attrs["approx"] is False
    assert list(sp.index) == list(narrow_df.columns)
    ref = _ref_grid_tier(narrow_df, 512)
    np.testing.assert_allclose(sp.to_numpy(), ref, rtol=0, atol=RHO_ATOL)


def test_narrow_describe_matches_exact_tier_and_pandas(narrow_df,
                                                       narrow_port):
    sp = narrow_port["correlations"]["spearman"]
    ref = TPUStatsBackend().collect(
        narrow_df, RefConfig(backend="tpu", batch_rows=512, spearman=True))
    rsp = ref["correlations"]["spearman"]
    assert list(rsp.index) == list(sp.index)
    np.testing.assert_allclose(sp.to_numpy(), rsp.to_numpy(), rtol=0,
                               atol=GRID_VS_EXACT)
    expect = narrow_df.astype(np.float32).corr(method="spearman")
    np.testing.assert_allclose(sp.to_numpy(), expect.to_numpy(), rtol=0,
                               atol=GRID_VS_EXACT)
    assert sp.loc["x", "y_mono"] > 0.99
    # Pearson, and the rejection that reads it, are unchanged
    plain = tpuprof_torch.describe(narrow_df, device="cpu", batch_rows=512)
    np.testing.assert_array_equal(
        narrow_port["correlations"]["pearson"].to_numpy(),
        plain["correlations"]["pearson"].to_numpy())
    assert "spearman" not in plain["correlations"]


def test_without_second_scan_the_sample_tier_says_approx():
    rng = np.random.default_rng(23)
    n = 30_000
    x = rng.gamma(2.0, 5.0, n)
    heavy = rng.standard_cauchy(n)
    df = pd.DataFrame({"x": x, "y_mono": np.exp(x / 10)
                       + rng.normal(0, 0.1, n), "heavy": heavy,
                       "h_link": heavy + rng.standard_cauchy(n) * 0.5,
                       "z": rng.normal(0, 1, n)})
    kw = dict(batch_rows=8192, spearman=True, exact_passes=False,
              quantile_sketch_size=4096)
    port = tpuprof_torch.describe(df, device="cpu", **kw)
    sp = port["correlations"]["spearman"]
    assert sp.attrs["approx"] is True
    err = np.abs(sp.to_numpy() - df.corr(method="spearman").loc[
        sp.index, sp.columns].to_numpy())
    assert np.nanmax(err) < 5.0 / np.sqrt(4096), np.nanmax(err)
    ref = TPUStatsBackend().collect(df, RefConfig(backend="tpu", **kw))
    rsp = ref["correlations"]["spearman"]
    assert rsp.attrs["approx"] is True
    np.testing.assert_allclose(sp.to_numpy(), rsp.to_numpy(), rtol=0,
                               atol=1e-12)


def test_one_numeric_column_gives_no_matrix():
    df = pd.DataFrame({"x": np.arange(50.0), "c": ["a", "b"] * 25})
    stats = tpuprof_torch.describe(df, device="cpu", spearman=True)
    assert "spearman" not in stats["correlations"]


# ---------------------------------------------------------------------------
# on the card (skipped elsewhere)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("kernels K5 and K6 run only on a CUDA device")
    return torch.device("cuda:0")


@pytest.mark.cuda
@pytest.mark.parametrize("cols,n_grid", [(37, 100), (200, 256)])
def test_k5_k6_match_plain_on_card(cuda_device, cols, n_grid):
    xt, rv, grid = _adversarial(65536, cols, n_grid, seed=3)
    t = [torch.from_numpy(a).to(cuda_device) for a in (xt, rv, grid)]
    ranks = fused.rank_cuda(*t)
    ref_ranks = fused.rank_transform_plain(*t)
    got = fused.spear_tiles_cuda(*t)
    again = fused.spear_tiles_cuda(*t)
    ref = fused.spear_tiles_plain(*t)
    half = torch.full((cols,), 0.5, device=cuda_device)
    two_stage = fused.tiles_wide_cuda(ranks, t[1], half, skip_stats=True)
    torch.cuda.synchronize()
    assert torch.equal(ranks.view(torch.int32), ref_ranks.view(torch.int32))
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    # K5 is K6 then K3 with skip_stats, bit for bit
    assert all(torch.equal(a, b) for a, b in zip(got, two_stage[2:]))
    assert torch.equal(got[3], ref[3])
