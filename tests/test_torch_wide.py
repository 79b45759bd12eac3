"""Wide tables (513..2048 numeric columns) in the PyTorch port against the
JAX reference.

Kernel K3's plain version (``tiles_wide_plain``), with and without
``skip_stats``, against ``_fused_tiles_wide(..., interpret=True)`` at the
reference's own wide-kernel test shapes; the split rule that bounds K3's
scratch; and the whole wide slice, ``describe`` of a frame with more than
512 numeric columns, against the reference backend (exact where the scan
is exact, float32 tolerances for moments and rho) and, with
``spearman=True``, against the reference's wide grid tier composed by hand
(atol 5e-4), its CPU exact tier and pandas (atol 0.02).  Past 2048 numeric
columns the kernels' entry points raise ``ValueError`` and ``describe``
takes the reference's XLA twin and exact rank tier
(``test_torch_wide_xla.py``).  Tests that need the card skip elsewhere."""

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import tpuprof_torch
from tpuprof import ProfilerConfig as RefConfig
from tpuprof import schema as ref_schema
from tpuprof.backends.tpu import TPUStatsBackend
from tpuprof.ingest.sample import RowSampler as RefSampler
from tpuprof.kernels import corr as ref_corr
from tpuprof.kernels import fused as ref_fused
from tpuprof.kernels import moments as ref_moments
from tpuprof_torch import schema
from tpuprof_torch.kernels import corr, fused, moments
from torch_route import same_hash_route  # noqa: F401  (autouse)

MOMENT_TOL = [("mean", 1e-4), ("std", 1e-3), ("variance", 2e-3),
              ("sum", 1e-4), ("mad", 1e-3), ("skewness", 2e-2),
              ("kurtosis", 5e-2)]
RHO_ATOL = 5e-4
GRID_VS_EXACT = 0.02        # the reference's own (tests/test_fused.py)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _mk_batch(rows, cols, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(50.0, 10.0, (rows, cols)).astype(np.float32)
    x[rng.random((rows, cols)) < 0.07] = np.nan
    x[rng.random((rows, cols)) < 0.01] = np.inf
    x[rng.random((rows, cols)) < 0.01] = -np.inf
    x[rng.random((rows, cols)) < 0.03] = 0.0
    x[:, 1] = np.nan                           # an all-missing column
    rv = np.ones(rows, dtype=bool)
    rv[-max(rows // 10, 1):] = False
    return x, rv


# ---------------------------------------------------------------------------
# K3
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("skip_stats", [False, True])
@pytest.mark.parametrize("rows,cols", [(300, 70), (700, 300)])
def test_wide_plain_matches_pallas_interpret(rows, cols, skip_stats):
    x, rv = _mk_batch(rows, cols, seed=cols)
    xt = np.ascontiguousarray(x.T)
    shift = np.full(cols, 50.0, dtype=np.float32)
    ref = jax.device_get(ref_fused._fused_tiles_wide(
        jnp.asarray(xt), jnp.asarray(rv), jnp.asarray(shift),
        interpret=True, skip_stats=skip_stats))
    got = [a.numpy() for a in fused.tiles_wide_plain(
        _t(xt), _t(rv), _t(shift), skip_stats=skip_stats)]
    np.testing.assert_array_equal(got[1], np.asarray(ref[1]))     # counts
    np.testing.assert_array_equal(got[0][:, 4:], np.asarray(ref[0])[:, 4:])
    np.testing.assert_array_equal(got[5], np.asarray(ref[5]))     # N
    # the float sums are held through what they finalize to: rho below,
    # the moments further down
    co = corr.init(cols)
    co["shift"] = _t(shift)
    co["set"].fill_(1)
    rco = ref_corr.init(cols)
    rco["shift"] = jnp.asarray(shift)
    rco["set"] = jnp.ones((), dtype=jnp.int32)
    np.testing.assert_allclose(
        corr.finalize(fused._fold_corr(co, *map(_t, got[2:]))),
        ref_corr.finalize(jax.device_get(ref_fused._fold_corr(
            rco, *map(jnp.asarray, ref[2:])))),
        rtol=0, atol=RHO_ATOL, equal_nan=True)
    if skip_stats:
        ident = np.array([0, 0, 0, 0, np.inf, -np.inf, np.inf, -np.inf],
                         dtype=np.float32)
        np.testing.assert_array_equal(got[0], np.tile(ident, (cols, 1)))
        assert not got[1].any()
        return
    mom = moments.init(cols)
    mom["shift"] = _t(shift)
    rmom = ref_moments.init(cols)
    rmom["shift"] = jnp.asarray(shift)
    fp = moments.finalize(fused._fold_mom(mom, _t(got[0]), _t(got[1])))
    fr = ref_moments.finalize(jax.device_get(ref_fused._fold_mom(
        rmom, jnp.asarray(ref[0]), jnp.asarray(ref[1]))))
    for k in ("n", "n_zeros", "n_inf", "n_missing", "min", "max", "fmin",
              "fmax"):
        np.testing.assert_array_equal(fp[k], fr[k], err_msg=k)
    for k in ("mean", "variance", "skewness", "kurtosis", "sum"):
        np.testing.assert_allclose(fp[k], fr[k], rtol=5e-4, atol=1e-5,
                                   equal_nan=True, err_msg=k)


def test_wide_update_routes_and_folds_like_reference():
    """``fused.update`` past MAX_FUSED_COLS folds the same state as the
    reference's ``update`` (which routes to its wide kernel there)."""
    rows, cols = 256, fused.MAX_FUSED_COLS + 8
    x, rv = _mk_batch(rows, cols, seed=2)
    xt = np.ascontiguousarray(x.T)
    shift = np.full(cols, 50.0, dtype=np.float32)
    mom = moments.init(cols)
    mom["shift"] = _t(shift)
    co = corr.init(cols)
    co["shift"] = _t(shift)
    co["set"].fill_(1)
    got_m, got_c = fused.update(mom, co, _t(xt), _t(rv))
    rmom = ref_moments.init(cols)
    rmom["shift"] = jnp.asarray(shift)
    rco = ref_corr.init(cols)
    rco["shift"] = jnp.asarray(shift)
    rco["set"] = jnp.ones((), dtype=jnp.int32)
    ref_m, ref_c = ref_fused.update(rmom, rco, jnp.asarray(xt),
                                    jnp.asarray(rv), interpret=True)
    np.testing.assert_array_equal(got_c["N"].numpy(), np.asarray(ref_c["N"]))
    fp, fr = moments.finalize(got_m), ref_moments.finalize(
        jax.device_get(ref_m))
    for k in ("n", "n_missing", "min", "max"):
        np.testing.assert_array_equal(fp[k], fr[k], err_msg=k)
    np.testing.assert_allclose(corr.finalize(got_c),
                               ref_corr.finalize(jax.device_get(ref_c)),
                               rtol=0, atol=RHO_ATOL, equal_nan=True)


@pytest.mark.parametrize("C,R", [(513, 65536), (1024, 65536),
                                 (2048, 65536), (2048, 131072),
                                 (2048, 5_000_000)])
def test_wide_splits_bound_scratch_and_keep_counts_exact(C, R):
    tile, tr = 64, 32           # gram.cuh's TC_TILE and TC_ROWS
    cap = fused._WIDE_MAX_GRAM_SPLITS
    stat_s, stat_rows, gram_s, gram_rows = fused.splits(
        C, R, tile, tr, max_gram_splits=cap)
    assert gram_s * gram_rows >= R > (gram_s - 1) * gram_rows
    assert gram_rows <= 1 << 20             # f32 pair counts stay exact
    assert gram_s <= max(cap, -(-R // (1 << 20)))
    assert stat_s * stat_rows >= R
    # the triangle's tile pairs: past the card's target only when the
    # 2^20-row limit forces more splits
    t = -(-C // tile)
    pairs = t * (t + 1) // 2
    assert gram_s * pairs <= max(fused._TARGET_BLOCKS,
                                 pairs * -(-R // (1 << 20)))


def test_more_than_2048_numeric_columns_raise():
    """Past 2048 columns the kernels' entry points (K3, K6) raise, and
    ``describe`` runs: on the XLA twin and the exact rank tier."""
    df = pd.DataFrame(np.zeros((4, fused.MAX_FUSED_COLS_WIDE + 1)),
                      columns=[f"c{i}" for i in
                               range(fused.MAX_FUSED_COLS_WIDE + 1)])
    stats = tpuprof_torch.describe(df, device="cpu")
    assert stats["table"]["n"] == 4
    assert len(stats["variables"]) == fused.MAX_FUSED_COLS_WIDE + 1
    xt = torch.zeros((fused.MAX_FUSED_COLS_WIDE + 1, 8))
    rv = torch.ones(8, dtype=torch.bool)
    with pytest.raises(ValueError, match="update_xla"):
        fused.rank_transform(xt, rv, torch.zeros((xt.shape[0], 4)))
    with pytest.raises(ValueError, match="update_xla"):
        mom, co = {"shift": torch.zeros(xt.shape[0])}, {}
        fused.update(mom, co, xt, rv)


# ---------------------------------------------------------------------------
# the whole wide slice
# ---------------------------------------------------------------------------

N_FLOAT = 520


def _wide_frame(n=1200, seed=5):
    """520 float64 columns (a strongly correlated block of 8, the rest
    independent, NaN and +-inf scattered) plus a float32, an int column
    with nulls, a bool, a categorical, a date and a constant."""
    rng = np.random.default_rng(seed)
    base = rng.normal(0.0, 1.0, n)
    data = rng.normal(0.0, 1.0, (n, N_FLOAT)) \
        * np.linspace(1.0, 20.0, N_FLOAT)[None, :] \
        + np.linspace(-100.0, 100.0, N_FLOAT)[None, :]
    data[:, :8] += 30.0 * base[:, None]
    data[rng.random((n, N_FLOAT)) < 0.03] = np.nan
    data[rng.random((n, N_FLOAT)) < 0.002] = np.inf
    df = pd.DataFrame(data, columns=[f"f{i:03d}" for i in range(N_FLOAT)])
    df["f32"] = (base + rng.normal(0, 3, n)).astype(np.float32)
    df["ints"] = pd.array(np.where(rng.random(n) < 0.1, None,
                                   rng.integers(-50, 50, n)), dtype="Int64")
    df["flag"] = rng.random(n) < 0.3
    df["cat"] = rng.choice(["a", "b", "c", None], n)
    df["when"] = pd.Timestamp("2021-01-01") + pd.to_timedelta(
        rng.integers(0, 10 ** 7, n), unit="s")
    df["const"] = 2.5
    return df


@pytest.fixture(scope="module")
def wide_df():
    return _wide_frame()


@pytest.fixture(scope="module")
def wide_both(wide_df):
    kw = dict(batch_rows=512, spearman=True)
    ref = TPUStatsBackend().collect(wide_df, RefConfig(backend="tpu", **kw))
    port = tpuprof_torch.describe(wide_df, device="cpu", **kw)
    return port, ref


def test_wide_describe_matches_reference(wide_both):
    port, ref = wide_both
    assert schema.validate_stats(port) == []
    assert port["table"]["n"] == ref["table"]["n"]
    assert list(port["variables"]) == list(ref["variables"])
    n_num = 0
    for name, rv in ref["variables"].items():
        pv = port["variables"][name]
        assert pv["type"] == rv["type"], name
        for fld in ("count", "n_missing", "distinct_count", "is_unique",
                    "memorysize"):
            assert pv[fld] == rv[fld], (name, fld)
        if rv["type"] != ref_schema.NUM:
            continue
        n_num += 1
        for fld in ("n_zeros", "n_infinite", "min", "max", "p5", "p50",
                    "p95", "mode"):
            assert pv[fld] == rv[fld], (name, fld)
        for fld, tol in MOMENT_TOL:
            assert pv[fld] == pytest.approx(rv[fld], rel=tol, abs=1e-6), \
                (name, fld)
        np.testing.assert_array_equal(pv["histogram"][0],
                                      rv["histogram"][0], err_msg=name)
        np.testing.assert_array_equal(pv["histogram"][1],
                                      rv["histogram"][1], err_msg=name)
    assert n_num > fused.MAX_FUSED_COLS
    pp, rp = port["correlations"]["pearson"], ref["correlations"]["pearson"]
    assert list(pp.index) == list(rp.index)
    np.testing.assert_allclose(pp.to_numpy(), rp.to_numpy(), rtol=0,
                               atol=RHO_ATOL, equal_nan=True)
    rejected = [c for c, v in port["variables"].items()
                if v["type"] == schema.CORR]
    assert rejected == ref_schema.rejected_variables(ref)
    assert rejected == [f"f{i:03d}" for i in range(1, 8)]


def test_wide_spearman_matches_exact_tier_and_pandas(wide_df, wide_both):
    port, ref = wide_both
    sp, rsp = port["correlations"]["spearman"], \
        ref["correlations"]["spearman"]
    assert sp.attrs["approx"] is False
    assert list(sp.index) == list(rsp.index)
    assert len(sp.index) > fused.MAX_FUSED_COLS
    np.testing.assert_allclose(sp.to_numpy(), rsp.to_numpy(), rtol=0,
                               atol=GRID_VS_EXACT, equal_nan=True)
    # pandas re-ranks every pair: a subset of columns keeps it quick (a
    # pair's coefficient depends only on that pair's values)
    cols = list(sp.index[:24]) + ["f32", "ints"]
    expect = wide_df[cols].astype(np.float32).replace(
        [np.inf, -np.inf], np.nan).corr(method="spearman")
    np.testing.assert_allclose(sp.loc[cols, cols].to_numpy(),
                               expect.to_numpy(), rtol=0,
                               atol=GRID_VS_EXACT, equal_nan=True)


def _ref_wide_grid_tier(x, batch_rows, k=4096, n_grid=256):
    """The reference's wide grid tier by hand: its sampler over the float32
    batches, cdf_grid, then rank_transform + spearman_update_wide
    (interpret) per batch, finalize."""
    n, cols = x.shape
    sampler = RefSampler(k, cols)
    for lo in range(0, n, batch_rows):
        sampler.update(x[lo:lo + batch_rows], min(batch_rows, n - lo))
    grid = jnp.asarray(sampler.cdf_grid(n_grid))
    co = ref_corr.init(cols)
    co["shift"] = jnp.full((cols,), 0.5, dtype=jnp.float32)
    co["set"] = jnp.ones((), dtype=jnp.int32)
    for lo in range(0, n, batch_rows):
        xb = np.full((batch_rows, cols), np.nan, dtype=np.float32)
        part = x[lo:lo + batch_rows]
        xb[: len(part)] = part
        rv = jnp.asarray(np.arange(batch_rows) < len(part))
        ranks = ref_fused.rank_transform(
            jnp.asarray(np.ascontiguousarray(xb.T)), rv, grid,
            interpret=True)
        co = ref_fused.spearman_update_wide(co, ranks, rv, interpret=True)
    return ref_corr.finalize(jax.device_get(co))


def test_wide_spearman_matches_reference_grid_tier(wide_df, wide_both):
    """Over the float columns (a table of 521 numeric columns on its own,
    so the reference's wide tier runs): the port's matrix restricted to
    them equals the reference's grid tier on them, since each pair's sums
    and each column's grid depend only on that pair's values."""
    port, _ = wide_both
    floats = [f"f{i:03d}" for i in range(N_FLOAT)] + ["f32"]
    got = port["correlations"]["spearman"].loc[floats, floats].to_numpy()
    want = _ref_wide_grid_tier(wide_df[floats].to_numpy(np.float32), 512)
    np.testing.assert_allclose(got, want, rtol=0, atol=RHO_ATOL,
                               equal_nan=True)


# ---------------------------------------------------------------------------
# on the card (skipped elsewhere)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("kernel K3 runs only on a CUDA device")
    return torch.device("cuda:0")


@pytest.mark.cuda
@pytest.mark.parametrize("skip_stats", [False, True])
def test_k3_matches_plain_on_card(cuda_device, skip_stats):
    x, rv = _mk_batch(4096, 700, seed=12)
    xt = _t(x.T).to(cuda_device)
    rvt = _t(rv).to(cuda_device)
    shift = torch.full((700,), 50.0, device=cuda_device)
    got = fused.tiles_wide_cuda(xt, rvt, shift, skip_stats=skip_stats)
    again = fused.tiles_wide_cuda(xt, rvt, shift, skip_stats=skip_stats)
    ref = fused.tiles_wide_plain(xt, rvt, shift, skip_stats=skip_stats)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert torch.equal(got[1], ref[1]) and torch.equal(got[5], ref[5])
    assert torch.equal(got[0][:, 4:], ref[0][:, 4:])
