"""Single-pass profiles of the PyTorch port (``profile_passes="fused"``,
kernel K4's module and ``runtime/singlepass.py``) against the port's own
two-pass profile and the JAX reference.

The contract: a fused profile's ``stats_to_json`` equals the two-pass
profile's exactly, whatever mix of edge hits and misses the provisional
edges give (hit lanes keep the fused counts, missed lanes re-bin on the
exact triple).  ``tiles_ab_plain`` — the plain version K4 is held to on the
card — is compared with ``tpuprof.kernels.fused._fused_ab_tiles(...,
interpret=True)`` at the reference's kernel tolerances: counts, min/max
and histograms exact, moments rtol 5e-4 / atol 1e-5, the MAD numerator
rtol 5e-4.  The K4-on-card tests need a CUDA device and skip elsewhere."""

import json

import jax  # noqa: F401  (JAX stays on the CPU: tests/conftest.py)
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import tpuprof_torch
from tpuprof import ProfilerConfig as RefConfig
from tpuprof import schema as ref_schema
from tpuprof.artifact import write_artifact as ref_write_artifact
from tpuprof.backends.tpu import TPUStatsBackend
from tpuprof.kernels import fused as ref_fused
from tpuprof_torch.artifact import write_artifact
from tpuprof_torch.backends import gpu
from tpuprof_torch.kernels import corr, fused, hist, moments
from tpuprof_torch.report.export import stats_to_json
from tpuprof_torch.runtime import runner as port_runner
from tpuprof_torch.runtime import singlepass
from torch_route import same_hash_route  # noqa: F401  (autouse)

ROWS = 3000
BATCH = 512
# the reference backend tests' moment tolerances (tests/test_tpu_backend.py)
MOMENT_TOL = [("mean", 1e-4), ("std", 1e-3), ("variance", 2e-3),
              ("sum", 1e-4), ("mad", 1e-3), ("skewness", 2e-2),
              ("kurtosis", 5e-2)]


def _edge_case_df(rows=ROWS, seed=7):
    """tests/test_singlepass.py's fixture: NaN-heavy, +-inf, constant,
    all-NaN, int-ish, a bool, plus plain floats."""
    rng = np.random.default_rng(seed)
    inf_col = rng.normal(0, 1, rows).astype(np.float32)
    inf_col[rng.choice(rows, 40, replace=False)] = np.inf
    inf_col[rng.choice(rows, 40, replace=False)] = -np.inf
    nan_col = rng.normal(5, 2, rows).astype(np.float32)
    nan_col[rng.random(rows) < 0.4] = np.nan
    return pd.DataFrame({
        "plain": rng.normal(100, 15, rows).astype(np.float32),
        "ints": rng.integers(0, 50, rows).astype(np.int64),
        "with_nan": nan_col,
        "with_inf": inf_col,
        "const": np.full(rows, 2.5, dtype=np.float32),
        "all_nan": np.full(rows, np.nan, dtype=np.float32),
        "flag": rng.random(rows) < 0.3,
    })


def _port(df, **kw):
    kw.setdefault("batch_rows", BATCH)
    return tpuprof_torch.describe(df, device="cpu", **kw)


def _ref(df, **kw):
    kw.setdefault("batch_rows", BATCH)
    return TPUStatsBackend().collect(df, RefConfig(backend="tpu", **kw))


def _export(stats):
    return json.dumps(stats_to_json(stats), sort_keys=True, default=str)


class _Spy:
    """Counts the scans a profile runs (``prefetch_prepared`` calls) and
    the pass-B histogram folds (K2's entry point, or its plain version)."""

    def __init__(self, monkeypatch):
        self.scans = 0
        self.hist_folds = 0
        real_scan, real_hist = gpu.prefetch_prepared, hist.histogram_batch

        def scan(*a, **kw):
            self.scans += 1
            return real_scan(*a, **kw)

        def fold(*a, **kw):
            self.hist_folds += 1
            return real_hist(*a, **kw)

        monkeypatch.setattr(gpu, "prefetch_prepared", scan)
        monkeypatch.setattr(port_runner.hist, "histogram_batch", fold)


def _counters():
    return (singlepass.edge_hits, singlepass.edge_misses, singlepass.rebins,
            singlepass.rebin_lanes)


@pytest.fixture(scope="module")
def edge_df():
    return _edge_case_df()


@pytest.fixture(scope="module")
def two_pass(edge_df):
    return _port(edge_df)


# ---------------------------------------------------------------------------
# (a) the plain version of K4 against the reference's Pallas kernel
# ---------------------------------------------------------------------------

def _ab_inputs(cols, rows, nbins, seed):
    """An adversarial batch and provisional bounds narrower than its data
    (values fall outside [lo, hi]); column 4 lives at the float32
    normal/denormal boundary."""
    rng = np.random.default_rng(seed)
    x = rng.normal(10.0, 3.0, (cols, rows)).astype(np.float32)
    x[rng.random((cols, rows)) < 0.05] = np.nan
    x[rng.random((cols, rows)) < 0.02] = np.inf
    x[rng.random((cols, rows)) < 0.02] = -np.inf
    x[rng.random((cols, rows)) < 0.03] = 0.0
    x[1] = 4.25                                  # constant column
    x[2] = np.nan                                # all-NaN column
    x[3] = rng.integers(0, 5, rows).astype(np.float32)
    x[4] = rng.normal(0.0, 1e-38, rows).astype(np.float32)   # denormals
    rv = np.ones(rows, dtype=bool)
    rv[-rows // 8:] = False
    fin = rv[None, :] & np.isfinite(x)
    with np.errstate(all="ignore"):
        lo = np.where(fin.any(1), np.where(fin, x, np.inf).min(1), 0)
        hi = np.where(fin.any(1), np.where(fin, x, -np.inf).max(1), 0)
        mean = np.where(fin.any(1), np.where(fin, x, 0).astype(
            np.float64).sum(1) / np.maximum(fin.sum(1), 1), 0)
    width = hi - lo
    lo, hi = (lo + 0.1 * width).astype(np.float32), \
        (hi - 0.1 * width).astype(np.float32)
    mean = (mean + 0.05 * width).astype(np.float32)
    edges = np.linspace(lo[3], hi[3], nbins + 1).astype(np.float32)
    x[3, rng.choice(rows - rows // 8, edges.size, replace=False)] = edges
    shift = np.where(fin.any(1), np.where(fin, x, 0).sum(1)
                     / np.maximum(fin.sum(1), 1), 0).astype(np.float32)
    return x, rv, shift, lo, hi, mean


@pytest.mark.parametrize("hist_kernel", ["cumulative", "legacy"])
@pytest.mark.parametrize("cols,rows,nbins", [(7, 1024, 10), (40, 700, 1),
                                             (9, 2048, 128)])
def test_tiles_ab_plain_matches_pallas_interpret(hist_kernel, cols, rows,
                                                 nbins):
    x, rv, shift, lo, hi, mean = _ab_inputs(cols, rows, nbins, seed=nbins)
    ref = [np.array(a) for a in ref_fused._fused_ab_tiles(
        *(jnp.asarray(a) for a in (x, rv, shift, lo, hi, mean)), nbins,
        hist_kernel=hist_kernel, interpret=True)]
    got = [a.numpy() for a in fused.tiles_ab_plain(
        *(torch.from_numpy(np.ascontiguousarray(a))
          for a in (x, rv, shift, lo, hi, mean)), nbins)]
    sums, counts, P, S1, S2, N, hc, dev = got
    rs, rc, rP, rS1, rS2, rN, rhc, rdev = ref
    # the reference's XLA CPU backend flushes denormals to zero (ROADMAP
    # Queue 3), so it counts column 4's denormals as zeros: that count is
    # held to IEEE instead, as is the column's MAD numerator below
    fin = rv & np.isfinite(x[4])
    assert counts[4, 1] == int((fin & (x[4] == 0)).sum()) < rc[4, 1]
    rc[4, 1] = counts[4, 1]
    np.testing.assert_array_equal(counts, rc)
    np.testing.assert_array_equal(sums[:, 4:], rs[:, 4:])     # min/max
    np.testing.assert_array_equal(N, rN)
    np.testing.assert_array_equal(hc, rhc)
    # the sums of centred values cancel: they are held through what the
    # profile reports, the finalized moments and rho
    mom0 = moments.init(cols, "cpu")
    mom0["shift"] = torch.from_numpy(shift)
    co0 = corr.init(cols, "cpu")
    co0["shift"] = mom0["shift"].clone()
    co0["set"].fill_(1)
    fin_p, fin_r = (moments.finalize(fused._fold_mom(
        mom0, torch.from_numpy(s), torch.from_numpy(c)))
        for s, c in ((sums, counts), (rs, rc)))
    for k in ("mean", "variance", "skewness", "kurtosis", "sum"):
        np.testing.assert_allclose(fin_p[k], fin_r[k], rtol=5e-4, atol=1e-5,
                                   equal_nan=True, err_msg=k)
    rho_p, rho_r = (corr.finalize(fused._fold_corr(
        co0, *(torch.from_numpy(a) for a in g)))
        for g in ((P, S1, S2, N), (rP, rS1, rS2, rN)))
    np.testing.assert_allclose(rho_p, rho_r, rtol=0, atol=5e-4,
                               equal_nan=True)
    keep = np.arange(cols) != 4
    np.testing.assert_allclose(dev[keep], rdev[keep], rtol=5e-4)
    exact = np.abs(x[4][fin].astype(np.float64) - np.float64(mean[4])).sum()
    np.testing.assert_allclose(dev[4], exact, rtol=5e-4)


def test_update_with_hist_on_cpu_is_k1_then_k2_plain():
    x, rv, shift, lo, hi, mean = _ab_inputs(6, 900, 10, seed=3)
    t = [torch.from_numpy(np.ascontiguousarray(a))
         for a in (x, rv, shift, lo, hi, mean)]
    mom = moments.init(6, "cpu")
    mom["shift"] = t[2]
    co = corr.init(6, "cpu")
    co["shift"] = t[2].clone()
    co["set"].fill_(1)
    h0 = {"counts": torch.zeros((6, 10), dtype=torch.int32),
          "abs_dev": torch.zeros(6)}
    m1, c1, h1 = fused.update_with_hist(mom, co, h0, t[0], t[1], *t[3:])
    m2, c2 = fused.update_plain(mom, co, t[0], t[1])
    counts, dev = hist.histogram_plain(t[0], t[1], *t[3:], 10)
    for k in m1:
        assert torch.equal(m1[k], m2[k]), k
    for k in c1:
        assert torch.equal(c1[k], c2[k]), k
    assert torch.equal(h1["counts"], counts)
    assert torch.equal(h1["abs_dev"], dev)


# ---------------------------------------------------------------------------
# (b)-(i): fused == two-pass, exactly
# ---------------------------------------------------------------------------

def test_cold_fused_equals_two_pass(edge_df, two_pass, monkeypatch):
    spy = _Spy(monkeypatch)
    c0 = _counters()
    fused_stats = _port(edge_df, profile_passes="fused")
    c1 = _counters()
    assert _export(fused_stats) == _export(two_pass)
    # the sketch hits the constant, all-NaN and bool-less lanes at most;
    # the rest re-bin in ONE second scan of the missed columns
    assert c1[0] - c0[0] + c1[1] - c0[1] == 7
    assert c1[1] > c0[1] and c1[2] - c0[2] == 1
    assert c1[3] - c0[3] == c1[1] - c0[1]
    assert spy.scans == 2


def test_warm_seed_hits_every_lane_and_skips_the_second_scan(
        tmp_path, edge_df, two_pass, monkeypatch):
    art = str(tmp_path / "seed.json")
    write_artifact(art, stats=two_pass,
                   config=tpuprof_torch.ProfilerConfig(batch_rows=BATCH))
    spy = _Spy(monkeypatch)
    c0 = _counters()
    warm = _port(edge_df, profile_passes="fused", seed_edges=art)
    c1 = _counters()
    assert _export(warm) == _export(two_pass)
    assert (c1[0] - c0[0], c1[1] - c0[1]) == (7, 0)     # all lanes hit
    assert c1[2] == c0[2]                                # no re-bin
    assert spy.scans == 1 and spy.hist_folds == 0        # one read only
    assert warm["_bin_seeds"] == two_pass["_bin_seeds"]


def test_drifted_seed_rebins_missed_lanes_identically(tmp_path, two_pass,
                                                      monkeypatch):
    df = _edge_case_df(seed=11)
    # the global extremes sit in the last batch: the cold sketch would
    # miss this column too
    df["sorted"] = np.sort(np.random.default_rng(3).normal(
        0, 50, len(df))).astype(np.float32)
    art = str(tmp_path / "seed.json")
    write_artifact(art, stats=two_pass)
    two = _port(df)
    spy = _Spy(monkeypatch)
    c0 = _counters()
    got = _port(df, profile_passes="fused", seed_edges=art)
    c1 = _counters()
    assert _export(got) == _export(two)
    assert c1[1] > c0[1] and c1[2] - c0[2] == 1
    # the re-bin folds only the missed lanes: one fold a batch
    assert spy.hist_folds == -(-len(df) // BATCH)


def test_garbage_seed_warns_and_equals_two_pass(tmp_path, edge_df,
                                                two_pass, caplog):
    bad = str(tmp_path / "bad.json")
    with open(bad, "w") as fh:
        fh.write("{ not an artifact")
    with caplog.at_level("WARNING", logger="tpuprof_torch"):
        got = _port(edge_df, profile_passes="fused", seed_edges=bad)
    assert "unusable" in caplog.text
    assert _export(got) == _export(two_pass)


def test_fused_with_spearman_and_recount_equals_two_pass(tmp_path,
                                                         monkeypatch):
    rng = np.random.default_rng(5)
    df = pd.DataFrame({
        "x": rng.normal(0, 1, 2000).astype(np.float32),
        "y": rng.normal(9, 2, 2000).astype(np.float32),
        "z": np.sort(rng.normal(0, 1, 2000)).astype(np.float32),
        "cat": rng.choice(["a", "b", "c", "dd"], 2000),
    })
    two = _port(df, spearman=True)
    art = str(tmp_path / "m.json")
    write_artifact(art, stats=two)
    warm = _port(df, spearman=True, profile_passes="fused", seed_edges=art)
    assert _export(warm) == _export(two)
    # cold: the sorted column misses, and its re-bin rides the Spearman
    # scan, which ships the whole plane
    spy = _Spy(monkeypatch)
    cold = _port(df, spearman=True, profile_passes="fused")
    assert _export(cold) == _export(two)
    assert spy.scans == 2


def test_single_scan_with_warm_seed_adopts_exact_histogram_and_mad(
        tmp_path, edge_df, two_pass, monkeypatch):
    art = str(tmp_path / "s.json")
    write_artifact(art, stats=two_pass)
    sp_two = _port(edge_df, exact_passes=False)
    spy = _Spy(monkeypatch)
    sp_fused = _port(edge_df, exact_passes=False, profile_passes="fused",
                     seed_edges=art)
    assert spy.scans == 1
    for name in ("plain", "ints", "with_nan", "with_inf"):
        h_exact = two_pass["variables"][name]["histogram"]
        h_fused = sp_fused["variables"][name]["histogram"]
        np.testing.assert_array_equal(h_fused[0], h_exact[0])
        np.testing.assert_array_equal(h_fused[1], h_exact[1])
        assert sp_fused["variables"][name]["mad"] \
            == two_pass["variables"][name]["mad"]
        assert sp_fused["variables"][name]["mean"] \
            == sp_two["variables"][name]["mean"]


def test_single_scan_cold_keeps_sample_tier_on_missed_lanes(edge_df):
    sp_two = _port(edge_df, exact_passes=False)
    sp_fused = _port(edge_df, exact_passes=False, profile_passes="fused")
    # "plain" misses on the first-batch sketch: the sample tier, as two-pass
    # single-scan derives it
    for fld in ("mad", "mean", "std"):
        assert sp_fused["variables"]["plain"][fld] \
            == sp_two["variables"]["plain"][fld]
    np.testing.assert_array_equal(
        sp_fused["variables"]["plain"]["histogram"][0],
        sp_two["variables"]["plain"]["histogram"][0])


def test_wide_fused_equals_two_pass(tmp_path):
    rng = np.random.default_rng(8)
    cols = 520
    x = rng.normal(0, 1, (600, cols)).astype(np.float32)
    x[rng.random(x.shape) < 0.02] = np.nan
    df = pd.DataFrame(x, columns=[f"w{i}" for i in range(cols)])
    two = _port(df, batch_rows=256)
    cold = _port(df, batch_rows=256, profile_passes="fused")
    assert _export(cold) == _export(two)
    art = str(tmp_path / "w.json")
    write_artifact(art, stats=two)
    c0 = _counters()
    warm = _port(df, batch_rows=256, profile_passes="fused", seed_edges=art)
    assert singlepass.edge_hits - c0[0] == cols
    assert _export(warm) == _export(two)


def test_seed_from_reference_artifact_equals_port_two_pass(
        tmp_path, edge_df, two_pass):
    ref_two = _ref(edge_df)
    art = str(tmp_path / "jax.json")
    ref_write_artifact(art, stats=ref_two,
                       config=RefConfig(backend="tpu", batch_rows=BATCH))
    port_seeds, ref_seeds = two_pass["_bin_seeds"], ref_two["_bin_seeds"]
    assert set(port_seeds) == set(ref_seeds)
    same = sum(np.array_equal(np.float32(port_seeds[k]),
                              np.float32(ref_seeds[k])) for k in ref_seeds)
    c0 = _counters()
    got = _port(edge_df, profile_passes="fused", seed_edges=art)
    assert singlepass.edge_hits - c0[0] == same
    assert _export(got) == _export(two_pass)


# ---------------------------------------------------------------------------
# (j)-(l)
# ---------------------------------------------------------------------------

def test_port_fused_matches_reference_fused(edge_df):
    port = _port(edge_df, profile_passes="fused")
    ref = _ref(edge_df, profile_passes="fused")
    assert list(port["variables"]) == list(ref["variables"])
    for name, rv in ref["variables"].items():
        pv = port["variables"][name]
        assert pv["type"] == rv["type"], name
        for fld in ("count", "n_missing", "distinct_count"):
            assert pv[fld] == rv[fld], (name, fld)
        if rv["type"] != ref_schema.NUM:
            continue
        for fld in ("n_zeros", "n_infinite", "min", "max"):
            assert pv[fld] == rv[fld], (name, fld)
        np.testing.assert_array_equal(pv["histogram"][0], rv["histogram"][0],
                                      err_msg=name)
        np.testing.assert_array_equal(pv["histogram"][1], rv["histogram"][1],
                                      err_msg=name)
        for fld, tol in MOMENT_TOL:
            assert pv[fld] == pytest.approx(rv[fld], rel=tol, abs=1e-6), \
                (name, fld)


def test_env_profile_passes_fused_is_honoured(edge_df, two_pass,
                                              monkeypatch):
    monkeypatch.setenv("TPUPROF_PROFILE_PASSES", "fused")
    c0 = _counters()
    got = _port(edge_df)
    assert singlepass.edge_hits + singlepass.edge_misses - c0[0] - c0[1] \
        == 7
    assert _export(got) == _export(two_pass)
    monkeypatch.setenv("TPUPROF_PROFILE_PASSES", "three_pass")
    with pytest.raises(ValueError, match="TPUPROF_PROFILE_PASSES"):
        _port(edge_df)


def test_env_seed_edges_is_honoured(tmp_path, edge_df, two_pass,
                                    monkeypatch):
    art = str(tmp_path / "env.json")
    write_artifact(art, stats=two_pass)
    monkeypatch.setenv("TPUPROF_SEED_EDGES", art)
    c0 = _counters()
    got = _port(edge_df, profile_passes="fused")
    assert singlepass.edge_hits - c0[0] == 7
    assert _export(got) == _export(two_pass)


@pytest.mark.parametrize("C", [1, 2, 5, 37, 200, 512, 520, 2048])
@pytest.mark.parametrize("R", [1, 300, 4096, 65536, 65537, 1 << 20])
def test_stats_and_hist_partitions_are_one(C, R):
    tile, tr = 64, 32                     # gram.cuh's TC_TILE, TC_ROWS
    stat_s, stat_rows, _, _ = fused.splits(C, R, tile, tr)
    assert (stat_s, stat_rows) == hist.splits(C, R)
    assert stat_s * stat_rows >= R > (stat_s - 1) * stat_rows


def test_config_accepts_profile_passes_and_seed_edges():
    from tpuprof_torch.config import (ProfilerConfig, resolve_profile_passes,
                                      resolve_seed_edges)
    cfg = ProfilerConfig(profile_passes="fused", seed_edges="/a/b.json")
    assert cfg.profile_passes == "fused"
    assert resolve_profile_passes("two_pass") == "two_pass"
    assert resolve_seed_edges("/x.json") == "/x.json"
    with pytest.raises(ValueError, match="profile_passes"):
        ProfilerConfig(profile_passes="three_pass")
    # the fingerprint names every field, so two configs that differ differ
    assert cfg.fingerprint() != ProfilerConfig().fingerprint()
    assert cfg.fingerprint() == ProfilerConfig(
        profile_passes="fused", seed_edges="/a/b.json").fingerprint()


def test_hit_lanes_and_merge_rebinned():
    edges = singlepass.sketch_edges(
        np.array([[1.0, np.nan, 2.0], [3.0, np.nan, 2.0]], np.float32), 2)
    exact = (np.array([1.0, 0.0, 2.0], np.float32),
             np.array([3.0, 0.0, 2.0], np.float32),
             np.array([2.0, 0.0, 2.0], np.float32))
    assert singlepass.hit_lanes(edges, exact).tolist() == [True] * 3
    exact[1][0] = 4.0
    hits = singlepass.hit_lanes(edges, exact)
    assert hits.tolist() == [False, True, True]
    res_f = {"counts": np.ones((3, 2), np.int32), "abs_dev": np.ones(3)}
    res_s = {"counts": np.full((1, 2), 7, np.int32),
             "abs_dev": np.full(1, 9.0)}
    out = singlepass.merge_rebinned(res_f, res_s, np.nonzero(~hits)[0])
    assert out["counts"].tolist() == [[7, 7], [1, 1], [1, 1]]
    assert out["abs_dev"].tolist() == [9.0, 1.0, 1.0]


# ---------------------------------------------------------------------------
# K4 on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("kernel K4 runs only on a CUDA device")
    return torch.device("cuda:0")


@pytest.mark.cuda
@pytest.mark.parametrize("cols,nbins", [(37, 1), (200, 10), (512, 100),
                                        (200, 8192)])
def test_k4_is_k1_then_k2_on_card(cuda_device, cols, nbins):
    x, rv, shift, lo, hi, mean = _ab_inputs(cols, 65536, nbins, seed=cols)
    t = [torch.from_numpy(np.ascontiguousarray(a)).to(cuda_device)
         for a in (x, rv, shift, lo, hi, mean)]
    got = fused.tiles_ab_cuda(*t, nbins)
    two = fused.tiles_cuda(*t[:3]) + hist.histogram_cuda(t[0], t[1], *t[3:],
                                                         nbins)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, two))


@pytest.mark.cuda
@pytest.mark.parametrize("cols,nbins", [(37, 10), (200, 100)])
def test_k4_matches_plain_on_card(cuda_device, cols, nbins):
    x, rv, shift, lo, hi, mean = _ab_inputs(cols, 65536, nbins, seed=cols)
    t = [torch.from_numpy(np.ascontiguousarray(a)).to(cuda_device)
         for a in (x, rv, shift, lo, hi, mean)]
    got = fused.tiles_ab_cuda(*t, nbins)
    again = fused.tiles_ab_cuda(*t, nbins)
    ref = fused.tiles_ab_plain(*t, nbins)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    for i in (1, 5, 6):                     # counts, N, histogram
        assert torch.equal(got[i], ref[i])
    assert torch.equal(got[0][:, 4:], ref[0][:, 4:])
    np.testing.assert_allclose(got[7].cpu().numpy(), ref[7].cpu().numpy(),
                               rtol=5e-4)
