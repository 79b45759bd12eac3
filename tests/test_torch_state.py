"""State monoids and host sketches of the PyTorch port against the reference.

Moments, corr, histogram and HLL functions of ``tpuprof_torch`` against
``tpuprof.kernels.*`` on the same numpy inputs (adversarial values
included); the host copies (native hashing, packing, row sample,
Misra-Gries, batch preparation) bit for bit; and ``state_from_numpy``
carrying a state the reference folded — per device, as its mesh runner
holds it — into the port to finish the fold."""

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pyarrow as pa
import pytest
import torch

from tpuprof import ProfilerConfig as RefConfig
from tpuprof.ingest import arrow as ref_arrow
from tpuprof.ingest.sample import RowSampler as RefSampler
from tpuprof.kernels import corr as ref_corr
from tpuprof.kernels import fused as ref_fused
from tpuprof.kernels import hll as ref_hll
from tpuprof.kernels import moments as ref_moments
from tpuprof.kernels.topk import MisraGries as RefMG
from tpuprof.runtime.mesh import MeshRunner
from tpuprof_torch import native
from tpuprof_torch.ingest import arrow as port_arrow
from tpuprof_torch.ingest.sample import RowSampler
from tpuprof_torch.kernels import corr, fused, hll, moments
from tpuprof_torch.kernels.topk import MisraGries
from tpuprof_torch.runtime.runner import (Runner, state_from_numpy,
                                          state_to_numpy)
from tpuprof_torch.config import ProfilerConfig
from torch_route import same_hash_route  # noqa: F401  (autouse)

MOM_EXACT = ("n", "n_zeros", "n_inf", "n_missing", "min", "max", "fmin",
             "fmax")
MOM_CLOSE = ("mean", "variance", "skewness", "kurtosis", "sum")


def _batch(rows, cols, seed, mean=50.0, scale=10.0):
    rng = np.random.default_rng(seed)
    x = rng.normal(mean, scale, (rows, cols)).astype(np.float32)
    x[rng.random((rows, cols)) < 0.07] = np.nan
    x[rng.random((rows, cols)) < 0.01] = np.inf
    x[rng.random((rows, cols)) < 0.01] = -np.inf
    x[rng.random((rows, cols)) < 0.03] = 0.0
    x[:, 0] = np.nan                          # an all-missing column
    rv = np.ones(rows, dtype=bool)
    rv[-max(rows // 10, 1):] = False
    return x, rv


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _assert_mom(fp, fr):
    for k in MOM_EXACT:
        np.testing.assert_array_equal(fp[k], fr[k], err_msg=k)
    for k in MOM_CLOSE:
        np.testing.assert_allclose(fp[k], fr[k], rtol=5e-4, atol=1e-5,
                                   equal_nan=True, err_msg=k)


def _assert_rho(a, b):
    np.testing.assert_allclose(a, b, rtol=0, atol=5e-4, equal_nan=True)


# ---------------------------------------------------------------------------
# moments / corr
# ---------------------------------------------------------------------------

def test_moments_update_merge_finalize_match_reference():
    (x1, r1), (x2, r2) = _batch(300, 6, 1), _batch(200, 6, 2, mean=-7.0)
    pa_ = moments.update(moments.init(6), _t(x1), _t(r1))
    pb = moments.update(moments.init(6), _t(x2), _t(r2))
    ra = ref_moments.update(ref_moments.init(6), jnp.asarray(x1),
                            jnp.asarray(r1))
    rb = ref_moments.update(ref_moments.init(6), jnp.asarray(x2),
                            jnp.asarray(r2))
    _assert_mom(moments.finalize(pa_), ref_moments.finalize(
        jax.device_get(ra)))
    _assert_mom(moments.finalize(moments.merge(pa_, pb)),
                ref_moments.finalize(jax.device_get(
                    ref_moments.merge(ra, rb))))


def test_moments_rebase_matches_reference():
    x, rv = _batch(400, 5, 3)
    st = moments.update(moments.init(5), _t(x), _t(rv))
    rs = ref_moments.update(ref_moments.init(5), jnp.asarray(x),
                            jnp.asarray(rv))
    target = np.linspace(-3, 80, 5).astype(np.float32)
    got = moments.rebase(st, _t(target))
    ref = ref_moments.rebase(rs, jnp.asarray(target))
    for k in ("s1", "s2", "s3", "s4"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   rtol=5e-4, atol=1e-3, err_msg=k)
    _assert_mom(moments.finalize(got), moments.finalize(st))


def test_corr_update_merge_rebase_finalize_match_reference():
    (x1, r1), (x2, r2) = _batch(300, 7, 4), _batch(250, 7, 5, mean=20.0)
    pa_ = corr.update(corr.init(7), _t(x1), _t(r1))
    pb = corr.update(corr.init(7), _t(x2), _t(r2))
    ra = ref_corr.update(ref_corr.init(7), jnp.asarray(x1), jnp.asarray(r1))
    rb = ref_corr.update(ref_corr.init(7), jnp.asarray(x2), jnp.asarray(r2))
    np.testing.assert_array_equal(pa_["N"].numpy(), np.asarray(ra["N"]))
    _assert_rho(corr.finalize(pa_), ref_corr.finalize(jax.device_get(ra)))
    merged = corr.merge(pa_, pb)
    rmerged = ref_corr.merge(ra, rb)
    np.testing.assert_array_equal(merged["N"].numpy(),
                                  np.asarray(rmerged["N"]))
    _assert_rho(corr.finalize(merged),
                ref_corr.finalize(jax.device_get(rmerged)))
    target = np.full(7, 3.5, dtype=np.float32)
    _assert_rho(corr.finalize(corr.rebase(merged, _t(target))),
                ref_corr.finalize(jax.device_get(
                    ref_corr.rebase(rmerged, jnp.asarray(target)))))


# ---------------------------------------------------------------------------
# HLL and host copies
# ---------------------------------------------------------------------------

def test_hll_pack_update_finalize_match_reference():
    rng = np.random.default_rng(6)
    h = rng.integers(0, 2 ** 63, (500, 4), dtype=np.int64).astype(np.uint64)
    h[:, 1] = h[:50, 1].repeat(10)             # a low-cardinality column
    valid = rng.random((500, 4)) > 0.1
    for p in (4, 11):
        packed = hll.pack(h, valid, p)
        np.testing.assert_array_equal(packed, ref_hll.pack(h, valid, p))
        regs = hll.update(hll.init(4, p), _t(packed.view(np.int16)))
        rregs = ref_hll.update(ref_hll.init(4, p), jnp.asarray(packed))
        np.testing.assert_array_equal(regs.numpy(), np.asarray(rregs))
        host = hll.HostRegisters(4, p)
        host.update(packed, 500)
        np.testing.assert_array_equal(host.regs, regs.numpy())
        np.testing.assert_array_equal(hll.finalize(regs),
                                      ref_hll.finalize(np.asarray(rregs)))


def test_native_hashes_are_the_reference_bits():
    from tpuprof import native as ref_native
    keys = np.random.default_rng(7).integers(
        0, 2 ** 63, 1000, dtype=np.int64).astype(np.uint64)
    if not (native.available() and ref_native.available()):
        pytest.skip("host C++ compiler unavailable: no native hashes")
    np.testing.assert_array_equal(native.hash_u64_array(keys),
                                  ref_native.hash_u64_array(keys))
    strings = pa.array(["a", "bb", None, "ccc", "", "é"] * 10)
    np.testing.assert_array_equal(native.hash_string_dictionary(strings),
                                  ref_native.hash_string_dictionary(strings))


def test_row_sampler_and_misra_gries_match_reference():
    x, _ = _batch(3000, 4, 8)
    mine, ref = RowSampler(256, 4, seed=3), RefSampler(256, 4, seed=3)
    for lo in range(0, 3000, 700):
        mine.update(x[lo:lo + 700], min(700, 3000 - lo))
        ref.update(x[lo:lo + 700], min(700, 3000 - lo))
    probes = [0.05, 0.5, 0.95]
    np.testing.assert_array_equal(mine.quantiles(probes),
                                  ref.quantiles(probes))
    rng = np.random.default_rng(9)
    mg, rmg = MisraGries(8), RefMG(8)
    for _ in range(5):
        vals = np.array([f"v{i}" for i in rng.integers(0, 30, 40)],
                        dtype=object)
        u, c = np.unique(vals, return_counts=True)
        mg.update_batch(u, c)
        rmg.update_batch(u, c)
    assert mg.top(8) == rmg.top(8)
    assert mg.distinct_count() == rmg.distinct_count()


def test_prepared_batches_match_reference_planes():
    rng = np.random.default_rng(10)
    n = 700
    df = pd.DataFrame({
        "f": rng.normal(0, 1, n), "i": rng.integers(-5, 5, n),
        "b": rng.random(n) < 0.5,
        "s": rng.choice(["x", "y", None], n),
        "t": pd.Timestamp("2020-01-01") + pd.to_timedelta(
            rng.integers(0, 10 ** 6, n), unit="s"),
        "f32": rng.normal(0, 1, n).astype(np.float32)})
    table = pa.Table.from_pandas(df, preserve_index=False)
    rb = table.to_batches()[0]
    plan = port_arrow.ColumnPlan.from_schema(table.schema)
    rplan = ref_arrow.ColumnPlan.from_schema(table.schema)
    mine = port_arrow.prepare_batch(rb, plan, 1024, 11)
    ref = ref_arrow.prepare_batch(rb, rplan, 1024, 11)
    np.testing.assert_array_equal(mine.x, ref.x)
    np.testing.assert_array_equal(mine.hll, ref.hll)
    np.testing.assert_array_equal(mine.row_valid, ref.row_valid)
    assert mine.col_nbytes == ref.col_nbytes
    for name, (codes, dvals) in ref.cat_codes.items():
        np.testing.assert_array_equal(mine.cat_codes[name][0], codes)
        np.testing.assert_array_equal(mine.cat_codes[name][1], dvals)
    assert mine.x.flags.f_contiguous


# ---------------------------------------------------------------------------
# states carried across
# ---------------------------------------------------------------------------

def _ref_state(cols, shift):
    mom = ref_moments.init(cols)
    mom["shift"] = jnp.asarray(shift)
    co = ref_corr.init(cols)
    co["shift"] = jnp.asarray(shift)
    co["set"] = jnp.ones((), dtype=jnp.int32)
    return mom, co


def test_fold_half_in_reference_half_in_port():
    cols = 6
    batches = [_batch(400, cols, 20 + i) for i in range(4)]
    shift = np.full(cols, 50.0, dtype=np.float32)
    full = _ref_state(cols, shift)
    for x, rv in batches:
        full = ref_fused.update(*full, jnp.asarray(x.T), jnp.asarray(rv),
                                interpret=True)
    half = _ref_state(cols, shift)
    for x, rv in batches[:2]:
        half = ref_fused.update(*half, jnp.asarray(x.T), jnp.asarray(rv),
                                interpret=True)
    tree = jax.device_get({"mom": half[0], "corr": half[1],
                           "hll": ref_hll.init(2, 4)})
    st = state_from_numpy(tree, "cpu")
    for x, rv in batches[2:]:
        mom, co = fused.update(st["mom"], st["corr"], _t(x.T), _t(rv))
        st = {"mom": mom, "corr": co, "hll": st["hll"]}
    _assert_mom(moments.finalize(st["mom"]),
                ref_moments.finalize(jax.device_get(full[0])))
    _assert_rho(corr.finalize(st["corr"]),
                ref_corr.finalize(jax.device_get(full[1])))
    back = state_to_numpy(st)
    assert set(back) == {"mom", "corr", "hll"}
    assert isinstance(back["mom"]["s1"], np.ndarray)


def test_stacked_mesh_state_folds_by_the_merge_law():
    """A state from the reference's mesh runner (leading per-device axis,
    rows sharded over the CPU devices) folds into one port state equal to
    the reference's own collective merge."""
    cols, n_hash = 5, 2
    cfg = RefConfig(backend="tpu", batch_rows=512)
    mesh = MeshRunner(cfg, cols, n_hash)
    x, rv = _batch(512, cols, 30)
    hb = ref_arrow.HostBatch(
        nrows=int(rv.sum()), x=np.asfortranarray(x), row_valid=rv,
        hll=np.asfortranarray(np.random.default_rng(1).integers(
            1, 2 ** 16, (512, n_hash)).astype(np.uint16)),
        cat_codes={}, date_ints={})
    state = mesh.step_a(mesh.init_pass_a(np.full(cols, 40.0, np.float32)),
                        hb)
    stacked = jax.device_get(state)
    assert stacked["mom"]["n"].ndim == 2 and stacked["mom"]["n"].shape[0] > 1
    folded = state_from_numpy(stacked, "cpu")
    merged = mesh.finalize_a(state)
    _assert_mom(moments.finalize(folded["mom"]),
                ref_moments.finalize(merged["mom"]))
    _assert_rho(corr.finalize(folded["corr"]),
                ref_corr.finalize(merged["corr"]))
    np.testing.assert_array_equal(folded["corr"]["N"].numpy(),
                                  np.asarray(merged["corr"]["N"]))
    np.testing.assert_array_equal(folded["hll"].numpy(),
                                  np.asarray(merged["hll"]))
    sb = mesh.init_pass_b()
    sb = mesh.step_b(sb, hb, np.zeros(cols, np.float32),
                     np.full(cols, 100, np.float32),
                     np.full(cols, 50, np.float32))
    pb = state_from_numpy(jax.device_get(sb), "cpu")
    mb = mesh.finalize_b(sb)
    np.testing.assert_array_equal(pb["counts"].numpy(), mb["counts"])
    np.testing.assert_allclose(pb["abs_dev"].numpy(), mb["abs_dev"],
                               rtol=5e-4)


def test_runner_staged_and_per_batch_folds_give_same_bits():
    cols = 4
    cfg = ProfilerConfig(batch_rows=256)
    runner = Runner(cfg, cols, 1, "cpu")
    hbs = []
    for i in range(3):
        x, rv = _batch(256, cols, 40 + i)
        hbs.append(port_arrow.HostBatch(
            nrows=int(rv.sum()), x=np.asfortranarray(x), row_valid=rv,
            hll=np.zeros((256, 1), np.uint16, order="F"), cat_codes={},
            date_ints={}))
    shift = np.full(cols, 50.0, np.float32)
    a = runner.scan_a(runner.init_pass_a(shift), runner.stage_batches(hbs))
    b = runner.init_pass_a(shift)
    for hb in hbs:
        b = runner.step_a(b, runner.put_batch(hb))
    for part in ("mom", "corr"):
        for k in a[part]:
            assert torch.equal(a[part][k], b[part][k]), (part, k)
    lo, hi, mean = runner.bounds_b_device(a)
    sa = runner.scan_b(runner.init_pass_b(), runner.stage_batches(
        hbs, with_hll=False), lo, hi, mean)
    sb = runner.init_pass_b()
    for hb in hbs:
        sb = runner.step_b(sb, runner.put_batch(hb, with_hll=False),
                           lo, hi, mean)
    assert torch.equal(sa["counts"], sb["counts"])
    assert torch.equal(sa["abs_dev"], sb["abs_dev"])


# ---------------------------------------------------------------------------
# the Spearman state carried across
# ---------------------------------------------------------------------------

def _host_batch(module, x, rv, n_hash=2):
    return module.HostBatch(
        nrows=int(rv.sum()), x=np.asfortranarray(x), row_valid=rv,
        hll=np.asfortranarray(np.random.default_rng(1).integers(
            1, 2 ** 16, (x.shape[0], n_hash)).astype(np.uint16)),
        cat_codes={}, date_ints={})


def test_stacked_mesh_spearman_state_folds_by_the_merge_law():
    """A Spearman state from the reference's mesh runner (per device, each
    device centred on its own data) folds into one port state whose rho
    equals the reference's own collective merge."""
    cols = 5
    mesh = MeshRunner(RefConfig(backend="tpu", batch_rows=512), cols, 2)
    x, rv = _batch(512, cols, 31)
    sampler = RefSampler(4096, cols)
    sampler.update(x[rv], int(rv.sum()))
    srt, kept = sampler.sorted_padded()
    state = mesh.step_spearman(mesh.init_spearman(),
                               _host_batch(ref_arrow, x, rv), srt, kept)
    stacked = jax.device_get(state)
    assert stacked["N"].ndim == 3 and stacked["N"].shape[0] > 1
    folded = state_from_numpy(stacked, "cpu")
    merged = mesh.finalize_spearman(state)
    np.testing.assert_array_equal(folded["N"].numpy(),
                                  np.asarray(merged["N"]))
    _assert_rho(corr.finalize(folded), ref_corr.finalize(merged))


def test_spearman_fold_half_in_reference_half_in_port():
    """Two devices of the reference fold one grid-rank batch each (K5's
    reference, interpret mode); the port takes the stacked state and folds
    the rest through its runner: rho equals the reference's fold of all
    four batches."""
    cols = 6
    batches = [_batch(400, cols, 50 + i) for i in range(4)]
    sampler = RowSampler(4096, cols)
    for x, rv in batches:
        sampler.update(x[rv], int(rv.sum()))
    grid = sampler.cdf_grid(64)

    def ref_co():
        co = ref_corr.init(cols)
        co["shift"] = jnp.full((cols,), 0.5, dtype=jnp.float32)
        co["set"] = jnp.ones((), dtype=jnp.int32)
        return co

    def ref_fold(co, x, rv):
        return ref_fused.spearman_update(co, jnp.asarray(x.T),
                                         jnp.asarray(rv), jnp.asarray(grid),
                                         interpret=True)

    full = ref_co()
    for x, rv in batches:
        full = ref_fold(full, x, rv)
    per_device = [jax.device_get(ref_fold(ref_co(), x, rv))
                  for x, rv in batches[:2]]
    stacked = {k: np.stack([d[k] for d in per_device])
               for k in per_device[0]}
    runner = Runner(ProfilerConfig(batch_rows=400), cols, 2, "cpu")
    st = state_from_numpy(stacked, "cpu")
    grid_d = runner.put_replicated(grid)
    for x, rv in batches[2:]:
        st = runner.step_spearman_grid(
            st, runner.put_batch(_host_batch(port_arrow, x, rv)), grid_d)
    np.testing.assert_array_equal(st["N"].numpy(), np.asarray(full["N"]))
    _assert_rho(corr.finalize(runner.finalize_spearman(st)),
                ref_corr.finalize(jax.device_get(full)))
    again = state_from_numpy(state_to_numpy(st), "cpu")
    for k in st:
        assert torch.equal(again[k], st[k]), k


def test_runner_spearman_routes_by_width_and_stages_like_per_batch():
    """The runner's Spearman folds: one read (K5's plain version) up to
    512 columns, ranks then their Gram past it; a staged scan gives the
    same bits as per-batch steps; the state is a corr state about 0.5."""
    for cols in (4, fused.MAX_FUSED_COLS + 3):
        runner = Runner(ProfilerConfig(batch_rows=128), cols, 1, "cpu")
        hbs = [_host_batch(port_arrow, *_batch(128, cols, 60 + i), n_hash=1)
               for i in range(3)]
        sampler = RowSampler(4096, cols)
        for hb in hbs:
            sampler.update(hb.x[hb.row_valid], hb.nrows)
        grid = runner.put_replicated(sampler.cdf_grid(32))
        init = runner.init_spearman()
        assert torch.equal(init["shift"], torch.full((cols,), 0.5))
        assert int(init["set"]) == 1
        a = runner.scan_spearman_grid(init, runner.stage_batches(
            hbs, with_hll=False), grid)
        b = runner.init_spearman()
        for hb in hbs:
            b = runner.step_spearman_grid(b, runner.put_batch(
                hb, with_hll=False), grid)
        for k in a:
            assert torch.equal(a[k], b[k]), (cols, k)
        xt = torch.cat([runner.put_batch(hb).xt for hb in hbs], dim=1)
        rv = torch.cat([runner.put_batch(hb).row_valid for hb in hbs])
        one = fused.spearman_update_plain(runner.init_spearman(), xt, rv,
                                          grid)
        np.testing.assert_array_equal(a["N"].numpy(), one["N"].numpy())
        _assert_rho(corr.finalize(runner.finalize_spearman(a)),
                    corr.finalize(one))
