"""The cross-process laws of the port
(``tpuprof_torch/runtime/distributed.py``) against the reference's, in one
process.

The same parts, made from one seed, fold through each package's
``merge_*_parts``: finalized pass-A, pass-B and Gram states (each half of a
batch folded by the port's ``Runner`` on the CPU; the merge equals one fold
of the whole batch), recount vectors, row samplers, Misra-Gries summaries
and exact-unique trackers (``merge``, ``disown_runs``, ``claim_runs``,
``seed_resolution``); ``_merge_pair`` of two ``HostAgg``s equals one over
the whole table.  ``assign_fragments`` stripes as the reference does,
``merge_shift_estimates`` skips empty stripes, every gather is a no-op in
one process (also in a gloo group of one), the watched gather raises
``WatchdogTimeout`` at its site.  Then the fleet's config fields (no longer
refused, the reference's defaults, checks and env twins) and the
``profile`` verb's flags.
"""

import dataclasses

import jax  # noqa: F401  (JAX stays on the CPU: tests/conftest.py)
import numpy as np
import pandas as pd
import pytest
import torch

from tpuprof import config as ref_config
from tpuprof.ingest.sample import RowSampler as RefSampler
from tpuprof.kernels.topk import MisraGries as RefMG
from tpuprof.kernels.unique import UniqueTracker as RefTracker
from tpuprof.runtime import distributed as ref_dist
from tpuprof_torch import ProfilerConfig
from tpuprof_torch import config as port_config
from tpuprof_torch.backends.gpu import HostAgg
from tpuprof_torch.errors import WatchdogTimeout
from tpuprof_torch.ingest.arrow import ArrowIngest, prepare_batch
from tpuprof_torch.ingest.sample import RowSampler
from tpuprof_torch.kernels import unique
from tpuprof_torch.kernels.topk import MisraGries
from tpuprof_torch.runtime import distributed as dist
from tpuprof_torch.runtime.runner import Runner
from tpuprof_torch.testing import faults
from torch_route import same_hash_route  # noqa: F401  (autouse)

RTOL, ATOL = 5e-4, 1e-5
C, R = 6, 2048


def _batch(seed=3):
    rng = np.random.default_rng(seed)
    x = rng.normal(10, 3, (C, R)).astype(np.float32)
    x[1, rng.random(R) < 0.1] = np.nan
    x[2, :7] = np.inf
    rv = np.ones(R, dtype=bool)
    rv[-5:] = False
    return x, rv


def _fold(kind, x, rv, shift):
    runner = Runner(ProfilerConfig(bins=7), C, 0, "cpu")
    xt = torch.from_numpy(np.ascontiguousarray(x))
    rvt = torch.from_numpy(np.ascontiguousarray(rv))
    if kind == "a":
        st = runner._fold_a(runner.init_pass_a(shift), xt, rvt,
                            torch.zeros((0, x.shape[1]), dtype=torch.int16))
        return runner.finalize(st)
    if kind == "b":
        lo = torch.full((C,), 0.0)
        hi = torch.full((C,), 20.0)
        mean = torch.full((C,), 10.0)
        return runner.finalize(runner._fold_b(runner.init_pass_b(), xt,
                                              rvt, lo, hi, mean))
    grid = torch.from_numpy(np.sort(
        np.random.default_rng(1).normal(10, 3, (C, 64)).astype(np.float32),
        axis=1))
    return runner.finalize(runner._fold_spearman(
        runner.init_spearman(), xt, rvt, grid))


def _close(a, b, path=""):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _close(a[k], b[k], f"{path}/{k}")
        return
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype.kind in "iub":
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL,
                                   err_msg=path)


def _halves(kind, shift):
    x, rv = _batch()
    h = R // 2
    parts = [_fold(kind, x[:, :h], rv[:h], shift),
             _fold(kind, x[:, h:], rv[h:], shift)]
    return parts, _fold(kind, x, rv, shift)


@pytest.mark.parametrize("shifts", ["agreed", "differ"])
def test_pass_a_parts_merge_like_the_reference(shifts):
    if shifts == "agreed":
        parts, whole = _halves("a", np.full(C, 10.0, np.float32))
    else:
        x, rv = _batch()
        h = R // 2
        parts = [_fold("a", x[:, :h], rv[:h], np.full(C, 9.0, np.float32)),
                 _fold("a", x[:, h:], rv[h:], np.full(C, 11.0, np.float32))]
        whole = _fold("a", x, rv, np.full(C, 9.0, np.float32))
    mine = dist.merge_pass_a_parts([dict(p) for p in parts])
    ref = ref_dist.merge_pass_a_parts([dict(p) for p in parts])
    _close(mine, ref)
    _close(mine, whole)


@pytest.mark.parametrize("kind", ["b", "spear"])
def test_pass_b_and_gram_parts_merge_like_the_reference(kind):
    parts, whole = _halves(kind, None)
    if kind == "b":
        mine = dist.merge_pass_b_parts([dict(p) for p in parts])
        ref = ref_dist.merge_pass_b_parts([dict(p) for p in parts])
    else:
        mine = dist.merge_corr_parts([dict(p) for p in parts])
        ref = ref_dist.merge_corr_parts([dict(p) for p in parts])
    _close(mine, ref)
    _close(mine, whole)


def test_recount_parts_sum_like_the_reference():
    rng = np.random.default_rng(5)
    parts = [{"c": rng.integers(0, 9, 4), "d": rng.integers(0, 9, 2)}
             for _ in range(3)]
    mine = dist.merge_recount_parts([dict(p) for p in parts])
    ref = ref_dist.merge_recount_parts([dict(p) for p in parts])
    assert {k: v.tolist() for k, v in mine.items()} == \
        {k: v.tolist() for k, v in ref.items()}


def test_sampler_parts_merge_like_the_reference():
    rng = np.random.default_rng(7)
    mine, ref = [], []
    for pi in range(3):
        a, b = RowSampler(64, 2, seed=1, process_index=pi), \
            RefSampler(64, 2, seed=1, process_index=pi)
        for _ in range(3):
            x = rng.normal(size=(50, 2)).astype(np.float32)
            a.update(x, 50)
            b.update(x, 50)
        mine.append(a)
        ref.append(b)
    m = dist.merge_sampler_parts(mine).columns()
    r = ref_dist.merge_sampler_parts(ref).columns()
    np.testing.assert_array_equal(np.sort(m[0], axis=1),
                                  np.sort(r[0], axis=1))


def test_misra_gries_merges_like_the_reference():
    rng = np.random.default_rng(9)
    mine, ref = [MisraGries(8) for _ in range(2)], [RefMG(8) for _ in
                                                     range(2)]
    for k in range(2):
        vals = np.array([f"v{i}" for i in rng.integers(0, 20, 400)],
                        dtype=object)
        u, c = np.unique(vals, return_counts=True)
        mine[k].update_batch(u, c)
        ref[k].update_batch(u, c)
    mine[0].merge(mine[1])
    ref[0].merge(ref[1])
    assert mine[0].top(8) == ref[0].top(8)
    assert (mine[0].offset, mine[0].overflowed) == \
        (ref[0].offset, ref[0].overflowed)
    with pytest.raises(RuntimeError, match="merge"):
        mine[0].update_batch(np.array(["z"], dtype=object), np.array([1]))


def _streams(seed, n, dup_at=None):
    rng = np.random.default_rng(seed)
    h = rng.integers(1, 2 ** 63, n, dtype=np.uint64)
    if dup_at is not None:
        h[dup_at] = h[0]
    return h


@pytest.mark.parametrize("count_exact", [False, True])
@pytest.mark.parametrize("cross_dup", [False, True])
def test_tracker_merge_like_the_reference(tmp_path, count_exact, cross_dup):
    """Two processes' trackers (300-row budget, a shared spill dir, so each
    spills) merge to the reference's statuses and counts; a duplicate only
    the union holds is found."""
    a_h, b_h = _streams(1, 2000), _streams(2, 1500)
    if cross_dup:
        b_h[-1] = a_h[5]
    out = []
    for cls in (unique.UniqueTracker, RefTracker):
        spill = tmp_path / cls.__module__.split(".")[0]
        spill.mkdir()
        ts = [cls(["u"], 300, 10 ** 6, spill_dir=str(spill),
                  count_exact=count_exact) for _ in range(2)]
        for t, h in zip(ts, (a_h, b_h)):
            for lo in range(0, h.size, 250):
                t.update("u", h[lo:lo + 250], hash_kind="native")
        ts[0].merge(ts[1])
        out.append((ts[0].resolve(), ts[0].distinct_counts()))
        for t in ts:
            t.cleanup()
    assert out[0] == out[1]
    assert out[0][0]["u"] == (unique.DUP if cross_dup else unique.UNIQUE)
    if count_exact:
        assert out[0][1]["u"] == 3500 - cross_dup


def test_tracker_run_ownership_and_seeded_resolution(tmp_path):
    ts = [unique.UniqueTracker(["u"], 300, 10 ** 6,
                               spill_dir=str(tmp_path)) for _ in range(2)]
    for t, h in zip(ts, (_streams(3, 900), _streams(4, 900))):
        for lo in range(0, 900, 300):
            t.update("u", h[lo:lo + 300], hash_kind="native")
    merged = ts[0]
    merged.merge(ts[1])
    ts[1].disown_runs()
    assert ts[1]._owned == []
    merged.claim_runs()
    runs = [p for p, _ in merged._runs["u"]]
    assert sorted(merged._owned) == sorted(runs) and len(runs) >= 3
    reads = []
    real = merged._run_layout
    merged._run_layout = lambda *a: reads.append(a) or real(*a)
    merged.seed_resolution({"u": unique.DUP})
    assert merged.resolve() == {"u": unique.DUP} and reads == []
    merged.cleanup()


def test_merge_pair_of_halves_equals_the_whole():
    rng = np.random.default_rng(2)
    n = 1200
    df = pd.DataFrame({
        "a": rng.normal(size=n), "c": rng.choice(["x", "y", None], n),
        "d": pd.Timestamp("2024-01-01") + pd.to_timedelta(
            rng.integers(0, 10 ** 6, n), unit="s")})
    cfg = ProfilerConfig()

    def agg(frame):
        ingest = ArrowIngest(frame, 400)
        h = HostAgg(ingest.plan, cfg)
        for rb in ingest.raw_batches():
            h.update(prepare_batch(rb, ingest.plan, 400))
        return h
    whole = agg(df)
    merged = dist.merge_host_agg_parts([agg(df.iloc[:500]),
                                        agg(df.iloc[500:])])
    assert merged.n_rows == whole.n_rows == n
    assert merged.cat_null == whole.cat_null
    assert merged.date_null == whole.date_null
    assert (merged.date_min, merged.date_max) == \
        (whole.date_min, whole.date_max)
    assert dict(merged.mg["c"].top(5)) == dict(whole.mg["c"].top(5))
    assert merged.first_values == whole.first_values
    assert merged.unique.resolve() == whole.unique.resolve()


@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_fragments_stripe_like_the_reference(n):
    frags = list(range(11))
    for i in range(n):
        assert list(dist.assign_fragments(frags, i, n)) == \
            list(ref_dist.assign_fragments(frags, i, n))
    assert sorted(k for i in range(n)
                  for k in dist.assign_fragments(frags, i, n)) == frags


def test_shift_agreement_skips_empty_stripes(monkeypatch):
    parts = [None, np.array([1.0, 2.0], np.float32), None,
             np.array([3.0, 6.0], np.float32)]
    monkeypatch.setattr(dist, "allgather_objects", lambda obj: parts)
    monkeypatch.setattr(ref_dist, "allgather_objects", lambda obj: parts)
    mine = dist.merge_shift_estimates(None)
    np.testing.assert_array_equal(mine, ref_dist.merge_shift_estimates(None))
    np.testing.assert_array_equal(mine, [2.0, 4.0])
    assert mine.dtype == np.float32
    monkeypatch.setattr(dist, "allgather_objects", lambda obj: [None, None])
    assert dist.merge_shift_estimates(None) is None


def test_one_process_gathers_are_no_ops():
    assert dist.process_info() == (0, 1)
    obj = {"x": 1}
    assert dist.allgather_objects(obj) == [obj]
    state = {"counts": np.ones(3)}
    assert dist.merge_pass_a_states(state) is state
    assert dist.merge_pass_b_states(state) is state
    assert dist.merge_corr_states(state) is state
    t = unique.UniqueTracker(["u"], 10, 100)
    dist.resolve_unique_distributed(t)
    assert t._resolve_memo == {}


def test_a_gloo_group_of_one(tmp_path):
    dist.initialize(f"file://{tmp_path}/rdv", 1, 0, timeout_s=30)
    try:
        assert dist.process_info() == (0, 1)
        assert dist.allgather_objects("x") == ["x"]
        dist.initialize(f"file://{tmp_path}/rdv", 1, 0)   # a no-op now
    finally:
        dist.shutdown()
    assert dist.process_info() == (0, 1)
    dist.initialize(None, None, None)       # single-process: nothing


def test_watched_gather_times_out_at_its_site():
    faults.configure("barrier:sleep=2", seed=0)
    try:
        with pytest.raises(WatchdogTimeout) as err:
            dist.allgather_with_watchdog(1, 0.2, site="resume_barrier",
                                         heartbeat=lambda: {"rank": 0})
        assert err.value.site == "resume_barrier"
        assert err.value.heartbeat == {"rank": 0}
        faults.reset()
        assert dist.allgather_with_watchdog(3, 5.0) == [3]
    finally:
        faults.reset()


def test_publish_fleet_alone_is_the_fleet_of_one(tmp_path):
    from tpuprof_torch.obs import fleet, metrics
    path = dist.publish_fleet("collect", metrics_path=str(tmp_path / "m"),
                              quarantined=2)
    assert path == str(tmp_path / "m.fleet.prom")
    one = fleet.write_fleet(str(tmp_path / "one"),
                            [metrics.registry().to_wire()],
                            quarantined_by_host=[2])
    assert open(path).read() == open(one).read()


# ---------------------------------------------------------------------------
# the fleet's config fields and flags
# ---------------------------------------------------------------------------

FIELDS = {"mesh_devices": 2, "barrier_timeout_s": 5.0, "elastic": True,
          "fleet_dir": "/shared/f", "fleet_host_id": "slot-1",
          "liveness_timeout_s": 2.5}


@pytest.mark.parametrize("field", sorted(FIELDS))
def test_fleet_fields_are_ported(field):
    assert field not in port_config._LATER
    cfg = ProfilerConfig(**{field: FIELDS[field]})
    assert getattr(cfg, field) == FIELDS[field]
    ref_default = {f.name: f.default for f in
                   dataclasses.fields(ref_config.ProfilerConfig)}[field]
    assert getattr(ProfilerConfig(), field) == ref_default


@pytest.mark.parametrize("field,bad", [("liveness_timeout_s", 0),
                                       ("barrier_timeout_s", 0),
                                       ("barrier_timeout_s", -1.0),
                                       ("mesh_devices", 0)])
def test_fleet_fields_are_checked(field, bad):
    with pytest.raises(ValueError, match=field):
        ProfilerConfig(**{field: bad})


def test_env_twins_round_trip_like_the_reference(monkeypatch):
    for var in ("TPUPROF_ELASTIC", "TPUPROF_FLEET_DIR",
                "TPUPROF_FLEET_HOST_ID", "TPUPROF_LIVENESS_TIMEOUT_S"):
        monkeypatch.delenv(var, raising=False)
    assert port_config.resolve_elastic(None) is False
    assert port_config.resolve_liveness_timeout(None) == 10.0
    assert port_config.resolve_fleet_dir(None) is None
    for env, value in (("TPUPROF_ELASTIC", "1"), ("TPUPROF_ELASTIC", "0"),
                       ("TPUPROF_ELASTIC", "no"),
                       ("TPUPROF_FLEET_DIR", "/shared/f"),
                       ("TPUPROF_FLEET_HOST_ID", "slot-3"),
                       ("TPUPROF_LIVENESS_TIMEOUT_S", "2.5")):
        monkeypatch.setenv(env, value)
        for name in ("resolve_elastic", "resolve_fleet_dir",
                     "resolve_fleet_host_id", "resolve_liveness_timeout"):
            assert getattr(port_config, name)(None) == \
                getattr(ref_config, name)(None), (env, value, name)
    assert port_config.resolve_elastic(True) is True
    assert port_config.resolve_fleet_dir("/x") == "/x"
    assert port_config.resolve_fleet_host_id("me") == "me"
    assert port_config.resolve_liveness_timeout(9.0) == 9.0
    monkeypatch.setenv("TPUPROF_BARRIER_TIMEOUT_S", "7")
    assert port_config.resolve_watchdog_timeout(
        None, "TPUPROF_BARRIER_TIMEOUT_S") == 7.0


def test_profile_flags_parse_with_the_reference_defaults():
    from tpuprof.cli import build_parser as ref_parser
    from tpuprof_torch.cli import build_parser
    argv = ["profile", "x.parquet", "--elastic", "--fleet-dir", "/f",
            "--fleet-host-id", "h7", "--liveness-timeout", "3",
            "--barrier-timeout", "9", "--coordinator", "10.0.0.1:8476",
            "--num-processes", "4", "--process-id", "2"]
    mine, ref = build_parser().parse_args(argv), ref_parser().parse_args(argv)
    keys = ("elastic", "fleet_dir", "fleet_host_id", "liveness_timeout",
            "barrier_timeout", "coordinator", "num_processes",
            "process_id")
    assert {k: getattr(mine, k) for k in keys} == \
        {k: getattr(ref, k) for k in keys}
    bare = build_parser().parse_args(["profile", "x.parquet"])
    bare_ref = ref_parser().parse_args(["profile", "x.parquet"])
    assert {k: getattr(bare, k) for k in keys} == \
        {k: getattr(bare_ref, k) for k in keys}
    assert bare.elastic is None
