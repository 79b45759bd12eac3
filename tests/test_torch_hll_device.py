"""Pass A's HyperLogLog observations of float32 lanes made on the device.

On a CUDA runner the GPU backend leaves each float32 lane unhashed on the
host and folds its observations into the registers with ``hll_regs``
(``kernels/fused.py``, ``csrc/hll.cuh``).  Here, on the CPU, the plain
version stands for the kernel: the card route is forced by making the
runner report that it hashes on its device.  The registers must equal the
host's (``native.hash_pack_u64`` then ``HostRegisters.update``) bit for
bit, so a profile's answer is the same whichever lanes take which route,
at any prepare parallelism, through a checkpoint resume and in the fused
route; only float32 lanes may take it, and never with ``exact_distinct``.
"""

import json

import numpy as np
import pandas as pd
import pytest
import torch

import tpuprof_torch
from tpuprof_torch import native
from tpuprof_torch.backends import gpu
from tpuprof_torch.config import ProfilerConfig
from tpuprof_torch.ingest import arrow
from tpuprof_torch.kernels import fused, hll
from tpuprof_torch.obs import events, metrics
from tpuprof_torch.report.export import stats_to_json
from tpuprof_torch.runtime.mesh import MeshRunner
from tpuprof_torch.runtime.runner import Runner
from tpuprof_torch.testing import faults

BATCH = 256
N = 2000


@pytest.fixture(autouse=True)
def _clean():
    faults.reset()
    yield
    faults.reset()
    metrics.set_enabled(False)
    metrics.registry().reset()
    events.set_sink(None)


@pytest.fixture
def card_route(monkeypatch):
    """Runners report that they hash on their device: the CPU runner then
    takes the card route, with ``hll_regs``' plain version."""
    monkeypatch.setattr(Runner, "hashes_on_device", True)


# ---------------------------------------------------------------------------
# the plain version against the host route
# ---------------------------------------------------------------------------

def _adversarial(C, R, seed):
    """(x (C, R) float32, row_valid (R,)): NaN, -0.0 and +0.0, +-inf,
    subnormals (both signs), the float32 extremes, an all-null lane and
    padding rows (NaN in x, as the ingest pads)."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((C, R)) * 1e3).astype(np.float32)
    u = rng.random((C, R))
    x[u < 0.08] = np.nan
    x[(u >= 0.08) & (u < 0.12)] = -0.0
    x[(u >= 0.12) & (u < 0.16)] = 0.0
    x[(u >= 0.16) & (u < 0.18)] = np.inf
    x[(u >= 0.18) & (u < 0.20)] = -np.inf
    x[(u >= 0.20) & (u < 0.22)] = np.float32(1e-40)
    x[(u >= 0.22) & (u < 0.24)] = np.float32(-3e-42)
    x[(u >= 0.24) & (u < 0.25)] = np.finfo(np.float32).max
    x[(u >= 0.25) & (u < 0.26)] = np.finfo(np.float32).tiny
    x[2] = np.nan                                   # an all-null lane
    rv = np.ones(R, dtype=bool)
    rv[-R // 8:] = False
    x[:, -R // 8:] = np.nan
    return x, rv


def _host_regs(x, rv, p, pairs, n_hash):
    """The ingest's route: ``_num_keys``, the fused native hash and pack,
    padding rows 0, ``HostRegisters.update``."""
    packed = np.zeros((x.shape[1], n_hash), dtype=np.uint16, order="F")
    for num, h in pairs:
        v = x[num]
        got = native.hash_pack_u64(arrow._num_keys(v), ~np.isnan(v) & rv, p)
        assert got is not None, "the native hash library did not build"
        packed[:, h] = got
    regs = hll.HostRegisters(n_hash, p)
    regs.update(packed, x.shape[1])
    return regs.regs


@pytest.mark.parametrize("p", [4, 8, 11])
@pytest.mark.parametrize("R", [1024, 1021])
@pytest.mark.parametrize("mapping", ["same", "every_other_reversed"])
def test_plain_version_equals_the_host_route(p, R, mapping):
    C = 7
    x, rv = _adversarial(C, R, seed=p * 1000 + R)
    pairs = ([(c, c) for c in range(C)] if mapping == "same"
             else [(c, C - 1 - c) for c in range(0, C, 2)])
    want = _host_regs(x, rv, p, pairs, C)
    regs = hll.init(C, p)
    lanes = torch.tensor(pairs, dtype=torch.int32)
    xt, rvt = torch.from_numpy(np.ascontiguousarray(x)), torch.from_numpy(rv)
    got = fused.hll_regs(regs, xt, rvt, lanes)
    assert got is regs                              # in place
    np.testing.assert_array_equal(regs.numpy(), want)
    # max is idempotent: the same batch again moves nothing
    fused.hll_regs(regs, xt, rvt, lanes)
    np.testing.assert_array_equal(regs.numpy(), want)
    unmapped = sorted(set(range(C)) - {h for _, h in pairs})
    assert not regs[unmapped].any()


def test_hll_regs_refuses_what_the_kernel_does_not_take():
    regs, xt = hll.init(3, 11), torch.zeros((3, 8))
    rv, lanes = torch.ones(8, dtype=torch.bool), torch.zeros((1, 2),
                                                             dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        fused.hll_regs(regs, xt, rv, lanes.long())
    with pytest.raises(ValueError, match="float32"):
        fused.hll_regs(regs, xt.double(), rv, lanes)
    with pytest.raises(ValueError, match="registers"):
        fused.hll_regs(torch.zeros((3, 100), dtype=torch.int32), xt, rv,
                       lanes)
    with pytest.raises(ValueError, match="registers"):
        fused.hll_regs(hll.init(3, 12), xt, rv, lanes)
    with pytest.raises(ValueError, match="row_valid"):
        fused.hll_regs(regs, xt, rv[:4], lanes)


def test_host_registers_fold_only_their_runs():
    rng = np.random.default_rng(0)
    packed = rng.integers(1, 1 << 16, (500, 6)).astype(np.uint16)
    runs = hll.lane_runs(6, [1, 2, 5])
    assert runs == [(0, 1), (3, 5)]
    a = hll.HostRegisters(6, 11)
    a.update(packed, 400, runs)
    only = packed.copy()
    only[:, [1, 2, 5]] = 0
    b = hll.HostRegisters(6, 11)
    b.update(only, 400)
    np.testing.assert_array_equal(a.regs, b.regs)
    assert not a.regs[[1, 2, 5]].any()


def test_a_part_is_its_device_registers_raised_by_its_host_registers():
    dev = np.array([[0, 3, 0], [2, 0, 0]], dtype=np.int32)
    host = hll.HostRegisters(2, 0)
    host.regs = np.array([[1, 0, 0], [0, 0, 5]], dtype=np.int32)
    np.testing.assert_array_equal(
        gpu._part_regs({"res_a": {"hll": dev}, "host_hll": host}),
        [[1, 3, 0], [2, 0, 5]])
    np.testing.assert_array_equal(
        gpu._part_regs({"res_a": {"hll": dev}, "host_hll": None}), dev)


# ---------------------------------------------------------------------------
# which lanes take the card route
# ---------------------------------------------------------------------------

def _mixed(n=N, seed=0):
    """Every kind of lane: float32 (with -0.0, +-inf, subnormals and
    NaN), an all-null float32, float64, int64 with ids above 2^53, bool,
    a date, a dictionary-encoded string and a plain string."""
    rng = np.random.default_rng(seed)
    f32 = (rng.standard_normal(n) * 100).astype(np.float32)
    f32[::7] = -0.0
    f32[::11] = 0.0
    f32[::13] = np.inf
    f32[::17] = np.float32(2e-41)
    f32[::19] = np.nan
    return pd.DataFrame({
        "f32": f32,
        "f32_few": rng.integers(0, 40, n).astype(np.float32),
        "f32_null": np.full(n, np.nan, dtype=np.float32),
        "f64": rng.normal(size=n),
        "i64": (1 << 60) + rng.integers(0, 300, n),
        "flag": rng.random(n) > 0.3,
        "when": pd.Timestamp("2026-01-01")
        + pd.to_timedelta(rng.integers(0, 500, n), unit="min"),
        "cat": pd.Categorical(rng.choice(["a", "b", "c"], n)),
        "name": rng.choice([f"s{i}" for i in range(60)], n),
    })


def _plan(df):
    return arrow.ArrowIngest(df, BATCH).plan


def _hash_lane(plan, name):
    return next(s.hash_lane for s in plan.specs if s.name == name)


class _CardRunner:
    hashes_on_device = True


def test_only_float32_lanes_take_the_card_route():
    df = _mixed()
    plan = _plan(df)
    want = [(s.num_lane, s.hash_lane) for s in plan.specs
            if s.name in ("f32", "f32_few", "f32_null")]
    assert len(want) == 3
    assert gpu.device_hash_lanes(plan, ProfilerConfig(), _CardRunner(),
                                 True) == want
    assert {s.name for s in arrow.float32_hash_lanes(plan)} == {
        "f32", "f32_few", "f32_null"}


@pytest.mark.parametrize("why", ["exact_distinct", "cpu_runner", "mesh",
                                 "no_native_in_some_process"])
def test_every_lane_stays_on_the_host(why, tmp_path):
    plan = _plan(_mixed())
    config = ProfilerConfig(exact_distinct=(why == "exact_distinct"),
                            unique_spill_dir=str(tmp_path))
    runner = {"cpu_runner": lambda: Runner(config, plan.n_num, plan.n_hash,
                                           "cpu"),
              "mesh": lambda: MeshRunner(config, plan.n_num, plan.n_hash,
                                         ["cpu", "cpu"])}.get(
        why, _CardRunner)()
    assert gpu.device_hash_lanes(
        plan, config, runner, why != "no_native_in_some_process") == []


def test_prepare_leaves_device_lanes_unhashed():
    df = _mixed()
    ingest = arrow.ArrowIngest(df, BATCH)
    plan = ingest.plan
    rb = next(ingest.raw_batches())
    lanes = frozenset(s.hash_lane for s in arrow.float32_hash_lanes(plan))
    full = arrow.prepare_batch(rb, plan, BATCH)
    part = arrow.prepare_batch(rb, plan, BATCH, device_lanes=lanes)
    np.testing.assert_array_equal(part.x, full.x)
    np.testing.assert_array_equal(part.row_valid, full.row_valid)
    others = sorted(set(range(plan.n_hash)) - lanes)
    np.testing.assert_array_equal(part.hll[:, others], full.hll[:, others])
    assert not part.hll[:, sorted(lanes)].any()
    assert full.hll[:, _hash_lane(plan, "f32")].any()
    with pytest.raises(ValueError, match="not float32"):
        arrow.prepare_batch(rb, plan, BATCH, device_lanes=frozenset(
            {_hash_lane(plan, "f64")}))
    with pytest.raises(ValueError, match="full_hashes"):
        arrow.prepare_batch(rb, plan, BATCH, full_hashes=True,
                            device_lanes=lanes)


# ---------------------------------------------------------------------------
# whole profiles: the same answer whichever route
# ---------------------------------------------------------------------------

def _exported(stats) -> str:
    return json.dumps(stats_to_json(stats), sort_keys=True)


def _describe(df, **kw):
    kw.setdefault("batch_rows", BATCH)
    return tpuprof_torch.describe(df, device="cpu", **kw)


@pytest.fixture(scope="module")
def host_answer():
    df = _mixed()
    return df, _describe(df)


def _routed(before):
    return (hll.lanes_device - before[0], hll.lanes_host - before[1])


@pytest.mark.parametrize("prep_workers,row_chunk", [
    (1, arrow.ROW_CHUNK_ROWS), (2, 64), (8, 64), (8, arrow.ROW_CHUNK_ROWS)])
def test_describe_is_the_same_whatever_the_route(
        host_answer, card_route, monkeypatch, prep_workers, row_chunk):
    df, want = host_answer
    monkeypatch.setattr(arrow, "ROW_CHUNK_ROWS", row_chunk)
    before = (hll.lanes_device, hll.lanes_host)
    got = _describe(df, prep_workers=prep_workers, prepare_workers=2,
                    scan_batches=3)
    assert _routed(before) == (3, 6)
    assert _exported(got) == _exported(want)
    for name, var in want["variables"].items():
        assert got["variables"][name]["distinct_count"] == \
            var["distinct_count"], name
    # pass A's pool hashed only the six host lanes
    assert "hash_a" in got["_phases"]


def test_exact_distinct_keeps_every_lane_on_the_host(card_route, tmp_path):
    before = (hll.lanes_device, hll.lanes_host)
    stats = _describe(_mixed(), exact_distinct=True,
                      unique_spill_dir=str(tmp_path))
    assert _routed(before) == (0, 9)
    assert stats["variables"]["f32"]["distinct_count"] == \
        _mixed()["f32"].replace(-0.0, 0.0).nunique()


def test_mesh_keeps_every_lane_on_the_host(host_answer, card_route):
    df, want = host_answer
    before = (hll.lanes_device, hll.lanes_host)
    got = gpu.GPUStatsBackend(devices=["cpu", "cpu"]).collect(
        df, ProfilerConfig(batch_rows=BATCH))
    assert _routed(before) == (0, 9)
    for name, var in want["variables"].items():
        assert got["variables"][name]["distinct_count"] == \
            var["distinct_count"], name


def test_fused_route_keeps_the_registers(host_answer, card_route):
    df, want = host_answer
    before = (hll.lanes_device, hll.lanes_host)
    got = _describe(df, profile_passes="fused", scan_batches=2)
    assert _routed(before) == (3, 6)
    assert _exported(got) == _exported(want)


@pytest.mark.parametrize("scan_batches", [1, 2])
def test_checkpoint_resume_keeps_the_registers(tmp_path, host_answer,
                                               card_route, scan_batches):
    """A checkpointed profile on the card route killed by a ``fold``
    fault, then resumed: the saved device registers carry the folded
    prefix, and the answer is the uninterrupted host route's."""
    df, want = host_answer
    ck = dict(checkpoint_path=str(tmp_path / "scan.ckpt"),
              checkpoint_every_batches=2, scan_batches=scan_batches)
    faults.configure("fold:1@6")
    with pytest.raises(Exception, match="injected"):
        _describe(df, **ck)
    faults.reset()
    assert (tmp_path / "scan.ckpt").exists()
    resumed = _describe(df, **ck)
    assert resumed["_phases"]["resume"] > 0
    assert _exported(resumed) == _exported(want)


def test_the_counter_counts_each_route(card_route):
    stats = _describe(_mixed(), metrics_enabled=True)
    assert stats["_obs"]["counters"]["tpuprof_hll_lanes_total"] == {
        '{route="device"}': 3, '{route="host"}': 6}


def test_the_counter_on_the_host_route():
    stats = _describe(_mixed(), metrics_enabled=True)
    assert stats["_obs"]["counters"]["tpuprof_hll_lanes_total"] == {
        '{route="host"}': 9}


def test_an_all_float32_table_runs_no_host_fold(monkeypatch):
    rng = np.random.default_rng(4)
    df = pd.DataFrame(rng.normal(size=(1500, 5)).astype(np.float32),
                      columns=list("abcde"))
    want = _describe(df)
    assert "hll_host_a" in want["_phases"]
    monkeypatch.setattr(Runner, "hashes_on_device", True)
    got = _describe(df)
    assert "hll_host_a" not in got["_phases"]
    assert got["_phases"]["hash_a"] == 0.0
    assert _exported(got) == _exported(want)
