"""The port's device mesh (``tpuprof_torch/runtime/mesh.py``) on the CPU.

``GPUStatsBackend(devices=["cpu", "cpu"])`` row-shards every batch over two
``Runner``s; its profile must equal the one-device run (two-pass, with
Spearman, fused) and the reference's ``TPUStatsBackend`` with
``mesh_devices=2`` on the conftest's fake CPU devices, at ROADMAP's
tolerances.  The padded row count and the row blocks are the reference's
(``-(-batch_rows // n) * n``, contiguous ``P("data")`` blocks);
``mesh_devices`` cuts the device list; a checkpointed mesh scan killed by a
``fold`` fault resumes to the same profile.
"""

import jax
import numpy as np
import pandas as pd
import pytest

from tpuprof import ProfilerConfig as RefConfig
from tpuprof.backends.tpu import TPUStatsBackend
from tpuprof.report.export import stats_to_json as ref_stats_to_json
from tpuprof.runtime.mesh import MeshRunner as RefMeshRunner
from tpuprof_torch import ProfilerConfig
from tpuprof_torch.backends.gpu import GPUStatsBackend
from tpuprof_torch.ingest.arrow import ArrowIngest, prepare_batch
from tpuprof_torch.report.export import stats_to_json
from tpuprof_torch.runtime.mesh import MeshRunner, local_devices
from tpuprof_torch.testing import faults
from torch_ranks import export_close, plain
from torch_route import same_hash_route  # noqa: F401  (autouse)

BATCH = 255             # pads to 256 on two devices: 128-row blocks


def _frame(n=3001, seed=0):
    rng = np.random.default_rng(seed)
    df = pd.DataFrame({
        "a": rng.normal(5, 2, n), "b": rng.exponential(1.5, n),
        "c": rng.choice(["x", "y", "z"], n),
        "i": rng.integers(0, 9, n),
        "d": pd.Timestamp("2024-01-01") + pd.to_timedelta(
            rng.integers(0, 10 ** 6, n), unit="s")})
    df.loc[rng.random(n) < 0.1, "a"] = np.nan
    df.loc[rng.random(n) < 0.02, "b"] = np.inf
    return df


@pytest.fixture(scope="module")
def df():
    return _frame()


def _port(df, devices=None, device=None, **kw):
    backend = GPUStatsBackend(device=device, devices=devices)
    return plain(stats_to_json(backend.collect(
        df, ProfilerConfig(batch_rows=BATCH, **kw))))


@pytest.mark.parametrize("kw", [{}, {"spearman": True},
                                 {"profile_passes": "fused"}],
                         ids=["two_pass", "spearman", "fused"])
def test_mesh_equals_one_device(df, kw):
    export_close(_port(df, devices=["cpu", "cpu"], **kw),
                 _port(df, device="cpu", **kw))


def test_mesh_equals_the_reference_two_device_mesh(df):
    ref = plain(ref_stats_to_json(TPUStatsBackend().collect(
        df, RefConfig(backend="tpu", batch_rows=BATCH, mesh_devices=2))))
    export_close(_port(df, devices=["cpu", "cpu"]), ref)


@pytest.mark.parametrize("rows,n_dev", [(255, 2), (256, 2), (1000, 3),
                                        (7, 4)])
def test_padded_rows_are_the_references(rows, n_dev):
    mine = MeshRunner(ProfilerConfig(batch_rows=rows), 2, 1,
                      ["cpu"] * n_dev)
    ref = RefMeshRunner(RefConfig(backend="tpu", batch_rows=rows), 2, 1,
                        devices=jax.devices()[:n_dev])
    assert mine.rows == ref.rows == -(-rows // n_dev) * n_dev
    assert mine.shard_rows * n_dev == mine.rows
    assert all(r.rows == mine.shard_rows for r in mine.runners)


def test_batches_split_into_the_data_blocks(df):
    ingest = ArrowIngest(df, BATCH)
    plan = ingest.plan
    mesh = MeshRunner(ProfilerConfig(batch_rows=BATCH), plan.n_num,
                      plan.n_hash, ["cpu", "cpu"])
    rb = next(ingest.raw_batches())
    hb = prepare_batch(rb, plan, mesh.rows, 11)
    shards = mesh.ship([hb])
    xt = np.ascontiguousarray(hb.x.T)
    for d, g in enumerate(shards):
        block = slice(d * 128, (d + 1) * 128)
        assert g.n_batches == 1
        np.testing.assert_array_equal(g.xts[0].numpy(), xt[:, block])
        np.testing.assert_array_equal(g.row_valids[0].numpy(),
                                      hb.row_valid[block])
    staged = mesh.ship([hb, hb])
    assert [tuple(g.xts.shape) for g in staged] == \
        [(2, plan.n_num, 128)] * 2
    for d, g in enumerate(staged):
        block = slice(d * 128, (d + 1) * 128)
        assert g.n_batches == 2
        for i in range(2):
            np.testing.assert_array_equal(g.xts[i].numpy(), xt[:, block])


def test_mesh_devices_cuts_the_list():
    mesh = MeshRunner(ProfilerConfig(batch_rows=100, mesh_devices=2), 1, 0,
                      ["cpu"] * 3)
    assert mesh.n_dev == 2 and mesh.rows == 100
    assert local_devices(1) == local_devices()[:1]


def test_checkpointed_mesh_scan_resumes(df, tmp_path):
    ck = str(tmp_path / "scan.ckpt")
    kw = dict(checkpoint_path=ck, checkpoint_every_batches=4)
    faults.configure("fold:1@7", seed=0)
    try:
        with pytest.raises(Exception, match="injected"):
            _port(df, devices=["cpu", "cpu"], **kw)
    finally:
        faults.reset()
    export_close(_port(df, devices=["cpu", "cpu"], **kw),
                 _port(df, device="cpu"))
