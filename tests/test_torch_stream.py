"""The port's ``StreamingProfiler`` against the reference's.

Mirrors ``tests/test_streaming.py`` and the stream cases of
``tests/test_resume.py`` and ``tests/test_faults.py``: the same
micro-batches through ``StreamingProfiler(device="cpu")`` and the
reference's, two-pass and fused, snapshots mid-buffer and snapshots
followed by more updates, each against the reference's stats at ROADMAP's
tolerances (counts, min/max and histograms exact, moments at rtol 5e-4 /
atol 1e-5); the coalescing of micro-batches into device batches; a
checkpoint and restore equal to the uninterrupted stream (byte for byte
where the checkpoint falls on a device-batch edge; the reference's own
case otherwise); a restore with the wrong shapes refused; the
``device_drain`` watchdog under its fault; the quarantine across a
restore."""

import json

import jax  # noqa: F401  (JAX stays on the CPU: tests/conftest.py)
import numpy as np
import pandas as pd
import pyarrow as pa
import pytest
import torch

import tpuprof_torch
from tpuprof import ProfilerConfig as RefConfig
from tpuprof.runtime.stream import StreamingProfiler as RefStream
from tpuprof_torch import ProfilerConfig, StreamingProfiler
from tpuprof_torch.errors import WatchdogTimeout
from tpuprof_torch.report.export import stats_to_json
from tpuprof_torch.testing import faults
from torch_route import same_hash_route  # noqa: F401  (autouse)

RTOL, ATOL = 5e-4, 1e-5
MOMENTS = ("mean", "std", "variance", "sum", "mad", "skewness", "kurtosis")


@pytest.fixture(autouse=True)
def _no_plan_leaks():
    faults.reset()
    yield
    faults.reset()


def _cfg(**kw):
    kw.setdefault("batch_rows", 256)
    return ProfilerConfig(**kw)


def _ref_cfg(**kw):
    kw.setdefault("batch_rows", 256)
    return RefConfig(**kw)


def _micro_batches(n_batches=8, rows=250, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_batches):
        df = pd.DataFrame({
            "x": rng.normal(100.0, 5.0, rows),
            "y": rng.exponential(2.0, rows),
            "cat": rng.choice(["a", "b", "c", "d"], rows),
        })
        df.loc[rng.random(rows) < 0.05, "y"] = np.nan
        out.append(df)
    return out


def _pair(frames, **kw):
    port = StreamingProfiler.for_example(frames[0], config=_cfg(**kw),
                                         device="cpu")
    ref = RefStream.for_example(frames[0], config=_ref_cfg(**kw))
    return port, ref


def _held(port, ref):
    assert port["table"]["n"] == ref["table"]["n"]
    assert list(port["variables"]) == list(ref["variables"])
    for name, rv in ref["variables"].items():
        pv = port["variables"][name]
        assert pv["type"] == rv["type"], name
        for fld in ("count", "n_missing", "distinct_count"):
            assert pv[fld] == rv[fld], (name, fld)
        if rv["type"] != "NUM":
            assert pv.get("freq") == rv.get("freq"), name
            continue
        for fld in ("n_zeros", "min", "max", "p5", "p50", "p95"):
            assert pv[fld] == rv[fld], (name, fld)
        for fld in MOMENTS:
            assert np.isclose(pv[fld], rv[fld], rtol=RTOL, atol=ATOL), \
                (name, fld)
        np.testing.assert_array_equal(pv["histogram"][0],
                                      rv["histogram"][0], err_msg=name)
    for name, vc in ref["freq"].items():
        assert port["freq"][name].to_dict() == vc.to_dict(), name


@pytest.mark.parametrize("passes", ["two_pass", "fused"])
def test_running_profile_matches_reference(passes):
    frames = _micro_batches()
    port, ref = _pair(frames, profile_passes=passes)
    for f in frames:
        port.update(f)
        ref.update(f)
    assert port.cursor == ref.cursor
    _held(port.stats(), ref.stats())


@pytest.mark.parametrize("passes", ["two_pass", "fused"])
def test_snapshot_mid_buffer_then_more_updates(passes):
    """A snapshot with rows in the buffer covers them; the stream goes on
    and the next snapshot still matches the reference's."""
    frames = _micro_batches(seed=1)
    port, ref = _pair(frames, batch_rows=1024, profile_passes=passes)
    for f in frames[:3]:
        port.update(f)
        ref.update(f)
    assert port.cursor == 0 and port._buf_rows == 750
    mid = port.stats()
    assert mid["table"]["n"] == 750 and port._buf_rows == 0
    _held(mid, ref.stats())
    for f in frames[3:]:
        port.update(f)
        ref.update(f)
    _held(port.stats(), ref.stats())
    assert "Overview" in port.report_html()


def test_micro_batches_coalesce_into_full_dispatches():
    frames = _micro_batches(n_batches=16, rows=100)
    port = StreamingProfiler.for_example(frames[0],
                                         config=_cfg(batch_rows=1024),
                                         device="cpu")
    for f in frames:
        port.update(f)
    assert port.cursor == 1 and port._buf_rows == 1600 - 1024
    assert port.stats()["table"]["n"] == 1600
    port.update(frames[0])
    assert port.stats()["table"]["n"] == 1700


def test_stream_flush_rows_below_device_batch():
    frames = _micro_batches(n_batches=4, rows=100)
    port = StreamingProfiler.for_example(
        frames[0], config=_cfg(batch_rows=4096, stream_flush_rows=100),
        device="cpu")
    for f in frames:
        port.update(f)
    assert port.cursor == 4
    assert port.stats()["table"]["n"] == 400
    with pytest.raises(ValueError, match="stream_flush_rows"):
        _cfg(stream_flush_rows=0)


def test_arrow_inputs_projection_and_schema_checks():
    frames = _micro_batches(n_batches=2)
    table = pa.Table.from_pandas(frames[0], preserve_index=False)
    port = StreamingProfiler(table.schema, config=_cfg(columns=("x",)),
                             device="cpu")
    port.update(table)
    port.update(table.to_batches()[0])
    port.update(frames[1])
    assert list(port.stats()["variables"]) == ["x"]
    with pytest.raises(ValueError, match="schema"):
        port.update(frames[0][["y"]])
    with pytest.raises(TypeError):
        port.update([1, 2, 3])


def _exported(stats) -> str:
    return json.dumps(stats_to_json(stats), sort_keys=True)


@pytest.mark.parametrize("passes", ["two_pass", "fused"])
def test_checkpoint_restore_equals_uninterrupted(tmp_path, passes):
    """Micro-batches of one device batch each, a checkpoint after four,
    a restore in a fresh profiler: ``stats_to_json`` byte for byte the
    uninterrupted stream's, and the reference's at the tolerances."""
    frames = _micro_batches(seed=3, rows=256)
    path = str(tmp_path / "s.ckpt")
    cfg = _cfg(profile_passes=passes)
    prof = StreamingProfiler.for_example(frames[0], config=cfg,
                                         device="cpu")
    for f in frames[:4]:
        prof.update(f)
    assert prof.checkpoint(path) > 0
    del prof
    restored = StreamingProfiler.restore(path, config=cfg, device="cpu")
    assert restored.cursor == 4
    for f in frames[4:]:
        restored.update(f)
    port, ref = _pair(frames, profile_passes=passes)
    for f in frames:
        port.update(f)
        ref.update(f)
    assert _exported(restored.stats()) == _exported(port.stats())
    _held(restored.stats(), ref.stats())


def test_kill_restore_report_matches_uninterrupted(tmp_path):
    """The reference's own case (``test_kill_restore_report_byte_identical``):
    250-row frames against 256-row batches, so the checkpoint's forced
    drain moves the batch edges: the report is byte for byte the
    uninterrupted stream's, and the key statistics agree at rel 1e-6, as
    the reference's ``test_checkpoint_restore_equals_uninterrupted``
    holds them."""
    rng = np.random.default_rng(21)
    frames = [pd.DataFrame({
        "a": rng.normal(3.0, 1.5, 250),
        "b": rng.exponential(2.0, 250),
        "c": rng.choice(["p", "q", "r"], 250),
    }) for _ in range(12)]
    cfg = _cfg(stream_flush_rows=256, seed=5)
    control = StreamingProfiler.for_example(frames[0], config=cfg,
                                            device="cpu")
    for f in frames:
        control.update(f)
    path = str(tmp_path / "stream.ckpt")
    prof = StreamingProfiler.for_example(frames[0], config=cfg,
                                         device="cpu")
    for f in frames[:7]:
        prof.update(f)
    prof.checkpoint(path)
    del prof
    restored = StreamingProfiler.restore(path, config=cfg, device="cpu")
    for f in frames[7:]:
        restored.update(f)
    assert restored.report_html() == control.report_html()
    got, want = restored.stats(), control.stats()
    assert got["table"]["n"] == want["table"]["n"] == 3000
    for col in ("a", "b"):
        for fld in ("count", "n_missing", "min", "max", "p50"):
            assert got["variables"][col][fld] == want["variables"][col][fld]
        for fld in ("mean", "std"):
            assert got["variables"][col][fld] == pytest.approx(
                want["variables"][col][fld], rel=1e-6)
    assert got["freq"]["c"].to_dict() == want["freq"]["c"].to_dict()


def test_checkpoint_shape_mismatch_rejected(tmp_path):
    frames = _micro_batches()
    prof = StreamingProfiler.for_example(frames[0], config=_cfg(),
                                         device="cpu")
    prof.update(frames[0])
    prof.update(frames[1])
    path = str(tmp_path / "p.ckpt")
    prof.checkpoint(path)
    with pytest.raises(ValueError, match="shape|mismatch"):
        StreamingProfiler.restore(path, config=_cfg(hll_precision=7),
                                  device="cpu")
    with pytest.raises(ValueError, match="quantile_sketch_size"):
        StreamingProfiler.restore(path, config=_cfg(
            quantile_sketch_size=128), device="cpu")
    with pytest.raises(ValueError, match="two-pass checkpoint"):
        StreamingProfiler.restore(path, config=_cfg(
            profile_passes="fused"), device="cpu")


def test_drain_watchdog_fires_with_heartbeat():
    faults.configure("device_wait:sleep=2")
    frames = _micro_batches(n_batches=2)
    prof = StreamingProfiler.for_example(
        frames[0], config=_cfg(drain_timeout_s=0.15), device="cpu")
    with pytest.raises(WatchdogTimeout) as ei:
        for f in frames:
            prof.update(f)
    assert ei.value.site == "device_drain"
    assert "rows_folded" in ei.value.heartbeat


def test_quarantine_survives_a_restore(tmp_path):
    """A stream whose second slice fails to prepare skips it and says so;
    its manifest rides the checkpoint, and the restored stream reports it
    as the reference's stream reports its own."""
    frames = _micro_batches(rows=256, seed=4)
    kw = dict(max_quarantined=2, ingest_retries=0)
    faults.configure("prep:1@2")
    prof = StreamingProfiler.for_example(frames[0], config=_cfg(**kw),
                                         device="cpu")
    for f in frames[:4]:
        prof.update(f)
    path = str(tmp_path / "q.ckpt")
    prof.checkpoint(path)
    faults.reset()
    restored = StreamingProfiler.restore(path, config=_cfg(**kw),
                                         device="cpu")
    for f in frames[4:]:
        restored.update(f)
    from tpuprof.testing import faults as ref_faults
    ref_faults.configure("prep:1@2")
    try:
        ref = RefStream.for_example(frames[0], config=_ref_cfg(**kw))
        for f in frames:
            ref.update(f)
        want = ref.stats()
    finally:
        ref_faults.reset()
    got = restored.stats()
    assert [(e["site"], e["cursor"], e["rows"]) for e in got["_quarantine"]] \
        == [(e["site"], e["cursor"], e["rows"])
            for e in want["_quarantine"]] == [("prep", 1, 256)]
    assert got["table"]["n"] == 7 * 256
    _held(got, want)


def test_heartbeat_progress_and_close():
    frames = _micro_batches(n_batches=3)
    with StreamingProfiler.for_example(frames[0], config=_cfg(),
                                       device="cpu") as prof:
        for f in frames:
            prof.update(f)
        hb = prof.heartbeat()
        assert hb["rows_folded"] + hb["rows_buffered"] == 750
        assert hb["batches_folded"] == prof.cursor == 2
        assert "rows folded" in prof.progress()
    prof.close()                    # idempotent after __exit__


def test_default_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    frames = _micro_batches(n_batches=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        StreamingProfiler.for_example(frames[0])
    assert tpuprof_torch.StreamingProfiler is StreamingProfiler
