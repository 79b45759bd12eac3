"""Fold-state artifacts and ``resume_profiler`` in the PyTorch port.

Mirrors the incremental cases of ``tests/test_artifact.py``:
``write_artifact(path, profiler=prof)`` after part of a stream, then
``resume_profiler(path)`` and ``update(delta)``: the port's full stream
byte for byte (``stats_to_json``) and the reference's full stream at
ROADMAP's tolerances, two-pass and fused; a stats-only artifact, a torn
fold state and a mismatched config are refused; a degraded prefix stays
degraded; a torn artifact write is a typed read error.  A fold-state
artifact the reference wrote is refused with ``CorruptArtifactError``
before it is unpickled, in a child that then holds neither ``jax`` nor any
``tpuprof`` module."""

import base64
import json
import os
import subprocess
import sys
import textwrap
import zlib

import jax  # noqa: F401  (JAX stays on the CPU: tests/conftest.py)
import numpy as np
import pandas as pd
import pytest

import tpuprof_torch
from tpuprof import ProfilerConfig as RefConfig
from tpuprof.artifact import write_artifact as ref_write_artifact
from tpuprof.runtime.stream import StreamingProfiler as RefStream
from tpuprof_torch import ProfilerConfig, StreamingProfiler, resume_profiler
from tpuprof_torch.artifact import read_artifact, write_artifact
from tpuprof_torch.errors import CorruptArtifactError
from tpuprof_torch.report.export import stats_to_json
from tpuprof_torch.testing import faults
from torch_route import same_hash_route  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 5e-4, 1e-5


@pytest.fixture(autouse=True)
def _no_plan_leaks():
    faults.reset()
    yield
    faults.reset()


def _frames(n=10, rows=256, seed=7):
    rng = np.random.default_rng(seed)
    return [pd.DataFrame({
        "fare": rng.gamma(2.0, 7.5, rows),
        "dist": rng.exponential(2.5, rows),
        "vendor": rng.choice(["CMT", "VTS", "DDS"], rows),
        "when": pd.Timestamp("2024-01-01") + pd.to_timedelta(
            rng.integers(0, 10 ** 6, rows), unit="s"),
    }) for _ in range(n)]


def _cfg(**kw):
    kw.setdefault("batch_rows", 256)
    return ProfilerConfig(**kw)


def _exported(stats) -> str:
    return json.dumps(stats_to_json(stats), sort_keys=True)


def _full(frames, **kw):
    prof = StreamingProfiler.for_example(frames[0], config=_cfg(**kw),
                                         device="cpu")
    for f in frames:
        prof.update(f)
    return prof.stats()


@pytest.mark.parametrize("passes", ["two_pass", "fused"])
def test_incremental_equals_full_stream(tmp_path, passes):
    frames = _frames()
    path = str(tmp_path / "a.json")
    prof = StreamingProfiler.for_example(
        frames[0], config=_cfg(profile_passes=passes), device="cpu")
    for f in frames[:6]:
        prof.update(f)
    meta = write_artifact(path, profiler=prof)
    assert meta["foldable"] and meta["rows"] == 6 * 256
    art = read_artifact(path)
    assert art.foldable and art.state_package == "tpuprof_torch"
    resumed = resume_profiler(path, device="cpu")
    assert resumed.config.profile_passes == passes
    for f in frames[6:]:
        resumed.update(f)
    got = resumed.stats()
    assert _exported(got) == _exported(_full(frames,
                                             profile_passes=passes))
    ref = RefStream.for_example(frames[0], config=RefConfig(
        batch_rows=256, profile_passes=passes))
    for f in frames:
        ref.update(f)
    want = ref.stats()
    assert got["table"]["n"] == want["table"]["n"]
    for name, rv in want["variables"].items():
        pv = got["variables"][name]
        assert pv["type"] == rv["type"]
        for fld in ("count", "n_missing", "distinct_count"):
            assert pv[fld] == rv[fld], (name, fld)
        if rv["type"] == "NUM":
            for fld in ("min", "max", "p50"):
                assert pv[fld] == rv[fld], (name, fld)
            for fld in ("mean", "std", "skewness"):
                assert np.isclose(pv[fld], rv[fld], rtol=RTOL, atol=ATOL)
            np.testing.assert_array_equal(pv["histogram"][0],
                                          rv["histogram"][0])
    assert got["freq"]["vendor"].to_dict() == \
        want["freq"]["vendor"].to_dict()


def test_artifact_state_resumes_twice_identically(tmp_path):
    """Two resumes of one artifact fold the same delta to the same
    bytes (the artifact is read, never consumed)."""
    frames = _frames(n=6)
    path = str(tmp_path / "a.json")
    prof = StreamingProfiler.for_example(frames[0], config=_cfg(),
                                         device="cpu")
    for f in frames[:3]:
        prof.update(f)
    write_artifact(path, profiler=prof)
    outs = []
    for _ in range(2):
        r = resume_profiler(read_artifact(path), device="cpu")
        for f in frames[3:]:
            r.update(f)
        outs.append(_exported(r.stats()))
    assert outs[0] == outs[1]


def test_stats_only_artifact_raises(tmp_path):
    frames = _frames(n=2)
    path = str(tmp_path / "s.json")
    write_artifact(path, stats=_full(frames), config=_cfg())
    assert not read_artifact(path).foldable
    with pytest.raises(CorruptArtifactError, match="no fold state"):
        resume_profiler(path, device="cpu")


def test_torn_state_payload_is_typed(tmp_path):
    frames = _frames(n=2)
    path = str(tmp_path / "a.json")
    prof = StreamingProfiler.for_example(frames[0], config=_cfg(),
                                         device="cpu")
    prof.update(frames[0])
    write_artifact(path, profiler=prof)
    doc = json.load(open(path))
    raw = base64.b64decode(doc["state"]["payload"])[:-10]
    doc["state"]["payload"] = base64.b64encode(raw).decode()
    core = {k: v for k, v in doc.items() if k != "integrity"}
    doc["integrity"]["crc32"] = zlib.crc32(json.dumps(
        core, sort_keys=True, separators=(",", ":")).encode()) & 0xFFFFFFFF
    json.dump(doc, open(path, "w"))
    with pytest.raises(CorruptArtifactError, match="CRC"):
        read_artifact(path)


def test_torn_artifact_write_is_a_typed_read_error(tmp_path):
    frames = _frames(n=2)
    prof = StreamingProfiler.for_example(frames[0], config=_cfg(),
                                         device="cpu")
    prof.update(frames[0])
    faults.configure("artifact_write:truncate@1")
    path = str(tmp_path / "a.json")
    write_artifact(path, profiler=prof)
    assert faults.injected("artifact_write") == 1
    with pytest.raises(CorruptArtifactError):
        read_artifact(path)


def test_degraded_run_keeps_manifest(tmp_path):
    frames = _frames(n=6)
    kw = dict(max_quarantined=2, ingest_retries=0)
    faults.configure("prep:1@2")
    prof = StreamingProfiler.for_example(frames[0], config=_cfg(**kw),
                                         device="cpu")
    for f in frames[:3]:
        prof.update(f)
    faults.reset()
    path = str(tmp_path / "a.json")
    meta = write_artifact(path, profiler=prof)
    assert meta["degraded"]
    resumed = resume_profiler(path, device="cpu")
    for f in frames[3:]:
        resumed.update(f)
    stats = resumed.stats()
    assert [e["site"] for e in stats["_quarantine"]] == ["prep"]
    assert stats["table"]["n"] == 5 * 256


def test_resume_rejects_mismatched_config(tmp_path):
    frames = _frames(n=2)
    prof = StreamingProfiler.for_example(frames[0], config=_cfg(),
                                         device="cpu")
    prof.update(frames[0])
    path = str(tmp_path / "a.json")
    write_artifact(path, profiler=prof)
    with pytest.raises(ValueError, match="quantile_sketch_size"):
        resume_profiler(path, config=_cfg(quantile_sketch_size=64),
                        device="cpu")


def test_reference_fold_state_artifact_is_refused(tmp_path):
    """The reference's fold-state artifact reads (its JSON is the shared
    format) but its state is refused before it is unpickled: in a child,
    which then holds no ``jax`` and no ``tpuprof`` module.  The same
    artifact read by the reference resumes there."""
    frames = _frames(n=3)
    ref = RefStream.for_example(frames[0], config=RefConfig(batch_rows=256))
    for f in frames:
        ref.update(f)
    path = str(tmp_path / "ref.json")
    ref_write_artifact(path, profiler=ref)
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    code = textwrap.dedent(f"""
        import sys
        import tpuprof_torch
        from tpuprof_torch.artifact import read_artifact
        from tpuprof_torch.errors import CorruptArtifactError
        art = read_artifact({path!r})
        assert art.foldable and art.state_package is None
        assert art.stats["table"]["n"] == {3 * 256}
        try:
            tpuprof_torch.resume_profiler(art, device="cpu")
            raise SystemExit("the reference's fold state was resumed")
        except CorruptArtifactError as exc:
            assert "not tpuprof_torch" in str(exc), exc
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "tpuprof"))
        assert not bad, bad
        print("refused, clean")
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "refused, clean"
    assert tpuprof_torch.resume_profiler is resume_profiler
