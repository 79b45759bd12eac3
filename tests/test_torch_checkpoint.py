"""Checkpoints of the port: the file format and the collect's resume.

Mirrors ``tests/test_resume.py`` and the checkpoint cases of
``tests/test_faults.py`` for what the port runs (one process).  The format
(``runtime/checkpoint.py``): atomic writes that leave no temporary file,
a file truncated at every byte offset raising ``CorruptCheckpointError``,
rotation and the walk back past a torn head.  The collect
(``backends/gpu.py::CollectCheckpoint``): a ``fold`` fault after batch k
kills a checkpointed profile, on a Parquet file and in memory, with 1 and
4 prepare workers, two-pass and fused; the rerun resumes and its
``stats_to_json`` equals the port's uninterrupted run byte for byte, and
the reference's uninterrupted run at ROADMAP's tolerances (counts,
histograms and min/max exact, moments at rtol 5e-4 / atol 1e-5, rho at
atol 5e-4).  Mismatched meta and source are refused; a clean run removes
its checkpoint; a resume opens no folded fragment and prepares no folded
batch; a fused checkpoint resumes on the same edges; a quarantined batch
stays quarantined.  A checkpoint the reference wrote is refused in a child
process that then holds neither ``jax`` nor any ``tpuprof`` module."""

import json
import os
import pickle
import subprocess
import sys
import textwrap

import jax  # noqa: F401  (JAX stays on the CPU: tests/conftest.py)
import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

import tpuprof_torch
from tpuprof import ProfilerConfig as RefConfig
from tpuprof.backends.tpu import HostAgg as RefHostAgg
from tpuprof.backends.tpu import TPUStatsBackend
from tpuprof.ingest.sample import RowSampler as RefSampler
from tpuprof_torch.errors import CorruptCheckpointError, InputError
from tpuprof_torch.ingest import arrow as port_arrow
from tpuprof_torch.report.export import stats_to_json
from tpuprof_torch.runtime import checkpoint as ckpt
from tpuprof_torch.runtime import singlepass
from tpuprof_torch.testing import faults
from torch_route import same_hash_route  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH = 256
N = 4000                        # 16 batches of 256 rows
RTOL, ATOL, ATOL_RHO = 5e-4, 1e-5, 5e-4


@pytest.fixture(autouse=True)
def _no_plan_leaks():
    faults.reset()
    yield
    faults.reset()


def _frame(n=N, seed=3):
    rng = np.random.default_rng(seed)
    df = pd.DataFrame({
        "a": rng.normal(7.0, 2.0, n),
        "b": rng.exponential(1.5, n),
        "c": rng.choice(["x", "y", "z"], n),
        "d": rng.integers(0, 50, n).astype(np.int64),
    })
    df.loc[rng.choice(n, 200, replace=False), "a"] = np.nan
    return df


@pytest.fixture(scope="module")
def sources(tmp_path_factory):
    """The frame in memory and as a Parquet file of four row groups."""
    root = tmp_path_factory.mktemp("ckpt")
    df = _frame()
    path = str(root / "t.parquet")
    pq.write_table(pa.Table.from_pandas(df, preserve_index=False), path,
                   row_group_size=1000)
    return {"memory": df, "parquet": path}


def _port(src, **kw):
    kw.setdefault("batch_rows", BATCH)
    return tpuprof_torch.describe(src, device="cpu", **kw)


def _ck(tmp_path, **kw):
    kw.setdefault("checkpoint_every_batches", 3)
    return dict(checkpoint_path=str(tmp_path / "scan.ckpt"), **kw)


def _crash(src, tmp_path, at=8, **kw):
    """A checkpointed profile killed by a ``fold`` fault on its
    ``at``-th batch; the checkpoint stays."""
    faults.configure(f"fold:1@{at}")
    with pytest.raises(Exception, match="injected"):
        _port(src, **_ck(tmp_path, **kw))
    faults.reset()
    assert (tmp_path / "scan.ckpt").exists()


def _exported(stats) -> str:
    return json.dumps(stats_to_json(stats), sort_keys=True)


def _close_to_reference(port, ref):
    assert port["table"]["n"] == ref["table"]["n"]
    assert list(port["variables"]) == list(ref["variables"])
    for name, rv in ref["variables"].items():
        pv = port["variables"][name]
        assert pv["type"] == rv["type"], name
        for fld in ("count", "n_missing", "distinct_count"):
            assert pv[fld] == rv[fld], (name, fld)
        if rv["type"] != "NUM":
            continue
        for fld in ("n_zeros", "min", "max", "p50"):
            assert pv[fld] == rv[fld], (name, fld)
        for fld in ("mean", "std", "variance", "mad", "skewness"):
            assert np.isclose(pv[fld], rv[fld], rtol=RTOL, atol=ATOL), \
                (name, fld)
        np.testing.assert_array_equal(pv["histogram"][0],
                                      rv["histogram"][0], err_msg=name)
    for name, vc in ref["freq"].items():
        assert port["freq"][name].to_dict() == vc.to_dict(), name
    np.testing.assert_allclose(
        port["correlations"]["pearson"].to_numpy(),
        ref["correlations"]["pearson"].to_numpy(), rtol=0, atol=ATOL_RHO,
        equal_nan=True)


@pytest.fixture(scope="module")
def references(sources):
    return {kind: TPUStatsBackend().collect(
        src, RefConfig(backend="tpu", batch_rows=BATCH))
        for kind, src in sources.items()}


# ---------------------------------------------------------------------------
# the file format
# ---------------------------------------------------------------------------

def _small_save(path, cursor=1, keep=1):
    state = {"counts": np.arange(6, dtype=np.int32).reshape(2, 3),
             "abs_dev": np.ones(2, dtype=np.float32)}
    return ckpt.save(str(path), state, {"note": "x" * 40}, cursor,
                     meta={"k": 1}, keep=keep)


def test_truncation_at_every_offset_is_typed(tmp_path):
    path = tmp_path / "c.ckpt"
    size = _small_save(path)
    data = path.read_bytes()
    assert len(data) == size
    torn = tmp_path / "torn.ckpt"
    for cut in range(len(data)):
        torn.write_bytes(data[:cut])
        with pytest.raises(CorruptCheckpointError):
            ckpt.load_payload(str(torn))
    torn.write_bytes(data[:-1] + bytes([data[-1] ^ 0x40]))   # bit rot
    with pytest.raises(CorruptCheckpointError, match="CRC"):
        ckpt.load_payload(str(torn))
    torn.write_bytes(b"junk" * 50)
    with pytest.raises(CorruptCheckpointError):
        ckpt.load_payload(str(torn))
    assert ckpt.load_payload(str(path))["cursor"] == 1


def test_raising_save_leaves_no_tmp(tmp_path):
    faults.configure("checkpoint_write:fatal@1")
    path = tmp_path / "c.ckpt"
    with pytest.raises(RuntimeError, match="injected fatal"):
        _small_save(path)
    assert os.listdir(tmp_path) == []
    faults.reset()
    _small_save(path, cursor=9)
    assert ckpt.load_payload(str(path))["cursor"] == 9
    assert sorted(os.listdir(tmp_path)) == ["c.ckpt"]


def test_rotation_and_walk_back_past_a_torn_head(tmp_path):
    path = tmp_path / "c.ckpt"
    for cursor in (1, 2, 3):
        _small_save(path, cursor=cursor, keep=3)
    assert [ckpt.load_payload(str(p))["cursor"]
            for p in ckpt.candidate_paths(str(path))] == [3, 2, 1]
    faults.configure("checkpoint_write:truncate@1")
    _small_save(path, cursor=4, keep=3)          # a torn head, renamed
    assert faults.injected("checkpoint_write") == 1
    with pytest.raises(CorruptCheckpointError):
        ckpt.load_payload(str(path))
    payload, used = ckpt.restore_payload(str(path))
    assert payload["cursor"] == 3 and used.endswith(".1")
    for p in ckpt.candidate_paths(str(path)):
        open(p, "wb").write(b"junk")
    with pytest.raises(CorruptCheckpointError, match="3 generation"):
        ckpt.restore_payload(str(path))
    ckpt.clear(str(path))
    assert os.listdir(tmp_path) == []


def test_keep_resolves_from_the_environment(monkeypatch):
    from tpuprof_torch.config import resolve_checkpoint_keep
    assert resolve_checkpoint_keep() == 2
    monkeypatch.setenv("TPUPROF_CHECKPOINT_KEEP", "5")
    assert resolve_checkpoint_keep() == 5
    assert resolve_checkpoint_keep(1) == 1
    with pytest.raises(ValueError, match="checkpoint_keep"):
        tpuprof_torch.ProfilerConfig(checkpoint_keep=0)


# ---------------------------------------------------------------------------
# crash, then resume
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("workers", [1, 4])
@pytest.mark.parametrize("kind", ["parquet", "memory"])
def test_crash_then_resume_matches_uninterrupted(tmp_path, sources,
                                                 references, kind, workers):
    src = sources[kind]
    control = _port(src, prepare_workers=workers)
    _crash(src, tmp_path, prepare_workers=workers)
    resumed = _port(src, prepare_workers=workers, **_ck(tmp_path))
    assert not (tmp_path / "scan.ckpt").exists()
    assert _exported(resumed) == _exported(control)
    _close_to_reference(resumed, references[kind])
    assert resumed["_phases"]["resume"] > 0
    assert resumed["_phases"]["checkpoint"] > 0


def test_clean_run_removes_checkpoint(tmp_path, sources):
    stats = _port(sources["parquet"], **_ck(tmp_path, checkpoint_keep=3))
    assert stats["table"]["n"] == N
    assert os.listdir(tmp_path) == []


def test_resume_with_staged_scan(tmp_path, sources):
    """A due checkpoint flushes a staged group first, so the saved cursor
    is the folded count; full groups still take the staged path."""
    src = sources["memory"]
    control = _port(src, scan_batches=2)
    _crash(src, tmp_path, at=10, scan_batches=2,
           checkpoint_every_batches=4)
    resumed = _port(src, scan_batches=2,
                    **_ck(tmp_path, checkpoint_every_batches=4))
    assert _exported(resumed) == _exported(control)


def test_mismatched_checkpoint_rejected(tmp_path, sources):
    _crash(sources["parquet"], tmp_path, at=5)
    with pytest.raises(InputError, match="batch_rows"):
        _port(sources["parquet"], batch_rows=512, **_ck(tmp_path))
    with pytest.raises(InputError, match="profile_passes"):
        _port(sources["parquet"], profile_passes="fused", **_ck(tmp_path))


def test_mismatched_source_rejected(tmp_path, sources):
    _crash(sources["parquet"], tmp_path, at=5)
    other = str(tmp_path / "other.parquet")
    pq.write_table(pa.Table.from_pandas(_frame(3000, seed=9),
                                        preserve_index=False), other)
    with pytest.raises(InputError, match="source_fp"):
        _port(other, **_ck(tmp_path))


def test_parallel_prep_never_reorders_checkpoint_cursors(tmp_path, sources,
                                                         monkeypatch):
    """Prepares race ahead of the fold, but the saved cursors rise at the
    cadence and the last covers the stream."""
    saved = []
    real = ckpt.save

    def tracking(path, state, blob, cursor, meta, keep=1):
        saved.append(cursor)
        return real(path, state, blob, cursor, meta, keep)

    monkeypatch.setattr(ckpt, "save", tracking)
    stats = _port(sources["parquet"], prepare_workers=4, **_ck(tmp_path))
    assert stats["table"]["n"] == N
    assert saved == sorted(set(saved))
    assert all(c % 3 == 0 for c in saved[:-1]) and saved[-1] == 16


def test_inmemory_resume_skips_prefix_without_decode(tmp_path, sources,
                                                     monkeypatch):
    """16 batches, a crash at fold 8, saves every 3: the save at cursor 6
    leaves 10 batches to prepare on the resume's pass A."""
    src = sources["memory"]
    _crash(src, tmp_path)
    prepared = {"a": 0}
    real = port_arrow.prepare_batch

    def counting(batch, plan, pad, hll_precision=11, hashes=True, *a, **k):
        prepared["a"] += bool(hashes)
        return real(batch, plan, pad, hll_precision, hashes, *a, **k)

    monkeypatch.setattr(port_arrow, "prepare_batch", counting)
    resumed = _port(src, **_ck(tmp_path))
    assert prepared["a"] == 10
    assert resumed["table"]["n"] == N


def test_resume_skips_completed_fragments_io(tmp_path, monkeypatch):
    """Eight one-row-group files: a resume opens only the fragment of the
    last save and those after it."""
    df = _frame(8 * 512, seed=4)
    root = tmp_path / "parts"
    root.mkdir()
    for i in range(8):
        pq.write_table(pa.Table.from_pandas(
            df.iloc[i * 512:(i + 1) * 512], preserve_index=False),
            str(root / f"p{i}.parquet"))
    opened = []
    real = port_arrow.ArrowIngest.raw_batches_positioned

    def spy(self, skip_fragments=0):
        for fi, bi, rb in real(self, skip_fragments):
            if not opened or opened[-1] != fi:
                opened.append(fi)
            yield fi, bi, rb

    monkeypatch.setattr(port_arrow.ArrowIngest, "raw_batches_positioned",
                        spy)
    control = _port(str(root))
    faults.configure("fold:1@12")
    with pytest.raises(Exception, match="injected"):
        _port(str(root), **_ck(tmp_path, checkpoint_every_batches=4))
    faults.reset()
    opened.clear()
    resumed = _port(str(root), **_ck(tmp_path, checkpoint_every_batches=4))
    # saved at cursor 8 = fragment 3 batch 1: fragments 0-2 stay closed
    assert opened == [3, 4, 5, 6, 7]
    assert _exported(resumed) == _exported(control)


def test_fused_checkpoint_resumes_on_the_same_edges(tmp_path, sources):
    src = sources["memory"]
    control = _port(src, profile_passes="fused")
    _crash(src, tmp_path, profile_passes="fused")
    payload, _ = ckpt.restore_payload(str(tmp_path / "scan.ckpt"))
    edges = singlepass.ProvisionalEdges.from_blob(
        payload["host_blob"]["singlepass_edges"])
    first = _frame().iloc[:BATCH]
    want = singlepass.sketch_edges(
        first[["a", "b", "d"]].to_numpy(np.float32), BATCH)
    np.testing.assert_array_equal(edges.lo, want.lo)
    np.testing.assert_array_equal(edges.mean, want.mean)
    assert payload["meta"]["profile_passes"] == "fused"
    resumed = _port(src, profile_passes="fused", **_ck(tmp_path))
    assert _exported(resumed) == _exported(control)


def test_quarantined_batch_stays_quarantined_across_resume(tmp_path,
                                                           sources):
    """A poison batch before the crash (a second one spends the budget of
    one): the resumed run's manifest still holds the first, pass B skips
    it, and the result is the uninterrupted degraded run's."""
    src = sources["memory"]
    kw = dict(max_quarantined=1, ingest_retries=0, prepare_workers=1)
    faults.configure("prep:1@2")
    control = _port(src, **kw)
    faults.configure("prep:1@2,fold:1@9")
    with pytest.raises(Exception, match="injected"):
        _port(src, **kw, **_ck(tmp_path))
    faults.reset()
    payload, _ = ckpt.restore_payload(str(tmp_path / "scan.ckpt"))
    assert payload["host_blob"]["skipped"] == [1]
    resumed = _port(src, **kw, **_ck(tmp_path))

    def entries(stats):
        return [(e["site"], e["cursor"], e["rows"], e["error"])
                for e in stats["_quarantine"]]
    assert entries(resumed) == entries(control) == [
        ("prep", 2, BATCH, entries(control)[0][3])]
    # a checkpointed scan streams by positions: its entry has one
    assert resumed["_quarantine"][0]["frag_pos"] == [0, 1]
    assert resumed["table"]["n"] == N - BATCH
    a, b = stats_to_json(resumed), stats_to_json(control)
    a.pop("quarantine"), b.pop("quarantine")
    assert a == b


# ---------------------------------------------------------------------------
# what the reference wrote
# ---------------------------------------------------------------------------

def _refused_in_a_child(code: str, tmp_path):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                         cwd=str(tmp_path), env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "refused, clean", \
        out.stdout


def test_reference_checkpoint_is_refused_without_importing_it(
        tmp_path, sources, monkeypatch):
    """A checkpoint the reference's collect wrote (its payload pickles
    ``tpuprof`` classes), and one whose header is forged to the port's
    with such a payload: both refused with ``CorruptCheckpointError``, by
    ``describe(checkpoint_path=)`` and by ``StreamingProfiler.restore``,
    in a child that then holds no ``jax`` and no ``tpuprof`` module."""
    ref_path = tmp_path / "ref.ckpt"
    calls = {"n": 0}
    real = RefHostAgg.update

    def crashing(self, hb):
        calls["n"] += 1
        if calls["n"] == 8:
            raise RuntimeError("injected crash")
        return real(self, hb)

    monkeypatch.setattr(RefHostAgg, "update", crashing)
    with pytest.raises(RuntimeError, match="injected crash"):
        TPUStatsBackend().collect(sources["parquet"], RefConfig(
            backend="tpu", batch_rows=BATCH, checkpoint_path=str(ref_path),
            checkpoint_every_batches=3))
    monkeypatch.setattr(RefHostAgg, "update", real)
    assert ref_path.exists()
    forged = tmp_path / "forged.ckpt"
    body = pickle.dumps({"arrays_npz": b"", "cursor": 3, "meta": {},
                         "host_blob": {"sampler": RefSampler(8, 2)}})
    with open(forged, "wb") as fh:
        pickle.dump(ckpt.payload_header(body), fh)
        fh.write(body)
    _refused_in_a_child(f"""
        import sys
        import tpuprof_torch
        from tpuprof_torch.errors import CorruptCheckpointError
        from tpuprof_torch.runtime import checkpoint as ckpt
        try:
            tpuprof_torch.describe({sources['parquet']!r}, device="cpu",
                                   batch_rows={BATCH},
                                   checkpoint_path={str(ref_path)!r})
            raise SystemExit("the reference's checkpoint was resumed")
        except CorruptCheckpointError as exc:
            assert "tpuprof_torch" in str(exc), exc
        try:
            tpuprof_torch.StreamingProfiler.restore({str(ref_path)!r},
                                                    device="cpu")
            raise SystemExit("the reference's checkpoint was restored")
        except CorruptCheckpointError:
            pass
        try:
            ckpt.load_payload({str(forged)!r})
            raise SystemExit("a forged header let tpuprof classes load")
        except CorruptCheckpointError as exc:
            assert "not a class of tpuprof_torch" in str(exc), exc
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "tpuprof"))
        assert not bad, bad
        print("refused, clean")
    """, tmp_path)


def test_cuda_default_device_is_required_for_a_resume(monkeypatch, sources,
                                                     tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tpuprof_torch.describe(sources["memory"], **_ck(tmp_path))
