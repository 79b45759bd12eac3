"""Exact distinct counting in the port against the reference.

``tpuprof_torch.describe(df, device="cpu", exact_distinct=True,
unique_spill_dir=..., unique_track_rows=300)`` against the reference's
``TPUStatsBackend().collect`` (8 CPU devices, tests/conftest.py) on a mixed
frame whose columns spill: the distinct counts, ``is_unique``, ``p_unique``
and types equal the reference's and pandas' ``nunique``, no count is
approximate, every other statistic equals the describe without
``exact_distinct``, and the tracker's partitions, spill workers and budgets
leave the stats as they are.  Then ``parity=True`` in both packages, the
seven command-line flags with the reference's errors, a collect checkpoint
whose spill runs carry a crash, a stream through a fold-state artifact and
``resume_profiler``, and ``StreamingProfiler(parity=True)`` refused."""

import glob
import json
import os

import jax  # noqa: F401  (JAX stays on the CPU: tests/conftest.py)
import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import tpuprof_torch
from tpuprof import ProfilerConfig as RefConfig
from tpuprof.backends.tpu import TPUStatsBackend
from tpuprof_torch import ProfilerConfig, StreamingProfiler, cli, schema
from tpuprof_torch.errors import InputError
from tpuprof_torch.report.export import stats_to_json
from tpuprof_torch.testing import faults
from torch_route import same_hash_route  # noqa: F401  (autouse)

BATCH = 512
TRACK = 300             # the per-column budget: high-cardinality columns spill
DISTINCT = ("distinct_count", "p_unique", "is_unique", "distinct_approx")
ATOL_RHO = 5e-4        # the Spearman contract (ROADMAP)


@pytest.fixture(autouse=True)
def _no_plan_leaks():
    faults.reset()
    yield
    faults.reset()


def _frame(n=6000, seed=11):
    """Shaped like ``tests/test_parity.py``'s frame, with every column role:
    floats with NaN, an int, a bool, a constant, a date, a low- and a
    high-cardinality string (past the Misra-Gries capacity of 4,096) and a
    unique id."""
    rng = np.random.default_rng(seed)
    df = pd.DataFrame({
        "x": rng.normal(size=n),
        "y": rng.exponential(size=n),
        "i": rng.integers(0, 2500, n).astype(np.int64),
        "hicard": [f"k{i:06d}" for i in rng.integers(0, 20000, n)],
        "cat": rng.choice(["a", "b", "c"], n),
        "flag": rng.random(n) < 0.3,
        "const": 1.0,
        "when": pd.Timestamp("2020-01-01") + pd.to_timedelta(
            rng.integers(0, 4000, n), unit="min"),
        "rid": [f"r{i:07d}" for i in range(n)],
    })
    df.loc[rng.choice(n, 400, replace=False), "x"] = np.nan
    df.loc[rng.choice(n, 300, replace=False), "cat"] = None
    return df


@pytest.fixture(scope="module")
def frame():
    return _frame()


def _port(df, spill_dir=None, **kw):
    kw.setdefault("batch_rows", BATCH)
    if spill_dir is not None:
        kw.update(exact_distinct=True, unique_spill_dir=str(spill_dir))
        kw.setdefault("unique_track_rows", TRACK)
    return tpuprof_torch.describe(df, device="cpu", **kw)


@pytest.fixture(scope="module")
def runs(frame, tmp_path_factory):
    """(port exact, reference exact, port sketch, the port's spill dir)."""
    root = tmp_path_factory.mktemp("exact")
    port = _port(frame, root / "port")
    ref = TPUStatsBackend().collect(frame, RefConfig(
        backend="tpu", batch_rows=BATCH, exact_distinct=True,
        unique_spill_dir=str(root / "ref"), unique_track_rows=TRACK))
    sketch = _port(frame)
    return port, ref, sketch, root / "port"


def _exported(stats) -> str:
    return json.dumps(stats_to_json(stats), sort_keys=True)


def test_counts_are_pandas_nunique(frame, runs):
    port, _ref, _sketch, _d = runs
    truth = frame.nunique()
    for name, var in port["variables"].items():
        assert var["distinct_count"] == truth[name], name
        assert var["distinct_approx"] is False, name
        count = var["count"]
        assert var["is_unique"] == (truth[name] == count), name
        assert var["p_unique"] == truth[name] / count, name
    assert port["variables"]["rid"]["type"] == "UNIQUE"


@pytest.mark.parametrize("field", ["distinct_count", "is_unique",
                                   "p_unique", "distinct_approx", "type"])
def test_distinct_fields_equal_the_reference(runs, field):
    port, ref, _sketch, _d = runs
    assert list(port["variables"]) == list(ref["variables"])
    for name, v in ref["variables"].items():
        assert port["variables"][name][field] == v[field], name


def test_no_approximate_distinct_message(runs):
    """The sketch warns that ``hicard``'s count is an estimate (Misra-Gries
    overflowed and a duplicate stops the tracker); the exact describe does
    not, and its messages are the reference's."""
    port, ref, sketch, _d = runs
    assert (schema.MSG_APPROX_DISTINCT, "hicard") in {
        (m.kind, m.column) for m in sketch["messages"]}
    assert schema.MSG_APPROX_DISTINCT not in {m.kind for m in port["messages"]}
    assert [m.to_dict() for m in port["messages"]] == \
        [m.to_dict() for m in ref["messages"]]


def _drop_distinct(stats):
    doc = stats_to_json(stats)
    for part in (doc["variables"], doc["display"]["variables"]):
        for var in part.values():
            for k in DISTINCT:
                var.pop(k, None)
    doc["messages"] = [m for m in doc["messages"]
                       if m["kind"] not in (schema.MSG_APPROX_DISTINCT,
                                            schema.MSG_HIGH_CARDINALITY)]
    return doc


def test_everything_else_equals_the_sketch_describe(runs):
    port, _ref, sketch, _d = runs
    assert _drop_distinct(port) == _drop_distinct(sketch)


def test_spill_dir_is_empty_after_the_profile(runs):
    _port_stats, _ref, _sketch, spill_dir = runs
    assert not spill_dir.exists() or os.listdir(spill_dir) == []


@pytest.mark.parametrize("kw", [
    {"unique_partitions": 1}, {"unique_partitions": 4},
    {"unique_partitions": 16}, {"unique_spill_workers": 0},
    {"unique_spill_workers": 2, "unique_partitions": 1},
    {"unique_track_total_rows": "auto"},
    {"unique_track_total_rows": 900}], ids=repr)
def test_tracker_settings_leave_the_stats(frame, runs, tmp_path, kw):
    port = runs[0]
    got = _port(frame, tmp_path / "s", **kw)
    assert _exported(got) == _exported(port)
    assert not (tmp_path / "s").exists() or os.listdir(tmp_path / "s") == []


def test_no_spill_gives_the_same_stats(frame, runs, tmp_path):
    """A budget that holds the whole stream writes no run and gives the
    spilled profile's stats."""
    got = _port(frame, tmp_path / "s", unique_track_rows=1 << 22,
                unique_track_total_rows=1 << 26)
    assert _exported(got) == _exported(runs[0])
    assert not (tmp_path / "s").exists()


def test_default_config_stats_do_not_move(frame, runs):
    """exact_distinct off: the tracker follows only the string columns, as
    before this slice; two runs are byte-identical."""
    assert _exported(_port(frame)) == _exported(runs[2])


def test_parity_in_both_packages(frame):
    port_cfg = ProfilerConfig(batch_rows=BATCH, parity=True,
                              unique_track_rows=TRACK)
    ref_cfg = RefConfig(backend="tpu", batch_rows=BATCH, parity=True,
                        unique_track_rows=TRACK)
    assert port_cfg.exact_distinct and port_cfg.spearman
    assert port_cfg.spill_dir_auto
    assert port_cfg.unique_spill_dir == ref_cfg.unique_spill_dir
    port = tpuprof_torch.describe(frame, device="cpu", config=port_cfg)
    ref = TPUStatsBackend().collect(frame, ref_cfg)
    truth = frame.nunique()
    for name, v in ref["variables"].items():
        assert port["variables"][name]["distinct_count"] == \
            v["distinct_count"] == truth[name], name
        assert port["variables"][name]["type"] == v["type"], name
    rp = np.asarray(port["correlations"]["spearman"], dtype=float)
    rr = np.asarray(ref["correlations"]["spearman"], dtype=float)
    assert np.allclose(rp, rr, rtol=0, atol=ATOL_RHO, equal_nan=True)
    assert glob.glob(os.path.join(port_cfg.unique_spill_dir, "*.u64")) == []


@pytest.mark.parametrize("kw", [
    {"parity": True, "exact_passes": False},
    {"exact_distinct": True},
    {"unique_partitions": 3},
    {"unique_spill_workers": -1},
    {"unique_track_total_rows": "lots"},
    {"exact_distinct": True, "unique_spill_dir": "d",
     "unique_track_rows": 0}], ids=repr)
def test_config_errors_are_the_reference(kw):
    with pytest.raises(ValueError) as ref_err:
        RefConfig(**kw)
    with pytest.raises(ValueError) as port_err:
        ProfilerConfig(**kw)
    assert str(port_err.value) == str(ref_err.value)


@pytest.fixture(scope="module")
def parquet(frame, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("pq") / "f.parquet")
    pq.write_table(pa.Table.from_pandas(frame, preserve_index=False), path,
                   row_group_size=1500)
    return path


def test_cli_flags_run(frame, parquet, tmp_path, capsys):
    spill = tmp_path / "spill"
    out = tmp_path / "s.json"
    rc = cli.main(["profile", parquet, "-o", str(tmp_path / "r.html"),
                   "--device", "cpu", "--batch-rows", str(BATCH),
                   "--exact-distinct", "--unique-spill-dir", str(spill),
                   "--unique-track-rows", str(TRACK),
                   "--unique-track-total-rows", "auto",
                   "--unique-partitions", "4",
                   "--unique-spill-workers", "0", "--stats-json", str(out)])
    assert rc == 0, capsys.readouterr().err
    with open(out) as fh:
        doc = json.load(fh)
    truth = frame.nunique()
    for name, var in doc["variables"].items():
        assert var["distinct_count"] == truth[name], name
    assert not spill.exists() or os.listdir(spill) == []
    rc = cli.main(["profile", parquet, "-o", str(tmp_path / "p.html"),
                   "--device", "cpu", "--batch-rows", str(BATCH),
                   "--parity", "--unique-track-rows", str(TRACK),
                   "--stats-json", str(out)])
    assert rc == 0, capsys.readouterr().err
    with open(out) as fh:
        doc = json.load(fh)
    assert "spearman" in doc["correlations"]
    for name, var in doc["variables"].items():
        assert var["distinct_count"] == truth[name], name


@pytest.mark.parametrize("flags,ref_kw", [
    (["--exact-distinct"], {"exact_distinct": True}),
    (["--parity", "--single-pass"], {"parity": True, "exact_passes": False}),
    (["--unique-partitions", "6"], {"unique_partitions": 6}),
    (["--unique-spill-workers", "-2"], {"unique_spill_workers": -2}),
    (["--exact-distinct", "--unique-spill-dir", "d",
      "--unique-track-rows", "0"],
     {"exact_distinct": True, "unique_spill_dir": "d",
      "unique_track_rows": 0})], ids=lambda v: str(v))
def test_cli_errors_are_the_reference(parquet, tmp_path, capsys, flags,
                                      ref_kw):
    with pytest.raises(ValueError) as ref_err:
        RefConfig(**ref_kw)
    rc = cli.main(["profile", parquet, "-o", str(tmp_path / "r.html"),
                   "--device", "cpu", *flags])
    assert rc == 2
    err = capsys.readouterr().err.strip().splitlines()
    assert err == [f"tpuprof_torch: error: {ref_err.value}"]
    assert not (tmp_path / "r.html").exists()


def test_checkpoint_with_spill_runs_survives_a_crash(frame, runs, tmp_path):
    """A checkpointed exact profile killed mid-scan leaves its checkpoint
    and the runs it references; the rerun resumes from them to the
    uninterrupted stats and removes them with the checkpoint.  Runs the
    killed scan wrote after its last save are referenced by nothing and
    stay until they age past the sweep (the reference's law); the next
    exact profile on the directory then removes them."""
    import time

    from tpuprof_torch.kernels.unique import ORPHAN_SWEEP_AGE_S
    spill = tmp_path / "spill"
    # synchronous writes: a queued write of the killed scan would land on
    # the io thread after the exception, racing the listing below
    ck = dict(checkpoint_path=str(tmp_path / "scan.ckpt"),
              checkpoint_every_batches=3, unique_spill_workers=0)
    faults.configure("fold:1@8")
    with pytest.raises(Exception, match="injected"):
        _port(frame, spill, **ck)
    faults.reset()
    assert (tmp_path / "scan.ckpt").exists()
    crashed = set(os.listdir(spill))
    assert crashed
    got = _port(frame, spill, **ck)
    assert _exported(got) == _exported(runs[0])
    assert not (tmp_path / "scan.ckpt").exists()
    left = set(os.listdir(spill))
    assert left < crashed           # the referenced runs went, no new one
    stale = time.time() - ORPHAN_SWEEP_AGE_S - 60
    for name in left:
        os.utime(spill / name, (stale, stale))
    _port(frame, spill)
    assert os.listdir(spill) == []


def test_resume_with_a_lost_run_falls_back_to_the_estimate(frame, tmp_path):
    spill = tmp_path / "spill"
    # synchronous writes: a queued write of the killed scan would land on
    # the io thread after the exception, racing the listing below
    ck = dict(checkpoint_path=str(tmp_path / "scan.ckpt"),
              checkpoint_every_batches=3, unique_spill_workers=0)
    faults.configure("fold:1@8")
    with pytest.raises(Exception, match="injected"):
        _port(frame, spill, **ck)
    faults.reset()
    for path in glob.glob(str(spill / "*.u64")):
        os.remove(path)
    got = _port(frame, spill, **ck)
    approx = [n for n, v in got["variables"].items() if v["distinct_approx"]]
    assert approx and set(approx) <= set(frame.columns)
    assert "rid" not in approx or got["variables"]["rid"]["type"] != "UNIQUE"
    assert os.listdir(spill) == []


def test_stream_through_a_fold_state_artifact(frame, tmp_path):
    """An exact stream written as a fold-state artifact mid-stream and
    resumed by ``resume_profiler`` counts on to the uninterrupted stream's
    stats; ``close`` then removes every run of both."""
    from tpuprof_torch.artifact import write_artifact
    spill = tmp_path / "spill"
    cfg = ProfilerConfig(batch_rows=BATCH, exact_distinct=True,
                         unique_spill_dir=str(spill),
                         unique_track_rows=TRACK)
    table = pa.Table.from_pandas(frame, preserve_index=False)
    cut = 3000
    with StreamingProfiler(table.schema, config=cfg, device="cpu") as prof:
        for lo in range(0, table.num_rows, 500):
            prof.update(table.slice(lo, 500))
            if lo + 500 == cut:
                write_artifact(str(tmp_path / "a.json"), profiler=prof)
        full = prof.stats()
        resumed = tpuprof_torch.resume_profiler(str(tmp_path / "a.json"),
                                                device="cpu")
        assert glob.glob(str(spill / "*.u64"))
        for lo in range(cut, table.num_rows, 500):
            resumed.update(table.slice(lo, 500))
        again = resumed.stats()
        resumed.close()
    truth = frame.nunique()
    for name, var in full["variables"].items():
        assert var["distinct_count"] == truth[name], name
        assert again["variables"][name]["distinct_count"] == truth[name]
    assert _exported(again) == _exported(full)
    assert os.listdir(spill) == []


def test_checkpointed_stream_keeps_its_runs_through_an_error(frame,
                                                             tmp_path):
    spill = tmp_path / "spill"
    cfg = ProfilerConfig(batch_rows=BATCH, exact_distinct=True,
                         unique_spill_dir=str(spill),
                         unique_track_rows=TRACK)
    table = pa.Table.from_pandas(frame, preserve_index=False)
    with pytest.raises(RuntimeError, match="boom"):
        with StreamingProfiler(table.schema, config=cfg,
                               device="cpu") as prof:
            prof.update(table.slice(0, 3000))
            prof.checkpoint(str(tmp_path / "s.ckpt"))
            raise RuntimeError("boom")
    assert glob.glob(str(spill / "*.u64"))
    back = StreamingProfiler.restore(str(tmp_path / "s.ckpt"), config=cfg,
                                     device="cpu")
    back.update(table.slice(3000))
    stats = back.stats()
    back.close()
    truth = frame.nunique()
    for name, var in stats["variables"].items():
        assert var["distinct_count"] == truth[name], name
    assert os.listdir(spill) == []


def test_stream_refuses_parity(frame):
    schema = pa.Table.from_pandas(frame.head(), preserve_index=False).schema
    with pytest.raises(InputError, match="parity is not supported"):
        StreamingProfiler(schema, config=ProfilerConfig(parity=True),
                          device="cpu")
