"""The port's per-batch spans and thread-seconds (``obs/spans.py``).

A two-pass ``describe(device="cpu")`` of a table of 16 batches names every
stage of its scans in ``stats["_phases"]``: on the profiling thread the
quiet spans ``wait_*``, the host folds, ``stage_*``, ``launch_*`` and
``drain_b``, which together cover each scan; the loud spans
``ingest_open`` and ``assemble`` around the work outside the scans; from
the prepare pool the thread-seconds ``decode_*`` and ``hash_a``.  Quiet
spans emit no event; only the profiling thread marks a trace; no new name
starts with ``scan``, so the footer's rate is the scans' alone.
"""

import json
import logging
import sys
import threading

import numpy as np
import pandas as pd
import pyarrow as pa
import pytest

import tpuprof_torch
from tpuprof_torch import obs
from tpuprof_torch.artifact import write_artifact
from tpuprof_torch.ingest.arrow import ArrowIngest, prepare_batch
from tpuprof_torch.obs import events, metrics, spans
from tpuprof_torch.report.render import _perf_line
from tpuprof_torch.runtime import singlepass
from tpuprof_torch.utils import trace

BATCH = 2048
N = 16 * BATCH

CHILDREN = {
    "scan_a": ("wait_a", "sampler_a", "hll_host_a", "hostagg_a", "stage_a",
               "launch_a"),
    "scan_b": ("wait_b", "recount_b", "stage_b", "launch_b", "drain_b"),
}
OUTSIDE = ("ingest_open", "assemble")
THREAD_SECONDS = ("decode_a", "hash_a", "decode_b")
NEW = sum(CHILDREN.values(), ()) + OUTSIDE + THREAD_SECONDS
QUIET = sum(CHILDREN.values(), ())


def _frame(strings=True):
    rng = np.random.default_rng(19)
    df = pd.DataFrame(rng.normal(size=(N, 24)).astype(np.float32),
                      columns=[f"c{i}" for i in range(24)])
    if strings:
        df["s"] = rng.choice(["a", "b", "c", "d"], size=N)
        df["d"] = pd.Timestamp("2019-01-01") + pd.to_timedelta(
            rng.integers(0, 10 ** 6, size=N), unit="s")
    return df


@pytest.fixture(autouse=True)
def clean():
    def reset():
        metrics.set_enabled(False)
        metrics.registry().reset()
        events.set_sink(None)
        obs.configure(block_sample=0)
    reset()
    yield
    reset()


@pytest.fixture(scope="module")
def two_pass():
    df = _frame()
    return tpuprof_torch.describe(df, device="cpu", batch_rows=BATCH)


def test_two_pass_profile_has_every_new_phase(two_pass):
    phases = two_pass["_phases"]
    assert set(NEW) <= set(phases)
    for name in NEW:
        assert phases[name] > 0, name


@pytest.mark.parametrize("parent", sorted(CHILDREN))
def test_children_cover_their_scan(two_pass, parent):
    phases = two_pass["_phases"]
    covered = sum(phases[c] for c in CHILDREN[parent])
    assert 0.9 * phases[parent] <= covered <= phases[parent]


def test_fused_profile_with_every_edge_a_hit_has_no_pass_b_child(tmp_path):
    df = _frame(strings=False)
    path = str(tmp_path / "seed.json")
    write_artifact(path, stats=tpuprof_torch.describe(
        df, device="cpu", batch_rows=BATCH))
    misses = singlepass.edge_misses
    stats = tpuprof_torch.describe(df, device="cpu", batch_rows=BATCH,
                                   profile_passes="fused", seed_edges=path)
    assert singlepass.edge_misses == misses
    phases = stats["_phases"]
    assert "scan_b" not in phases
    assert not [k for k in phases if k.endswith("_b")]
    assert {"wait_a", "stage_a", "launch_a", "decode_a", "hash_a"} \
        <= set(phases)


def test_no_new_phase_starts_with_scan(two_pass):
    phases = two_pass["_phases"]
    assert not [k for k in NEW if k.startswith("scan")]
    assert [k for k in phases if k.startswith("scan")] == ["scan_a",
                                                          "scan_b"]
    rate = N / (phases["scan_a"] + phases["scan_b"])
    assert _perf_line(two_pass).startswith(f"{rate:,.0f} rows/s · ")


def test_quiet_spans_emit_no_event(tmp_path):
    path = tmp_path / "events.jsonl"
    tpuprof_torch.describe(_frame(), device="cpu", batch_rows=BATCH,
                           metrics_enabled=True, metrics_path=str(path))
    events.set_sink(None)
    names = [e["name"] for e in map(json.loads, open(path))
             if e["kind"] == "span"]
    assert not set(QUIET) & set(names)
    assert names.count("ingest_open") == 1 and names.count("assemble") == 1
    assert {"scan_a", "merge", "scan_b"} <= set(names)
    text = metrics.registry().render_text()
    assert 'tpuprof_span_seconds_count{name="assemble"} 1' in text
    assert 'name="wait_a"' not in text


def test_only_the_profiling_thread_marks_the_trace(tmp_path):
    d = tmp_path / "trace"
    with trace.trace_to(str(d), "cpu"):
        tpuprof_torch.describe(_frame(), device="cpu", batch_rows=BATCH)
    doc = json.loads(open(trace.trace_path(str(d))).read())
    ranges = [e for e in doc["traceEvents"]
              if e.get("cat") == "user_annotation"]
    names = {e["name"] for e in ranges}
    assert {"wait_a", "launch_a", "scan_a", "ingest_open",
            "assemble"} <= names
    assert not names & set(THREAD_SECONDS)
    assert len({e["tid"] for e in ranges}) == 1


def test_quiet_span_times_and_marks_but_is_off_the_stack():
    spans.get_phase_report(reset=True)
    # the flight recorder is process-wide: an earlier test's loud "inner"
    # span would read as this quiet one's event
    obs.blackbox.box().clear()
    marked = []

    class Mark:
        def __init__(self, name):
            marked.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    spans.annotate = Mark
    try:
        with spans.span("outer"):
            with spans.span("inner", quiet=True):
                assert spans.current_path() == "outer"
    finally:
        spans.annotate = None
    report = spans.get_phase_report(reset=True)
    assert set(report) == {"outer", "inner"}
    assert 0 <= report["inner"] <= report["outer"]
    assert marked == ["outer", "inner"]
    assert not [e for e in obs.blackbox.box().entries()
                if e.get("name") == "inner"]


def test_quiet_span_that_raises_is_recorded():
    spans.get_phase_report(reset=True)
    with pytest.raises(RuntimeError):
        with spans.span("doomed_quietly", quiet=True):
            raise RuntimeError("boom")
    assert "doomed_quietly" in spans.get_phase_report(reset=True)


def test_add_from_many_threads_loses_nothing():
    spans.get_phase_report(reset=True)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [spans.add("pool", 0.5) for _ in range(500)])
            for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert spans.get_phase_report(reset=True) == {"pool": 16 * 500 * 0.5}


def test_span_formats_its_debug_line_only_when_debug_is_on(monkeypatch,
                                                          caplog):
    def refuse(*a, **k):
        raise AssertionError("json.dumps with DEBUG off")

    with caplog.at_level(logging.INFO, logger="tpuprof_torch"):
        monkeypatch.setattr(spans.json, "dumps", refuse)
        with spans.span("cheap", cols=3):
            pass
        monkeypatch.undo()
    with caplog.at_level(logging.DEBUG, logger="tpuprof_torch"):
        with spans.span("logged", cols=3):
            pass
    (line,) = [json.loads(r.getMessage()) for r in caplog.records
               if "logged" in r.getMessage()]
    assert line["event"] == "phase" and line["cols"] == 3
    spans.get_phase_report(reset=True)


@pytest.mark.parametrize("hashes", [True, False])
def test_prepare_batch_adds_decode_and_hash_seconds(hashes):
    df = _frame()
    ing = ArrowIngest(pa.Table.from_pandas(df, preserve_index=False), BATCH)
    rb = next(iter(ing.raw_batches()))
    spans.get_phase_report(reset=True)
    prepare_batch(rb, ing.plan, BATCH, 11, hashes=hashes)
    report = spans.get_phase_report(reset=True)
    if hashes:
        assert set(report) == {"decode_a", "hash_a"}
        assert report["hash_a"] > 0
    else:
        assert set(report) == {"decode_b"}
    assert all(v > 0 for v in report.values())
