"""The port's profile telemetry against the reference's on one fixture.

The same frame goes through ``tpuprof_torch.describe(device="cpu")`` and
the reference's ``TPUStatsBackend`` (Pallas in interpret mode) with metrics
on, two-pass, fused warm from each package's own artifact, checkpointed (a
crash, then the resume), under the guard's retry, quarantine and watchdog
faults (the shared ``TPUPROF_FAULTS`` specs), with exact distinct spilling,
and through artifacts and a drift report.  Every counter the data and the
config fix is equal between the packages (labels naming threads compared
as totals); telemetry leaves ``stats_to_json`` as it was; the footer's
pipeline line is the reference's ``_pipeline_stats_line`` of the same
snapshot; the stream's ``heartbeat`` event carries the reference's fields.
"""

import json

import jax  # noqa: F401  (JAX stays on the CPU: tests/conftest.py)
import numpy as np
import pandas as pd
import pytest

import tpuprof.obs as ref_obs
import tpuprof_torch
from test_obs_smoke import validate_event
from tpuprof import ProfilerConfig as RefConfig
from tpuprof.artifact import compute_drift as ref_compute_drift
from tpuprof.artifact import read_artifact as ref_read_artifact
from tpuprof.artifact import write_artifact as ref_write_artifact
from tpuprof.backends.tpu import TPUStatsBackend
from tpuprof.report.render import _pipeline_stats_line as ref_footer_line
from tpuprof.runtime.stream import StreamingProfiler as RefStream
from tpuprof.testing import faults as ref_faults
from tpuprof_torch import obs
from tpuprof_torch.artifact import (compute_drift, read_artifact,
                                    write_artifact)
from tpuprof_torch.errors import WatchdogTimeout
from tpuprof_torch.obs import events, metrics
from tpuprof_torch.report.export import stats_to_json
from tpuprof_torch.report.render import _pipeline_stats_line, to_html
from tpuprof_torch.testing import faults
from torch_route import same_hash_route  # noqa: F401  (autouse)

BATCH = 256
N = 6 * BATCH

# counters whose values the data and the config fix, in both packages
COUNTERS = (
    "tpuprof_ingest_rows_total", "tpuprof_ingest_batches_total",
    "tpuprof_ingest_bytes_total", "tpuprof_prep_numeric_path_total",
    "tpuprof_prep_tasks_total", "tpuprof_prep_batch_tasks_total",
    "tpuprof_device_dispatch_total", "tpuprof_pass_b_dispatch_total",
    "tpuprof_singlepass_edge_hits_total",
    "tpuprof_singlepass_edge_misses_total",
    "tpuprof_checkpoint_saves_total", "tpuprof_checkpoint_restores_total",
    "tpuprof_checkpoint_fallbacks_total",
    "tpuprof_ingest_retries_total", "tpuprof_batches_quarantined_total",
    "tpuprof_artifact_writes_total", "tpuprof_artifact_reads_total",
    "tpuprof_artifact_corrupt_total", "tpuprof_artifact_resumes_total",
    "tpuprof_drift_reports_total", "tpuprof_unique_spill_bytes_total",
)
# compared as totals: their labels differ by design, not by data
TOTALS = {
    # thread names (worker="tpuprof-col_3" against "tpuprof-torch-col_3")
    "tpuprof_prep_tasks_total", "tpuprof_prep_batch_tasks_total",
    "tpuprof_prep_io_tasks_total",
    # the site of a drain watchdog: the reference watches its runner's
    # wait ("device_drain"), the port its copy to the host
    # ("device_wait"), both under the device_wait fault
    "tpuprof_watchdog_timeouts_total",
}


@pytest.fixture(autouse=True)
def clean():
    def reset():
        for m, ev in ((metrics, events), (ref_obs.metrics, ref_obs.events)):
            m.set_enabled(False)
            m.registry().reset()
            ev.set_sink(None)
        obs.configure(block_sample=0)
        ref_obs.configure(block_sample=0)
        faults.reset()
        ref_faults.reset()
    reset()
    yield
    reset()


def _frame(n=N, seed=0):
    rng = np.random.default_rng(seed)
    df = pd.DataFrame({
        "f": rng.normal(5.0, 2.0, n),
        "g": rng.normal(size=n).astype(np.float32),
        "i": rng.integers(0, 1000, n),
        "b": rng.random(n) > 0.5,
        "c": rng.choice(["alpha", "beta", "gamma"], n),
        "t": pd.Timestamp("2026-01-01")
        + pd.to_timedelta(rng.integers(0, 10_000, n), unit="s"),
    })
    df.loc[rng.choice(n, 40, replace=False), "f"] = np.nan
    return df


def _port(df, spec=None, **kw):
    kw.setdefault("batch_rows", BATCH)
    if spec:
        faults.configure(spec)
    try:
        return tpuprof_torch.describe(df, device="cpu",
                                      metrics_enabled=True, **kw)
    finally:
        faults.reset()


def _ref(df, spec=None, **kw):
    kw.setdefault("batch_rows", BATCH)
    if spec:
        ref_faults.configure(spec)
    try:
        return TPUStatsBackend().collect(df, RefConfig(
            backend="tpu", metrics_enabled=True, **kw))
    finally:
        ref_faults.reset()


def _counters(reg):
    snap = reg.snapshot()["counters"]
    out = {}
    for name in COUNTERS + tuple(sorted(TOTALS)):
        series = snap.get(name, {})
        if name in TOTALS:
            out[name] = sum(series.values())
        else:
            out[name] = {k: v for k, v in series.items() if v}
    return out


def _same_counters():
    mine, ref = _counters(metrics.registry()), _counters(
        ref_obs.metrics.registry())
    assert mine == ref
    return mine


def _both(df, spec=None, **kw):
    port = _port(df, spec, **kw)
    ref = _ref(df, spec, **kw)
    return port, ref, _same_counters()


def test_two_pass_counters_equal_the_reference():
    port, ref, c = _both(_frame())
    assert c["tpuprof_ingest_rows_total"] == {"": 2 * N}
    assert c["tpuprof_ingest_batches_total"] == {"": 12}
    assert c["tpuprof_device_dispatch_total"] == {
        '{program="step_a"}': 6, '{program="step_b"}': 6}
    assert c["tpuprof_pass_b_dispatch_total"] == {'{kernel="cumulative"}': 6}
    assert set(c["tpuprof_prep_numeric_path_total"]) == {
        '{path="zero_copy"}', '{path="slow"}'}
    assert port["_obs"]["counters"]["tpuprof_ingest_rows_total"] == \
        ref["_obs"]["counters"]["tpuprof_ingest_rows_total"]


def test_staged_scan_counters_equal_the_reference():
    """Full staged groups are one dispatch with a ``_batches`` series."""
    _, _, c = _both(_frame(n=8 * BATCH), scan_batches=4)
    assert c["tpuprof_device_dispatch_total"] == {
        '{program="scan_a"}': 2, '{program="scan_a_batches"}': 8,
        '{program="scan_b"}': 2, '{program="scan_b_batches"}': 8}


def test_telemetry_leaves_the_result_unchanged():
    df = _frame()
    off = tpuprof_torch.describe(df, device="cpu", batch_rows=BATCH)
    assert "_obs" not in off
    on = _port(df, metrics_block_sample=1)
    assert "_obs" in on
    assert json.dumps(stats_to_json(on), sort_keys=True) == \
        json.dumps(stats_to_json(off), sort_keys=True)
    blk = on["_obs"]["histograms"]["tpuprof_device_block_seconds"]
    assert blk['{program="step_a"}']["count"] == 6


def test_footer_line_equals_the_reference_on_the_same_snapshot():
    port = _port(_frame(), checkpoint_path=None)
    line = _pipeline_stats_line(port)
    assert line == ref_footer_line(port)
    assert line.startswith(f"{2 * N:,} rows ingested · 12 batches "
                           "prepared · 12 device dispatches · ")
    assert "host rss" in line and "device mem" not in line
    assert f"pipeline: {line}" in to_html(port, tpuprof_torch.ProfilerConfig())
    assert _pipeline_stats_line({}) == ""
    fixed = {"_obs": {
        "counters": {
            "tpuprof_ingest_rows_total": {"": 1234},
            "tpuprof_device_dispatch_total": {'{program="scan_a"}': 5,
                                              '{program="scan_a_batches"}':
                                              40},
            "tpuprof_prep_numeric_path_total": {'{path="zero_copy"}': 3,
                                                '{path="slow"}': 1}},
        "histograms": {"tpuprof_checkpoint_save_seconds": {
            "": {"count": 2, "sum": 0.5, "mean": 0.25}}},
        "gauges": {"tpuprof_device_memory_bytes": {
            '{device="cuda:0",kind="in_use"}': 2 << 30,
            '{device="cuda:0",kind="limit"}': 80 << 30}}}}
    assert _pipeline_stats_line(fixed) == ref_footer_line(fixed)
    assert "5 device dispatches" in _pipeline_stats_line(fixed)
    assert "(2% of limit)" in _pipeline_stats_line(fixed)


def test_fused_warm_from_an_artifact(tmp_path):
    df = _frame()
    two, ref_two, _ = _both(df)
    write_artifact(str(tmp_path / "port.json"), stats=two,
                   config=tpuprof_torch.ProfilerConfig(batch_rows=BATCH))
    ref_write_artifact(str(tmp_path / "ref.json"), stats=ref_two,
                       config=RefConfig(batch_rows=BATCH))
    metrics.registry().reset()
    ref_obs.metrics.registry().reset()
    port = _port(df, profile_passes="fused",
                 seed_edges=str(tmp_path / "port.json"))
    _ref(df, profile_passes="fused", seed_edges=str(tmp_path / "ref.json"))
    c = _same_counters()
    n_num = 4           # f, g, i, b
    assert c["tpuprof_singlepass_edge_hits_total"] == {"": n_num}
    assert c["tpuprof_singlepass_edge_misses_total"] == {}
    assert c["tpuprof_artifact_reads_total"] == {"": 1}
    assert c["tpuprof_device_dispatch_total"]['{program="step_ab"}'] == 6
    assert stats_to_json(port) == stats_to_json(two)


def test_fused_cold_rebin_event(tmp_path):
    """A cold fused profile misses lanes and re-bins them: the same hits,
    misses and ``singlepass_rebin`` columns as the reference."""
    path = str(tmp_path / "m.jsonl")
    df = _frame()
    df["f"] = np.where(np.arange(N) < BATCH, 0.0, df["f"])
    _port(df, profile_passes="fused", metrics_path=path)
    _ref(df, profile_passes="fused")
    c = _same_counters()
    assert c["tpuprof_singlepass_edge_misses_total"]
    evs = [json.loads(ln) for ln in open(path)]
    rebin = [e for e in evs if e["kind"] == "singlepass_rebin"]
    assert len(rebin) == 1 and "f" in rebin[0]["columns"]
    assert rebin[0]["origin"] == "sketch"
    for ev in evs:
        validate_event(ev)


def test_checkpoint_crash_then_resume(tmp_path):
    df = _frame(n=12 * BATCH)
    kw = dict(checkpoint_every_batches=3)
    paths = {run: str(tmp_path / f"{run.__name__}.ckpt")
             for run in (_port, _ref)}
    for run, path in paths.items():
        with pytest.raises(Exception, match="injected"):
            run(df, "fold:1@8", checkpoint_path=path, **kw)
    # the crashed runs' ingest counts are left out: how many batches the
    # prepare pool had read ahead when the fold raised is a race
    saves = [reg.counter("tpuprof_checkpoint_saves_total").total()
             for reg in (metrics.registry(), ref_obs.metrics.registry())]
    assert saves == [2, 2]                  # at cursors 3 and 6
    metrics.registry().reset()
    ref_obs.metrics.registry().reset()
    for run, path in paths.items():
        run(df, checkpoint_path=path, **kw)
    c = _same_counters()
    # the resume reads the batches after cursor 6 and saves at 9 and 12
    assert c["tpuprof_checkpoint_saves_total"] == {"": 2}
    assert c["tpuprof_checkpoint_restores_total"] == {"": 1}
    snap = metrics.registry().snapshot()
    assert snap["gauges"]["tpuprof_checkpoint_bytes"][""] > 0


# one pass under quarantine: the reference's pass B reads the batches pass
# A skipped again, the port's skips them in both passes, so two-pass rows
# and dispatches differ by design (tests/test_torch_guard.py)
@pytest.mark.parametrize("spec,kw,site", [
    ("prep:transient", dict(ingest_retries=1, retry_backoff_s=0.0),
     "ingest_retries"),
    ("prep:2@3", dict(ingest_retries=0, max_quarantined=5,
                      prepare_workers=1, exact_passes=False),
     "batches_quarantined"),
])
def test_guard_fault_counters(tmp_path, spec, kw, site):
    path = str(tmp_path / "m.jsonl")
    port = _port(_frame(), spec, metrics_path=path, **kw)
    _ref(_frame(), spec, **kw)
    c = _same_counters()
    assert c[f"tpuprof_{site}_total"]
    kinds = {json.loads(ln)["kind"] for ln in open(path)}
    assert {"ingest_retry" if "retries" in site else "batch_quarantined"} \
        <= kinds
    if "quarantined" in site:
        assert len(port["_quarantine"]) == 2


def test_watchdog_timeout_counters(tmp_path):
    path = str(tmp_path / "m.jsonl")
    with pytest.raises(WatchdogTimeout):
        _port(_frame(n=2 * BATCH), "device_wait:sleep=2",
              drain_timeout_s=0.15, metrics_path=path)
    from tpuprof.errors import WatchdogTimeout as RefTimeout
    with pytest.raises(RefTimeout):
        _ref(_frame(n=2 * BATCH), "device_wait:sleep=2",
             drain_timeout_s=0.15)
    c = _same_counters()
    assert c["tpuprof_watchdog_timeouts_total"] == 1
    ev = [json.loads(ln) for ln in open(path)]
    (wd,) = [e for e in ev if e["kind"] == "watchdog_timeout"]
    validate_event(wd)
    assert wd["heartbeat"]["rows"] == 2 * BATCH


def test_exact_distinct_spill_counters(tmp_path):
    df = _frame()
    df["u"] = np.arange(N).astype(str)
    kw = dict(exact_distinct=True, unique_track_rows=300)
    path = str(tmp_path / "m.jsonl")
    _port(df, unique_spill_dir=str(tmp_path / "port"), metrics_path=path,
          **kw)
    _ref(df, unique_spill_dir=str(tmp_path / "ref"), **kw)
    c = _same_counters()
    assert c["tpuprof_unique_spill_bytes_total"][""] > 0
    assert c["tpuprof_prep_io_tasks_total"] > 0     # one a queued run
    spills = [json.loads(ln) for ln in open(path)
              if '"unique_spill"' in ln]
    assert spills and all(validate_event(e) is None for e in spills)
    assert sum(e["bytes"] for e in spills) == \
        c["tpuprof_unique_spill_bytes_total"][""]


def test_artifact_and_drift_counters(tmp_path):
    df = _frame()
    port, ref = _port(df), _ref(df)
    metrics.registry().reset()
    ref_obs.metrics.registry().reset()
    for pkg, st, cfg, write, read, drift in (
            ("port", port, tpuprof_torch.ProfilerConfig(), write_artifact,
             read_artifact, compute_drift),
            ("ref", ref, RefConfig(), ref_write_artifact, ref_read_artifact,
             ref_compute_drift)):
        a = str(tmp_path / f"{pkg}.json")
        write(a, stats=st, config=cfg)
        drift(read(a), read(a))
        with open(a, "rb") as fh:
            data = fh.read()
        with open(a, "wb") as fh:       # one value of the sealed body
            fh.write(data.replace(b"alpha", b"alphz", 1))
        with pytest.raises(Exception, match="CRC"):
            read(a)
    c = _same_counters()
    assert c["tpuprof_artifact_writes_total"] == {"": 1}
    assert c["tpuprof_artifact_reads_total"] == {"": 2}
    assert c["tpuprof_artifact_corrupt_total"] == {"": 1}
    assert c["tpuprof_drift_reports_total"] == {"": 1}


def test_stream_heartbeat_and_counters(tmp_path):
    df = _frame(n=1000)
    path = str(tmp_path / "stream.jsonl")
    obs.configure(enabled=True, jsonl_path=path)
    ref_obs.configure(enabled=True)
    cfg = tpuprof_torch.ProfilerConfig(batch_rows=BATCH,
                                       metrics_enabled=True)
    rcfg = RefConfig(batch_rows=BATCH, metrics_enabled=True)
    with tpuprof_torch.StreamingProfiler.for_example(
            df, config=cfg, device="cpu") as prof:
        ref = RefStream.for_example(df, config=rcfg)
        for lo in range(0, 1000, 300):
            prof.update(df.iloc[lo:lo + 300])
            ref.update(df.iloc[lo:lo + 300])
        hb, ref_hb = prof.heartbeat(), ref.heartbeat()
        stats = prof.stats()
        ref.stats()
        ref.close()
    assert set(hb) == set(ref_hb)
    assert {k: hb[k] for k in ("rows_folded", "rows_buffered",
                               "batches_folded", "columns")} == \
        {k: ref_hb[k] for k in ("rows_folded", "rows_buffered",
                                "batches_folded", "columns")}
    evs = [json.loads(ln) for ln in open(path)]
    beats = [e for e in evs if e["kind"] == "heartbeat"]
    assert beats and set(beats[0]) == set(hb) | {"ts", "kind"}
    for ev in evs:
        validate_event(ev)
    assert any(e["kind"] == "span" and e["name"] == "drain" for e in evs)
    ctx = obs.blackbox.box().snapshot()["context"]
    assert ctx["last_heartbeat"] == hb
    mine = metrics.registry().snapshot()["counters"]
    theirs = ref_obs.metrics.registry().snapshot()["counters"]
    for name in ("tpuprof_stream_batches_folded_total",
                 "tpuprof_stream_rows_total", "tpuprof_ingest_rows_total"):
        assert mine[name] == theirs[name], name
    assert mine["tpuprof_stream_rows_total"][""] == 1000
    assert stats["_obs"]["counters"]["tpuprof_stream_rows_total"][""] == 1000
    assert metrics.histogram("tpuprof_stream_drain_seconds").summary()[
        "count"] >= 1
    assert "rows folded" in prof.progress()
