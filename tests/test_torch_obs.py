"""The port's telemetry layer against the reference's (``tpuprof/obs``).

The registry gives the same bytes for the same calls (``render_text``,
``snapshot``, ``to_wire``, ``merge_wire`` of two hosts' wires, a skewed
ladder included), and behaves the same disabled, on a kind mismatch and
under threads; the port registers the reference's 49 pipeline instruments,
the fleet's and the serve daemon's with the reference's kinds; spans nest per thread with the reference's
paths and depths; the JSONL sink rotates as the reference's; ``RateEMA``,
``registry_progress_line`` and the config resolvers agree; the flight
recorder keeps the reference's ring, bundle and signal semantics; memory
gauges stay silent on the CPU; ``observe_dispatch`` counts, samples and
records; ``trace_to`` writes one Chrome trace, and says where even when its
body raises.  The ``cuda``-marked tests hold the device half on a card.
"""

import importlib.util
import json
import logging
import os
import signal
import subprocess
import sys
import threading
from pathlib import Path

import jax  # noqa: F401  (JAX stays on the CPU: tests/conftest.py)
import numpy as np
import pytest
import torch

import tpuprof.artifact.drift  # noqa: F401  (each registers instruments)
import tpuprof.artifact.incremental  # noqa: F401
import tpuprof.ingest.prep  # noqa: F401
import tpuprof.kernels.unique  # noqa: F401
import tpuprof.obs as ref_obs
import tpuprof.runtime.aot  # noqa: F401
import tpuprof.runtime.checkpoint  # noqa: F401
import tpuprof.runtime.fleet  # noqa: F401
import tpuprof.runtime.guard  # noqa: F401
import tpuprof.runtime.singlepass  # noqa: F401
import tpuprof.runtime.stream  # noqa: F401
import tpuprof.serve.server  # noqa: F401
import tpuprof_torch  # noqa: F401  (imports every module of the port)
import tpuprof_torch.artifact.drift  # noqa: F401
import tpuprof_torch.artifact.incremental  # noqa: F401
import tpuprof_torch.serve  # noqa: F401
from test_obs_smoke import EVENT_SCHEMA
from tpuprof import config as ref_config
from tpuprof.obs import blackbox as ref_blackbox
from tpuprof.obs import events as ref_events
from tpuprof.obs import fleet as ref_fleet
from tpuprof.obs import metrics as ref_metrics
from tpuprof.obs import progress as ref_progress
from tpuprof_torch import config as port_config
from tpuprof_torch import obs
from tpuprof_torch.kernels import fused
from tpuprof_torch.obs import blackbox, events, fleet, memory, metrics
from tpuprof_torch.obs import progress
from tpuprof_torch.runtime import guard
from tpuprof_torch.testing import faults
from tpuprof_torch.utils import trace

REPO = Path(__file__).resolve().parents[1]

# the pipeline's instruments: ingest, prep pools, unique spill, guard,
# checkpoints, single pass, artifacts, resume, drift, spans, device
# dispatch and memory, pass B, host RSS and the stream
INSTRUMENTS = (
    "tpuprof_ingest_rows_total", "tpuprof_ingest_bytes_total",
    "tpuprof_ingest_batches_total", "tpuprof_prep_numeric_path_total",
    "tpuprof_prep_batch_seconds", "tpuprof_prep_queue_depth",
    "tpuprof_prep_tasks_total", "tpuprof_prep_batch_tasks_total",
    "tpuprof_prep_io_tasks_total",
    "tpuprof_unique_spill_bytes_total", "tpuprof_unique_spill_seconds",
    "tpuprof_unique_partitions", "tpuprof_unique_spill_pending",
    "tpuprof_ingest_retries_total", "tpuprof_batches_quarantined_total",
    "tpuprof_watchdog_timeouts_total", "tpuprof_watchdog_wait_seconds",
    "tpuprof_checkpoint_saves_total", "tpuprof_checkpoint_restores_total",
    "tpuprof_checkpoint_fallbacks_total",
    "tpuprof_checkpoint_save_seconds", "tpuprof_checkpoint_restore_seconds",
    "tpuprof_checkpoint_bytes",
    "tpuprof_singlepass_edge_hits_total",
    "tpuprof_singlepass_edge_misses_total",
    "tpuprof_singlepass_rebin_seconds",
    "tpuprof_artifact_writes_total", "tpuprof_artifact_reads_total",
    "tpuprof_artifact_corrupt_total", "tpuprof_artifact_write_seconds",
    "tpuprof_artifact_read_seconds", "tpuprof_artifact_bytes",
    "tpuprof_artifact_resumes_total", "tpuprof_artifact_resume_seconds",
    "tpuprof_artifact_resumed_rows",
    "tpuprof_drift_reports_total", "tpuprof_drift_seconds",
    "tpuprof_drift_columns_flagged",
    "tpuprof_span_seconds",
    "tpuprof_device_dispatch_total", "tpuprof_device_block_seconds",
    "tpuprof_device_memory_bytes",
    "tpuprof_pass_b_dispatch_total", "tpuprof_pass_b_dispatch_seconds",
    "tpuprof_host_rss_bytes",
    "tpuprof_stream_batches_folded_total", "tpuprof_stream_rows_total",
    "tpuprof_stream_drain_seconds", "tpuprof_stream_prefetch_overlap_ratio",
)
# the elastic fleet's rebalance instruments (runtime/fleet.py)
FLEET_INSTRUMENTS = (
    "tpuprof_fleet_rebalances_total", "tpuprof_fragments_stolen_total",
    "tpuprof_fleet_fragments_claimed", "tpuprof_fleet_fragments_done",
)
# the serve daemon's (serve/cache.py, serve/scheduler.py, serve/server.py)
# and the store of built kernel libraries' (runtime/aot.py)
SERVE_INSTRUMENTS = (
    "tpuprof_serve_compile_cache_hits_total",
    "tpuprof_serve_compile_cache_misses_total",
    "tpuprof_read_cache_hits_total", "tpuprof_read_cache_misses_total",
    "tpuprof_read_cache_evictions_total", "tpuprof_read_cache_demotes_total",
    "tpuprof_read_cache_bytes", "tpuprof_read_cache_entries",
    "tpuprof_serve_requests_total", "tpuprof_serve_queue_depth",
    "tpuprof_serve_active_jobs", "tpuprof_serve_job_seconds",
    "tpuprof_coalesced_jobs_total", "tpuprof_requests_shed_total",
    "tpuprof_deadline_expired_total", "tpuprof_serve_jobs_claimed",
    "tpuprof_serve_jobs_stolen_total", "tpuprof_serve_drain_seconds",
    "tpuprof_aot_cache_hits_total", "tpuprof_aot_cache_misses_total",
    "tpuprof_aot_load_seconds", "tpuprof_aot_save_seconds",
)


def _reset_obs():
    for m, ev in ((metrics, events), (ref_metrics, ref_events)):
        m.set_enabled(False)
        m.registry().reset()
        ev.set_sink(None)
    obs.configure(block_sample=0)
    ref_obs.configure(block_sample=0)


@pytest.fixture(autouse=True)
def clean_obs():
    """Both packages' registries, sinks and sample rates start and end
    each test disabled and empty."""
    _reset_obs()
    yield
    _reset_obs()


# ---------------------------------------------------------------------------
# the registry, byte for byte
# ---------------------------------------------------------------------------

def _drive(mod, skew=False):
    """One fixed sequence of calls on a fresh registry of ``mod``: escaped
    labels, both label orders, a silent instrument, histograms on a custom
    ladder (another one with ``skew``) and on ``TIME_BUCKETS``."""
    reg = mod.MetricsRegistry(enabled=True)
    c = reg.counter("c_total", "a counter")
    c.inc()
    c.inc(2, program="x")
    c.inc(1.5, path='we"ird\\lab\nel')
    c.inc(3, a="1", b="2")
    c.inc(4, b="2", a="1")
    g = reg.gauge("g", "a gauge")
    g.set(3.5)
    g.inc(0.5)
    g.dec(2.0, device="cuda:0", kind="in_use")
    g.set(1e12, device="cuda:0", kind="limit")
    reg.gauge("never_fired")
    h = reg.histogram("h_seconds", "a histogram",
                      buckets=(0.2, 2.0) if skew else (0.1, 1.0))
    for v in (0.05, 0.5, 5.0, 1.0):
        h.observe(v)
    h.observe(0.3, site="prep")
    t = reg.histogram("t_seconds")
    for v in (0.00005, 0.0003, 0.02, 7.0, 100.0, 1 / 3):
        t.observe(v, name="scan_a")
    return reg


def _same(a, b):
    assert a.render_text() == b.render_text()
    assert json.dumps(a.snapshot(), sort_keys=True) == \
        json.dumps(b.snapshot(), sort_keys=True)
    assert json.dumps(a.to_wire(), sort_keys=True) == \
        json.dumps(b.to_wire(), sort_keys=True)


@pytest.mark.parametrize("skew", [False, True])
def test_registry_outputs_equal_the_reference(skew):
    _same(_drive(metrics, skew), _drive(ref_metrics, skew))
    assert metrics.TIME_BUCKETS == ref_metrics.TIME_BUCKETS


def test_merge_wire_of_two_hosts_equals_the_reference():
    """Counters sum, gauges split by host, a skewed ladder keeps the
    host's series: the merged registry and the fleet view are the
    reference's bytes, whichever package wrote each wire."""
    wires = [_drive(metrics).to_wire(), _drive(metrics, skew=True).to_wire()]
    ref_wires = [_drive(ref_metrics).to_wire(),
                 _drive(ref_metrics, skew=True).to_wire()]
    assert wires == ref_wires
    mine = metrics.MetricsRegistry(enabled=True)
    ref = ref_metrics.MetricsRegistry(enabled=True)
    for i, (w, rw) in enumerate(zip(wires, ref_wires)):
        mine.merge_wire(w, host=str(i))
        ref.merge_wire(rw, host=str(i))
    _same(mine, ref)
    assert 'g{host="1"} 4' in mine.render_text()
    _same(fleet.merge_wires(wires), ref_fleet.merge_wires(ref_wires))


def test_disabled_registry_records_nothing_as_the_reference():
    got = []
    for mod in (metrics, ref_metrics):
        reg = mod.MetricsRegistry(enabled=False)
        c, h = reg.counter("c_total"), reg.histogram("h_seconds")
        c.inc(100)
        h.observe(1.0)
        before = (c.total(), h.summary()["count"], reg.render_text())
        reg.enabled = True
        c.inc()
        got.append((before, c.total(), reg.render_text()))
    assert got[0] == got[1]
    assert got[0][0][:2] == (0, 0) and got[0][1] == 1


@pytest.mark.parametrize("mod", [metrics, ref_metrics],
                         ids=["port", "reference"])
def test_kind_mismatch_raises(mod):
    reg = mod.MetricsRegistry()
    reg.counter("x")
    with pytest.raises(ValueError, match="already registered as counter"):
        reg.gauge("x")
    assert reg.counter("x") is reg.counter("x")


def test_registry_thread_safety():
    reg = metrics.MetricsRegistry(enabled=True)
    c = reg.counter("c_total")
    h = reg.histogram("h_seconds")

    def worker():
        for _ in range(1000):
            c.inc(worker="w")
            h.observe(0.01)

    threads = [threading.Thread(target=worker) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert c.total() == 8000 and h.summary()["count"] == 8000


def test_snapshot_render_concurrent_with_fault_injection():
    """Reads of the process registry never raise or tear while the port's
    guard retries and quarantines seeded faults from worker threads."""
    metrics.set_enabled(True)
    faults.configure("prep:0.5", seed=7)
    stop = threading.Event()
    errors = []
    try:
        quarantine = guard.Quarantine(max_quarantined=1 << 30)
        bg = guard.BatchGuard(retries=2, backoff_s=0.0, capture=True)

        def mutate(tid):
            k = 0
            while not stop.is_set():
                out = bg.run(lambda: None, site="prep", key=(tid, k))
                if isinstance(out, guard.PoisonBatch):
                    quarantine.admit(site=out.site, error=out.error)
                k += 1

        def read():
            reg = metrics.registry()
            while not stop.is_set():
                try:
                    json.dumps(reg.snapshot())
                    assert reg.render_text().endswith("\n")
                    reg.to_wire()
                except Exception as exc:        # pragma: no cover
                    errors.append(exc)
                    return

        threads = [threading.Thread(target=mutate, args=(t,))
                   for t in range(4)]
        threads += [threading.Thread(target=read) for _ in range(3)]
        for t in threads:
            t.start()
        stop.wait(0.8)
        stop.set()
        for t in threads:
            t.join(timeout=10)
        assert not any(t.is_alive() for t in threads)
        assert not errors
        assert metrics.counter("tpuprof_ingest_retries_total").total() > 0
        assert metrics.counter(
            "tpuprof_batches_quarantined_total").total() > 0
    finally:
        stop.set()
        faults.reset()


def test_the_49_instruments_with_the_reference_kinds():
    mine = {n: i.kind for n, i in metrics.registry()._instruments.items()}
    ref = {n: i.kind for n, i in ref_metrics.registry()._instruments.items()}
    assert len(INSTRUMENTS) == len(set(INSTRUMENTS)) == 49
    every = INSTRUMENTS + FLEET_INSTRUMENTS + SERVE_INSTRUMENTS
    assert len(every) == len(set(every)) == 49 + 4 + 22
    assert set(mine) == set(every)
    assert {n: ref[n] for n in every} == mine
    for name in every:
        a = metrics.registry()._instruments[name]
        b = ref_metrics.registry()._instruments[name]
        assert getattr(a, "buckets", None) == getattr(b, "buckets", None)


# ---------------------------------------------------------------------------
# spans, events, the sink, progress
# ---------------------------------------------------------------------------

def _span_script(pkg_obs, path):
    """Nested spans on the main thread and one on a worker; returns the
    (name, path, depth) of each span event the sink received, and the
    span the worker saw."""
    pkg_obs.configure(enabled=True, jsonl_path=path)
    seen = []

    def worker():
        with pkg_obs.span("w", rows=np.int64(3)):
            seen.append(pkg_obs.current_path())

    with pkg_obs.span("outer", cols=2):
        assert pkg_obs.current_path() == "outer"
        with pkg_obs.span("inner"):
            with pkg_obs.span("leaf"):
                assert pkg_obs.current_path() == "outer.inner.leaf"
            t = threading.Thread(target=worker)
            t.start()
            t.join(timeout=10)
        assert pkg_obs.current_path() == "outer"
    pkg_obs.configure(enabled=False)
    pkg_obs.events.set_sink(None)
    spans = [json.loads(ln) for ln in open(path)]
    return [(e["name"], e["path"], e["depth"]) for e in spans
            if e["kind"] == "span"], seen, spans


def test_span_nesting_equals_the_reference(tmp_path):
    mine, seen, evs = _span_script(obs, str(tmp_path / "port.jsonl"))
    ref, ref_seen, _ = _span_script(ref_obs, str(tmp_path / "ref.jsonl"))
    assert mine == ref and seen == ref_seen == ["w"]
    assert ("leaf", "outer.inner.leaf", 3) in mine
    assert ("w", "w", 1) in mine
    outer = next(e for e in evs if e["name"] == "outer")
    assert outer["cols"] == 2 and outer["seconds"] >= 0
    assert next(e for e in evs if e["name"] == "w")["rows"] in (3, "3")
    text = metrics.registry().render_text()
    assert 'tpuprof_span_seconds_count{name="outer"} 1' in text


def test_span_that_raises_is_recorded():
    metrics.set_enabled(True)
    obs.get_phase_report(reset=True)
    with pytest.raises(RuntimeError):
        with obs.span("doomed"):
            raise RuntimeError("boom")
    assert "doomed" in obs.get_phase_report(reset=True)
    assert metrics.histogram("tpuprof_span_seconds").summary(
        name="doomed")["count"] == 1
    assert blackbox.box().entries()[-1]["name"] == "doomed"
    assert obs.current_path() == ""


def test_phase_timer_alias_feeds_the_phase_report():
    trace.get_phase_report(reset=True)
    with trace.phase_timer("legacy"):
        pass
    assert "legacy" in trace.get_phase_report(reset=True)


@pytest.mark.parametrize("max_bytes", [400, None])
def test_jsonl_sink_rotation_equals_the_reference(tmp_path, max_bytes):
    for mod, name in ((events, "port"), (ref_events, "ref")):
        sink = mod.JsonlSink(str(tmp_path / f"{name}.jsonl"),
                             max_bytes=max_bytes)
        try:
            for i in range(50):
                sink.write({"kind": "tick", "i": i, "pad": "x" * (i % 7)})
        finally:
            sink.close()
    for suffix in ("", ".1"):
        a, b = tmp_path / f"port.jsonl{suffix}", tmp_path / f"ref.jsonl{suffix}"
        assert a.exists() == b.exists() == (bool(max_bytes)
                                            or suffix == "")
        if a.exists():
            assert a.read_bytes() == b.read_bytes()
            if max_bytes:
                assert os.path.getsize(a) <= max_bytes


def test_emit_snapshot_and_finalize(tmp_path):
    path = str(tmp_path / "m.jsonl")
    obs.configure(jsonl_path=path)          # a sink turns recording on
    assert obs.enabled()
    obs.counter("tpuprof_ingest_rows_total").inc(7)
    obs.finalize(reason="test")
    lines = [json.loads(ln) for ln in open(path)]
    rows = [e for e in lines if e["kind"] == "metric"
            and e["name"] == "tpuprof_ingest_rows_total"]
    assert rows == [{"ts": rows[0]["ts"], "kind": "metric",
                     "reason": "test", "name": "tpuprof_ingest_rows_total",
                     "type": "counter", "labels": "", "value": 7.0}]


def test_rate_ema_equals_the_reference_on_one_clock():
    t = [0.0]
    mine = progress.RateEMA(halflife=1.5, clock=lambda: t[0])
    ref = ref_progress.RateEMA(halflife=1.5, clock=lambda: t[0])
    got = []
    for step, n in enumerate([0, 500, 500, 2000, 0, 0, 10, 10_000]):
        for ema in (mine, ref):
            ema.update(n)
        got.append((mine.rate(), ref.rate()))
        t[0] += 0.25 * (step % 3)
    t[0] += 10.0
    got.append((mine.rate(), ref.rate()))
    assert all(a == b for a, b in got)
    assert got[-1][0] < max(a for a, _ in got) / 50
    for v in (0.0, 999.0, 1500.0, 2.5e6):
        assert progress.fmt_rate(v) == ref_progress.fmt_rate(v)


def test_registry_progress_line_equals_the_reference():
    lines = []
    for mod, prog in ((metrics, progress), (ref_metrics, ref_progress)):
        reg = mod.MetricsRegistry(enabled=True)
        reg.counter("tpuprof_ingest_rows_total").inc(123456)
        reg.counter("tpuprof_ingest_batches_total").inc(7)
        d = reg.counter("tpuprof_device_dispatch_total")
        d.inc(3, program="scan_a")
        d.inc(24, program="scan_a_batches")
        d.inc(2, program="step_b")
        lines.append(prog.registry_progress_line(reg))
        reg.counter("tpuprof_checkpoint_saves_total").inc(2)
        lines.append(prog.registry_progress_line(reg))
    assert lines[:2] == lines[2:]
    assert lines[1] == "123,456 rows · 7 batches · 5 dispatches · " \
        "2 checkpoints"


def test_ticker_prints_progress_and_snapshots(tmp_path):
    import io
    path = str(tmp_path / "m.jsonl")
    obs.configure(jsonl_path=path)
    obs.counter("tpuprof_ingest_rows_total").inc(1000)
    out = io.StringIO()

    def reasons():
        return {json.loads(ln).get("reason") for ln in open(path)
                if ln.endswith("\n")}         # a line being written waits

    with progress.Ticker(0.1, progress=True, snapshots=True, stream=out):
        idle = threading.Event()
        for _ in range(100):            # a tick or two, on a busy host too
            if "rows/s" in out.getvalue() and "interval" in reasons():
                break
            idle.wait(0.1)
    assert out.getvalue().startswith("tpuprof_torch: [")
    assert "1,000 rows" in out.getvalue() and "rows/s" in out.getvalue()
    assert "interval" in reasons()


ENV_VALUES = (None, "", "0", "1", "false", "no", "yes")


@pytest.mark.parametrize("env", ENV_VALUES)
def test_resolve_metrics_enabled_agrees(monkeypatch, env):
    if env is None:
        monkeypatch.delenv("TPUPROF_METRICS", raising=False)
    else:
        monkeypatch.setenv("TPUPROF_METRICS", env)
    for value in (None, True, False):
        for path in (None, "m.jsonl"):
            assert port_config.resolve_metrics_enabled(value, path) == \
                ref_config.resolve_metrics_enabled(value, path)


@pytest.mark.parametrize("env", [None, "", "0", "4096", "-5"])
def test_resolve_metrics_max_bytes_agrees(monkeypatch, env):
    if env is None:
        monkeypatch.delenv("TPUPROF_METRICS_MAX_BYTES", raising=False)
    else:
        monkeypatch.setenv("TPUPROF_METRICS_MAX_BYTES", env)
    for value in (None, 0, 123, -1):
        assert port_config.resolve_metrics_max_bytes(value) == \
            ref_config.resolve_metrics_max_bytes(value)


def test_configure_from_config_and_metrics_path(tmp_path, monkeypatch):
    monkeypatch.delenv("TPUPROF_METRICS", raising=False)
    path = str(tmp_path / "env.jsonl")
    monkeypatch.setenv("TPUPROF_METRICS_PATH", path)
    cfg = tpuprof_torch.ProfilerConfig(metrics_block_sample=3)
    assert obs.resolve_metrics_path(cfg) == path
    obs.configure_from_config(cfg)
    assert not obs.enabled()        # a path from the env alone: off
    assert obs.block_sample() == 3
    assert events.get_sink().path == path
    assert blackbox.box().snapshot()["context"]["config_fingerprint"] \
        == cfg.fingerprint()
    obs.configure_from_config(tpuprof_torch.ProfilerConfig(
        metrics_enabled=True, metrics_max_bytes=1000))
    assert obs.enabled() and events.get_sink().max_bytes == 1000


# ---------------------------------------------------------------------------
# trace_to
# ---------------------------------------------------------------------------

def test_trace_to_noop_without_dir():
    for empty in (None, ""):
        with trace.trace_to(empty):
            assert obs.spans.annotate is None


def test_trace_to_writes_one_chrome_trace_with_the_spans(tmp_path):
    d = tmp_path / "trace"
    with trace.trace_to(str(d), "cpu"):
        with obs.span("profile"):
            torch.ones(64).sum()
    assert obs.spans.annotate is None
    files = list(d.iterdir())
    assert [f.name for f in files] == [f"tpuprof-trace-{os.getpid()}.json"]
    doc = json.loads(files[0].read_text())
    names = {e.get("name") for e in doc["traceEvents"]}
    assert "profile" in names


def test_trace_to_logs_even_when_body_raises(caplog, tmp_path):
    d = str(tmp_path / "trace")
    with caplog.at_level(logging.INFO, logger="tpuprof_torch"):
        with pytest.raises(RuntimeError):
            with trace.trace_to(d, "cpu"):
                raise RuntimeError("mid-trace crash")
    assert any("trace written" in r.message and d in r.message
               for r in caplog.records)
    assert os.path.exists(trace.trace_path(d))


def test_log_event_numpy_fields(caplog):
    with caplog.at_level(logging.DEBUG, logger="tpuprof_torch"):
        trace.log_event("numpy_fields", n=np.int64(7), x=np.float32(1.5))
    msg = [r.message for r in caplog.records if "numpy_fields" in r.message]
    assert json.loads(msg[-1])["n"] in (7, "7")


# ---------------------------------------------------------------------------
# the device-fold telemetry and the memory gauges, on the CPU
# ---------------------------------------------------------------------------

def test_observe_dispatch_counts_and_samples_on_the_cpu():
    cpu = torch.device("cpu")
    with fused.observe_dispatch("scan_a", cpu, batches=4):
        pass
    last = blackbox.box().entries()[-1]
    assert (last["kind"], last["program"], last["batches"]) == \
        ("dispatch", "scan_a", 4)
    assert metrics.counter("tpuprof_device_dispatch_total").total() == 0
    metrics.set_enabled(True)
    obs.configure(block_sample=2)
    for _ in range(4):
        with fused.observe_dispatch("scan_b", cpu, batches=8,
                                    kernel="cumulative"):
            stop = threading.Event()
            stop.wait(0.002)
    d = metrics.counter("tpuprof_device_dispatch_total")
    assert d.value(program="scan_b") == 4
    assert d.value(program="scan_b_batches") == 32
    assert metrics.counter("tpuprof_pass_b_dispatch_total").value(
        kernel="cumulative") == 4
    blk = metrics.histogram("tpuprof_device_block_seconds").summary(
        program="scan_b")
    assert blk["count"] == 2 and blk["sum"] >= 0.004
    assert metrics.histogram("tpuprof_pass_b_dispatch_seconds").summary(
        kernel="cumulative")["count"] == 2
    with pytest.raises(KeyError):       # a raising fold is not timed
        with fused.observe_dispatch("step_a", cpu):
            raise KeyError("fold")


def test_memory_gauges_silent_on_the_cpu():
    metrics.set_enabled(True)
    got = memory.sample(torch.device("cpu"))
    assert got["devices"] == {} and got["host_rss_bytes"] > 0
    snap = metrics.registry().snapshot()
    assert snap["gauges"]["tpuprof_device_memory_bytes"] == {}
    assert snap["gauges"]["tpuprof_host_rss_bytes"][""] > 0


# ---------------------------------------------------------------------------
# the flight recorder
# ---------------------------------------------------------------------------

def test_ring_wraparound_and_zero_capacity():
    box = blackbox.BlackBox(capacity=4)
    ref = ref_blackbox.BlackBox(capacity=4)
    for b in (box, ref):
        for i in range(10):
            b.record("tick", i=i)
    strip = [[{k: v for k, v in e.items() if k != "ts"} for e in b.entries()]
             for b in (box, ref)]
    assert strip[0] == strip[1]
    assert [e["i"] for e in strip[0]] == [6, 7, 8, 9]
    assert box.snapshot()["dropped"] == 6
    off = blackbox.BlackBox(capacity=0)
    off.record("tick")
    off.set_context(a=1)
    assert not off.enabled and off.entries() == [] and off.dump() is None


@pytest.mark.parametrize("env", [None, "0", "64", "nonsense", "-3"])
def test_env_capacity_agrees(monkeypatch, env):
    if env is None:
        monkeypatch.delenv("TPUPROF_BLACKBOX", raising=False)
    else:
        monkeypatch.setenv("TPUPROF_BLACKBOX", env)
    assert blackbox._env_capacity() == ref_blackbox._env_capacity()


def test_events_and_guard_escalation_land_in_the_ring():
    box = blackbox.box()
    before = box.snapshot()["recorded"]
    events.emit("batch_quarantined", site="prep", error="boom")
    assert box.snapshot()["recorded"] == before + 1
    assert box.entries()[-1]["kind"] == "batch_quarantined"
    bg = guard.BatchGuard(retries=0, capture=True)
    poison = bg.run(lambda: (_ for _ in ()).throw(RuntimeError("bad")),
                    site="prep", key=7)
    assert isinstance(poison, guard.PoisonBatch)
    last = [e for e in box.entries() if e["kind"] == "batch_failed"][-1]
    assert last["site"] == "prep" and last["key"] == 7
    assert "bad" in last["error"]


def test_dump_bundle_schema(tmp_path, monkeypatch):
    box = blackbox.BlackBox(capacity=8)
    box.set_context(process_index=0, config_fingerprint="abc123")
    box.record("dispatch", program="scan_a", payload=np.int64(3))
    path = str(tmp_path / "pm.json")
    assert box.dump(path=path, error=ValueError("torn")) == path
    bundle = json.load(open(path))
    assert bundle["schema"] == "tpuprof-postmortem-v1"
    assert bundle["pid"] == os.getpid()
    assert bundle["error"] == {"type": "ValueError", "message": "torn"}
    assert bundle["context"]["config_fingerprint"] == "abc123"
    assert bundle["entries"][-1]["payload"] in (3, "3")
    monkeypatch.setenv("TPUPROF_POSTMORTEM_DIR", str(tmp_path))
    out = box.dump(reason="test")
    assert out == str(tmp_path / f"tpuprof-postmortem-{os.getpid()}.json")
    assert json.load(open(out))["reason"] == "test"


def test_sigusr1_dumps_and_continues(tmp_path, monkeypatch):
    monkeypatch.setenv("TPUPROF_POSTMORTEM_DIR", str(tmp_path))
    prev_usr1 = signal.getsignal(signal.SIGUSR1)
    prev_term = signal.getsignal(signal.SIGTERM)
    try:
        assert blackbox.install_signal_handlers()
        assert blackbox.install_signal_handlers()    # idempotent
        blackbox.record("before_signal", i=1)
        os.kill(os.getpid(), signal.SIGUSR1)
        out = tmp_path / f"tpuprof-postmortem-{os.getpid()}.json"
        bundle = json.load(open(out))
        assert bundle["signal"] == "SIGUSR1"
        assert any(e["kind"] == "before_signal" for e in bundle["entries"])
    finally:
        signal.signal(signal.SIGUSR1, prev_usr1)
        signal.signal(signal.SIGTERM, prev_term)


_TERM_WORKER = r"""
import os, sys, time
sys.path.insert(0, sys.argv[1])
os.environ["TPUPROF_POSTMORTEM_DIR"] = sys.argv[2]
from tpuprof_torch.obs import blackbox
blackbox.record("worker_started")
assert blackbox.install_signal_handlers()
print(sorted(m.split(".")[0] for m in sys.modules
             if m.split(".")[0] in ("jax", "tpuprof")), flush=True)
time.sleep(60)
"""


def test_sigterm_dumps_and_dies_by_signal(tmp_path):
    worker = tmp_path / "term_worker.py"
    worker.write_text(_TERM_WORKER)
    proc = subprocess.Popen(
        [sys.executable, str(worker), str(REPO), str(tmp_path)],
        stdout=subprocess.PIPE, text=True)
    try:
        assert proc.stdout.readline().strip() == "[]"   # no jax, tpuprof
        proc.terminate()
        proc.wait(timeout=30)
    finally:
        proc.kill()
    assert proc.returncode == -signal.SIGTERM
    (pm,) = tmp_path.glob("tpuprof-postmortem-*.json")
    bundle = json.load(open(pm))
    assert bundle["signal"] == "SIGTERM"
    assert any(e["kind"] == "worker_started" for e in bundle["entries"])


# ---------------------------------------------------------------------------
# chip_smoke.py's copies of the test oracles
# ---------------------------------------------------------------------------

def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_event_schema_is_the_reference_contract():
    assert _chip_smoke().EVENT_SCHEMA == EVENT_SCHEMA


def test_chip_smoke_prom_parser_agrees_with_the_oracle():
    from test_obs_smoke import parse_prom
    reg = _drive(metrics)
    wire = fleet.merge_wires([reg.to_wire(), _drive(metrics).to_wire()])
    cs = _chip_smoke()
    for text in (reg.render_text(), wire.render_text()):
        oracle = parse_prom(text)
        mine = cs.parse_prom(text)
        assert {n: e["type"] for n, e in oracle.items()} == \
            {n: e["type"] for n, e in mine.items()}
        assert {n: sorted((s[0], sorted(s[1].items()), s[2])
                          for s in e["samples"]) for n, e in oracle.items()} \
            == {n: sorted((s[0], sorted(s[1].items()), s[2])
                          for s in e["samples"]) for n, e in mine.items()}
    with pytest.raises(AssertionError):
        cs.parse_prom('# TYPE h histogram\nh_bucket{le="1"} 3\n'
                      'h_bucket{le="+Inf"} 2\nh_sum 1\nh_count 2\n')


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("the device half of the telemetry needs a CUDA device")
    return torch.device("cuda:0")


@pytest.mark.cuda
def test_memory_gauges_on_the_card(cuda_device):
    metrics.set_enabled(True)
    keep = torch.empty(1 << 20, device=cuda_device)
    got = memory.sample(cuda_device)["devices"]["cuda:0"]
    assert got["in_use"] >= keep.numel() * 4
    assert got["limit"] == torch.cuda.mem_get_info(0)[1]
    text = metrics.registry().render_text()
    assert 'tpuprof_device_memory_bytes{device="cuda:0",kind="limit"}' \
        in text


@pytest.mark.cuda
def test_sampled_dispatch_time_covers_a_k1_launch(cuda_device):
    rng = np.random.default_rng(1)
    xt = torch.from_numpy(rng.normal(size=(200, 65536)).astype(
        np.float32)).to(cuda_device)
    rv = torch.ones(65536, dtype=torch.bool, device=cuda_device)
    shift = torch.zeros(200, device=cuda_device)
    fused.tiles_cuda(xt, rv, shift)             # warm
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fused.tiles_cuda(xt, rv, shift)
    end.record()
    end.synchronize()
    one = start.elapsed_time(end) / 1e3
    metrics.set_enabled(True)
    obs.configure(block_sample=1)
    with fused.observe_dispatch("step_a", cuda_device):
        fused.tiles_cuda(xt, rv, shift)
    s = metrics.histogram("tpuprof_device_block_seconds").summary(
        program="step_a")
    assert s["count"] == 1 and s["sum"] >= 0.5 * one


@pytest.mark.cuda
def test_trace_to_records_kernel_events(cuda_device, tmp_path):
    rng = np.random.default_rng(2)
    xt = torch.from_numpy(rng.normal(size=(200, 65536)).astype(
        np.float32)).to(cuda_device)
    rv = torch.ones(65536, dtype=torch.bool, device=cuda_device)
    shift = torch.zeros(200, device=cuda_device)
    d = str(tmp_path / "trace")
    with trace.trace_to(d, cuda_device):
        with obs.span("profile"):
            fused.tiles_cuda(xt, rv, shift)
    doc = json.load(open(trace.trace_path(d)))
    kernels = [e["name"] for e in doc["traceEvents"]
               if e.get("cat") == "kernel"]
    assert any("gram_tc" in k for k in kernels)
    assert any("stats_partial" in k for k in kernels)
