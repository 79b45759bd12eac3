"""The port's ingest guard: retry, poison-batch quarantine, watchdogs.

Mirrors ``TestQuarantine``, ``TestCollectQuarantine`` and ``TestWatchdogs``
of ``tests/test_faults.py`` for what the port runs (``describe``, one
process, no checkpoint): seeded ``prep`` faults are quarantined exactly as
injected, and the same plan and seed skip the same cursors in both
packages with the same stats; transients are absorbed by the retry; the
default fails fast; a spent budget raises ``PoisonBatchError`` with its
manifest; a ``fold`` fault is skipped without a retry; a skipped batch
counts in neither pass; ``watched`` passes values and errors through and
times out, and so does the device drain; a degraded report and export carry
the manifest, byte for byte the reference's, and a clean one has none.  The
reference's checkpoint, stream and fleet cases come with those slices.
"""

import json

import jax  # noqa: F401  (JAX stays on the CPU: tests/conftest.py)
import numpy as np
import pandas as pd
import pytest

import tpuprof
import tpuprof_torch
from tpuprof import ProfilerConfig as RefConfig
from tpuprof.backends.tpu import TPUStatsBackend
from tpuprof.report import export as ref_export
from tpuprof.report import render as ref_render
from tpuprof.testing import faults as ref_faults
from tpuprof_torch.errors import (PoisonBatchError, TransientError,
                                  WatchdogTimeout)
from tpuprof_torch.report.export import stats_to_json
from tpuprof_torch.report.render import to_html, to_standalone_html
from tpuprof_torch.runtime import guard
from tpuprof_torch.testing import faults
from torch_route import same_hash_route  # noqa: F401  (autouse)

BATCH = 256


@pytest.fixture(autouse=True)
def _no_plan_leaks():
    faults.reset()
    ref_faults.reset()
    yield
    faults.reset()
    ref_faults.reset()


def _frame(n_batches=40, seed=0):
    rng = np.random.default_rng(seed)
    n = n_batches * BATCH
    return pd.DataFrame({"a": rng.normal(5.0, 2.0, n),
                         "b": rng.integers(0, 9, n).astype(np.int64),
                         "c": rng.choice(["x", "y", "z"], n)})


def _port(df, **kw):
    kw.setdefault("batch_rows", BATCH)
    return tpuprof_torch.describe(df, device="cpu", **kw)


def test_seeded_prep_faults_quarantine_exactly():
    """p=0.08 seeded transient prepare faults, quarantine on, retries off:
    the profile completes, and the manifest and the degraded banner count
    exactly the injected faults."""
    faults.configure("prep:0.08", seed=123)
    df = _frame()
    stats = _port(df, max_quarantined=100, ingest_retries=0,
                  exact_passes=False)
    injected = faults.injected("prep")
    assert injected > 0                      # the seed fires
    manifest = stats["_quarantine"]
    assert len(manifest) == injected
    assert all(e["site"] == "prep" and e["rows"] == BATCH
               for e in manifest)
    assert stats["table"]["n"] == (40 - injected) * BATCH
    html = to_standalone_html(stats, tpuprof_torch.ProfilerConfig())
    assert "Degraded run" in html and "quarantine-manifest" in html
    assert f"{len(manifest)} batch(es)" in html


@pytest.mark.parametrize("workers", [1, 4])
def test_same_plan_and_seed_skip_the_same_cursors_as_the_reference(workers):
    """The keyed draw makes the injected set a function of the seed: the
    port and the reference skip the same batches, at any worker count, and
    report the same counts, quantiles and top-k (the reference's own test
    runs one pass, so the quarantined batches are not read again)."""
    df = _frame()
    spec = "prep:0.08"
    faults.configure(spec, seed=7)
    port = _port(df, max_quarantined=100, ingest_retries=0,
                 exact_passes=False, prepare_workers=workers)
    ref_faults.configure(spec, seed=7)
    ref = TPUStatsBackend().collect(df, RefConfig(
        backend="tpu", batch_rows=BATCH, max_quarantined=100,
        ingest_retries=0, exact_passes=False, prepare_workers=workers))
    cursors = [e["cursor"] for e in port["_quarantine"]]
    assert cursors and cursors == [e["cursor"] for e in ref["_quarantine"]]
    assert [e["error"] for e in port["_quarantine"]] == \
        [e["error"] for e in ref["_quarantine"]]
    assert port["table"]["n"] == ref["table"]["n"]
    for name, rv in ref["variables"].items():
        pv = port["variables"][name]
        for fld in ("type", "count", "n_missing", "distinct_count", "min",
                    "max", "p5", "p50", "p95"):
            if fld in rv:
                assert pv[fld] == rv[fld], (name, fld)
        if "mean" in rv:
            assert pv["mean"] == pytest.approx(rv["mean"], rel=1e-4)
    for name, rf in ref["freq"].items():
        pd.testing.assert_series_equal(port["freq"][name].sort_index(),
                                       rf.sort_index(), check_names=False)


def test_skipped_batch_counts_in_neither_pass():
    """Two passes: pass B reads around the batches pass A quarantined, so
    the exact histograms count the rows the profile counts — those of the
    table without the skipped batches."""
    df = _frame(12)
    faults.configure("prep:fatal@4")         # a RuntimeError: no retry
    got = _port(df, max_quarantined=1, prepare_workers=1)
    (entry,) = got["_quarantine"]
    assert entry["site"] == "prep" and entry["cursor"] == 4
    assert "RuntimeError" in entry["error"]
    faults.reset()
    kept = pd.concat([df.iloc[:3 * BATCH], df.iloc[4 * BATCH:]],
                     ignore_index=True)
    clean = _port(kept)
    assert got["table"]["n"] == clean["table"]["n"] == 11 * BATCH
    for name, cv in clean["variables"].items():
        gv = got["variables"][name]
        for fld in ("type", "count", "n_missing", "distinct_count"):
            assert gv[fld] == cv[fld], (name, fld)
        if cv["type"] == "NUM":
            assert (gv["min"], gv["max"]) == (cv["min"], cv["max"])
            np.testing.assert_array_equal(gv["histogram"][0],
                                          cv["histogram"][0])
            assert gv["histogram"][0].sum() == gv["count"]
    pd.testing.assert_series_equal(got["freq"]["c"], clean["freq"]["c"])


def test_fused_profile_skips_the_same_batches():
    df = _frame(12)
    faults.configure("prep:fatal@4")
    two = _port(df, max_quarantined=1, prepare_workers=1)
    faults.configure("prep:fatal@4")
    fused = _port(df, max_quarantined=1, prepare_workers=1,
                  profile_passes="fused")
    assert stats_to_json(fused) == stats_to_json(two)
    assert fused["_quarantine"] == two["_quarantine"]


def test_retry_recovers_every_transient_first_attempt():
    """'prep:transient' fails every batch's first attempt; one retry
    absorbs all of it: nothing quarantined, the clean run's result."""
    df = _frame(20)
    clean = _port(df)
    faults.configure("prep:transient")
    stats = _port(df, ingest_retries=1, retry_backoff_s=0.0)
    assert "_quarantine" not in stats
    assert faults.injected("prep") == 20
    assert stats_to_json(stats) == stats_to_json(clean)


def test_retry_backoff_doubles():
    slept = []
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 4:
            raise OSError("flaky read")
        return "ok"

    g = guard.BatchGuard(retries=3, backoff_s=0.5, sleep=slept.append)
    assert g.run(flaky, site="prep", key=0) == "ok"
    assert slept == [0.5, 1.0, 2.0]
    with pytest.raises(ValueError):          # not transient: no retry
        guard.BatchGuard(retries=3, sleep=slept.append).run(
            lambda: int("x"), site="prep")
    assert len(slept) == 3


def test_default_config_fails_fast():
    faults.configure("prep:transient")
    with pytest.raises(TransientError, match="injected transient"):
        _port(_frame(4), ingest_retries=0)


def test_budget_exhaustion_raises_poison_with_manifest(tmp_path):
    log = tmp_path / "q.jsonl"
    faults.configure("prep:transient")
    with pytest.raises(PoisonBatchError, match="max_quarantined=2") as ei:
        _port(_frame(10), max_quarantined=2, ingest_retries=0,
              retry_backoff_s=0.0, prepare_workers=1,
              quarantine_log=str(log))
    assert len(ei.value.manifest) == 3      # the one over budget
    lines = [json.loads(ln) for ln in log.read_text().splitlines()]
    assert lines == ei.value.manifest
    assert [e["cursor"] for e in lines] == [1, 2, 3]


def test_fold_fault_quarantined_without_retry():
    """A raising fold is skipped (never retried: it is not idempotent) and
    lands in the manifest under its own site."""
    faults.configure("fold:1@3")
    stats = _port(_frame(8), max_quarantined=5)
    (entry,) = stats["_quarantine"]
    assert entry["site"] == "fold" and entry["cursor"] == 3
    assert faults.injected("fold") == 1
    assert stats["table"]["n"] == 7 * BATCH
    assert stats["variables"]["a"]["histogram"][0].sum() == \
        stats["variables"]["a"]["count"]


def test_fold_fault_without_budget_raises():
    faults.configure("fold:1@2")
    with pytest.raises(TransientError):
        _port(_frame(4))


def test_watched_passthrough_and_timeout():
    import time
    assert guard.watched(lambda: 42, None, site="x") == 42
    assert guard.watched(lambda: 42, 5.0, site="x") == 42
    with pytest.raises(WatchdogTimeout) as ei:
        guard.watched(lambda: time.sleep(2.0), 0.1, site="slow",
                      heartbeat=lambda: {"alive": 1})
    assert ei.value.site == "slow" and ei.value.heartbeat == {"alive": 1}


def test_watched_propagates_body_errors():
    def boom():
        raise KeyError("inner")
    with pytest.raises(KeyError, match="inner"):
        guard.watched(boom, 5.0, site="x")


def test_deadline():
    import time
    guard.Deadline(None, site="x").check()
    d = guard.Deadline(0.05, site="loop", heartbeat=lambda: {"i": 3})
    d.check()
    time.sleep(0.1)
    with pytest.raises(WatchdogTimeout) as ei:
        d.check()
    assert ei.value.site == "loop" and ei.value.heartbeat == {"i": 3}


def test_drain_watchdog_fires_with_heartbeat():
    faults.configure("device_wait:sleep=2")
    with pytest.raises(WatchdogTimeout) as ei:
        _port(_frame(2), drain_timeout_s=0.15)
    assert ei.value.site == "device_wait"
    assert ei.value.heartbeat["rows"] == 2 * BATCH


def test_drain_watchdog_passes_a_timely_drain():
    df = _frame(4)
    faults.configure("device_wait:sleep=0.05")
    stats = _port(df, drain_timeout_s=30.0)
    faults.reset()
    assert stats_to_json(stats) == stats_to_json(_port(df))


def test_degraded_report_and_export_match_the_reference(monkeypatch):
    """The banner and the export's manifest, byte for byte the reference's
    renderer and exporter on the same stats; a clean run has neither."""
    monkeypatch.setattr(tpuprof, "__version__", tpuprof_torch.__version__)
    df = _frame(10)
    clean = _port(df)
    faults.configure("prep:2@3")
    stats = _port(df, max_quarantined=5, ingest_retries=0,
                  prepare_workers=1)
    assert len(stats["_quarantine"]) == 2
    cfg = tpuprof_torch.ProfilerConfig()
    ref_cfg = RefConfig()
    html = to_html(stats, cfg)
    assert "Degraded run" in html
    assert html == ref_render.to_html(stats, ref_cfg)
    doc = stats_to_json(stats)
    assert doc["quarantine"] == ref_export.stats_to_json(stats)["quarantine"]
    assert [e["cursor"] for e in doc["quarantine"]] == [3, 4]
    assert "Degraded run" not in to_html(clean, cfg)
    assert to_html(clean, cfg) == ref_render.to_html(clean, ref_cfg)
    assert "quarantine" not in stats_to_json(clean)


def test_spec_parse_rejects_malformed_and_later_modes():
    for bad in ("prep", "prep:2.0", "prep:0@1", "fold:truncate@0",
                "host_death:@0"):
        with pytest.raises(ValueError):
            faults.FaultPlan.from_spec(bad)


def test_keyed_draw_is_the_reference_draw():
    """The same (seed, site, key, attempt) fires in both packages."""
    mine = faults.FaultPlan.from_spec("prep:0.3", seed=11)
    ref = ref_faults.FaultPlan.from_spec("prep:0.3", seed=11)
    for plan in (mine, ref):
        fired = []
        for key in range(60):
            for _attempt in range(2):
                try:
                    plan.fire("prep", key=key)
                except OSError:
                    fired.append(key)
        plan.fired = fired
    assert mine.fired == ref.fired and mine.fired
