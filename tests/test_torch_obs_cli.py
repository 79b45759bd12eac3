"""The port's ``profile`` verb with telemetry on, as a child process.

Mirrors ``tests/test_obs_smoke.py::test_cli_metrics_json_smoke`` and the
CLI cases of ``tests/test_blackbox.py`` on ``python -m tpuprof_torch
profile --device cpu``, with that file's ``EVENT_SCHEMA`` and
``parse_prom`` as the oracles: every JSONL line validates, the pipeline's
spans, the ticker's and the final snapshots, a checkpoint save and the
fleet snapshot are there, ``PATH.prom`` and ``PATH.fleet.prom`` parse and
agree, the footer carries the pipeline line, progress lines reach stderr,
``--trace`` writes a Chrome trace with the ``profile`` range, and the child
imports neither ``jax`` nor ``tpuprof``.  A poisoned run exits 5 and leaves
one postmortem naming the ``prep`` site; ``TPUPROF_BLACKBOX=0`` leaves
none.
"""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from test_obs_smoke import parse_prom, validate_event

REPO = Path(__file__).resolve().parents[1]
N = 20_000


def _child(argv, env_extra=None, timeout=300):
    env = dict(os.environ)
    for var in ("TPUPROF_METRICS", "TPUPROF_METRICS_PATH", "TPUPROF_FAULTS",
                "TPUPROF_BLACKBOX"):
        env.pop(var, None)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    env.update(env_extra or {})
    proc = subprocess.run(
        [sys.executable, "-X", "importtime", "-m", "tpuprof_torch",
         "profile", *argv, "--device", "cpu"],
        cwd=str(REPO), env=env, capture_output=True, text=True,
        timeout=timeout)
    lines = proc.stderr.splitlines()
    mods = {re.split(r"\s*\|\s*", ln)[-1].strip().split(".")[0]
            for ln in lines if ln.startswith("import time:")}
    rest = [ln for ln in lines if not ln.startswith("import time:")]
    return proc.returncode, rest, mods


@pytest.fixture(scope="module")
def source(tmp_path_factory):
    rng = np.random.default_rng(0)
    df = pd.DataFrame({"a": rng.normal(10, 2, N),
                       "b": rng.integers(0, 100, N),
                       "c": rng.choice(["x", "y", "z"], N)})
    path = str(tmp_path_factory.mktemp("src") / "t.parquet")
    pq.write_table(pa.Table.from_pandas(df, preserve_index=False), path,
                   row_group_size=4096)
    return path


@pytest.fixture(scope="module")
def run(source, tmp_path_factory):
    """One telemetry run shared by the checks below."""
    d = tmp_path_factory.mktemp("run")
    out = {"html": str(d / "r.html"), "jsonl": str(d / "m.jsonl"),
           "trace": str(d / "trace"), "ckpt": str(d / "c.ckpt")}
    rc, err, mods = _child(
        [source, "-o", out["html"], "--batch-rows", "1024",
         "--metrics-json", out["jsonl"], "--metrics-interval", "0.1",
         "--progress", "--trace", out["trace"], "--checkpoint",
         out["ckpt"], "--checkpoint-every", "4"])
    assert rc == 0, err[-20:]
    out.update(err=err, mods=mods,
               events=[json.loads(ln) for ln in open(out["jsonl"])])
    return out


def test_child_imports_neither_jax_nor_tpuprof(run):
    assert "tpuprof_torch" in run["mods"]
    assert not run["mods"] & {"jax", "jaxlib", "tpuprof"}


def test_jsonl_validates_and_holds_the_pipeline(run):
    evs = run["events"]
    assert evs
    for ev in evs:
        validate_event(ev)
    kinds = {e["kind"] for e in evs}
    assert {"span", "metric", "checkpoint_save", "fleet_snapshot"} <= kinds
    spans = {e["name"] for e in evs if e["kind"] == "span"}
    assert {"scan_a", "merge", "scan_b", "render", "profile"} <= spans
    reasons = {e["reason"] for e in evs if e["kind"] == "metric"}
    assert {"interval", "collect", "cli"} <= reasons
    rows = [e["value"] for e in evs if e["kind"] == "metric"
            and e["name"] == "tpuprof_ingest_rows_total"]
    assert max(rows) == 2 * N                   # both passes
    (fleet,) = [e for e in evs if e["kind"] == "fleet_snapshot"]
    assert fleet["hosts"] == 1 and fleet["quarantined_by_host"] == [0]


def test_prom_and_fleet_prom(run):
    parsed = parse_prom(open(run["jsonl"] + ".prom").read())
    assert parsed["tpuprof_ingest_rows_total"]["type"] == "counter"
    assert parsed["tpuprof_span_seconds"]["type"] == "histogram"
    assert parsed["tpuprof_span_seconds"]["samples"]
    fleet = parse_prom(open(run["jsonl"] + ".fleet.prom").read())
    rows = [sum(v for _, _, v in p["tpuprof_ingest_rows_total"]["samples"])
            for p in (parsed, fleet)]
    assert rows == [2 * N, 2 * N]
    assert fleet["tpuprof_checkpoint_bytes"]["samples"]
    assert all(lab.get("host") == "0" for _, lab, _ in
               fleet["tpuprof_checkpoint_bytes"]["samples"])


def test_footer_progress_and_summary(run):
    page = open(run["html"]).read()
    assert "pipeline:" in page and "rows ingested" in page
    assert "device dispatches" in page
    assert any(ln.startswith("tpuprof_torch: [") and "rows/s" in ln
               for ln in run["err"])
    assert re.match(r"^tpuprof_torch: [\d,]+ rows x 3 cols -> ",
                    run["err"][-1])
    assert not os.path.exists(run["ckpt"])      # the run completed


def test_trace_holds_the_profile_range(run):
    files = os.listdir(run["trace"])
    assert len(files) == 1 and files[0].endswith(".json")
    doc = json.load(open(os.path.join(run["trace"], files[0])))
    names = {e.get("name") for e in doc["traceEvents"]}
    assert {"profile", "scan_a", "render"} <= names


@pytest.mark.parametrize("blackbox", ["", "0"])
def test_poisoned_run_leaves_one_postmortem(source, tmp_path, blackbox):
    env = {"TPUPROF_POSTMORTEM_DIR": str(tmp_path),
           # two failing batches against a budget of one: the second
           # admit raises PoisonBatchError (exit 5)
           "TPUPROF_FAULTS": "prep:2@1"}
    if blackbox:
        env["TPUPROF_BLACKBOX"] = blackbox
    rc, err, _ = _child([source, "-o", str(tmp_path / "r.html"),
                         "--batch-rows", "1024", "--ingest-retries", "0",
                         "--max-quarantined", "1"], env)
    assert rc == 5, err[-10:]
    assert any(ln.startswith("tpuprof_torch: error:") for ln in err)
    pm = list(tmp_path.glob("tpuprof-postmortem-*.json"))
    if blackbox == "0":
        assert pm == []
        return
    assert len(pm) == 1
    assert any(ln == f"tpuprof_torch: postmortem: {pm[0]}" for ln in err)
    bundle = json.load(open(pm[0]))
    assert bundle["error"]["type"] == "PoisonBatchError"
    sites = [e.get("site") for e in bundle["entries"]
             if e["kind"] in ("batch_failed", "batch_quarantined")]
    assert "prep" in sites
    assert bundle["context"].get("config_fingerprint")
