"""The port's command line: ``python -m tpuprof_torch profile`` and
``diff``.

``tpuprof_torch.cli.main`` in process with ``--device cpu`` (the kernels'
plain versions): the report, ``--stats-json`` and ``--artifact`` it writes,
its flags against the reference parser's, its error exits; ``diff`` on two
port artifacts against the reference's ``compute_drift`` on the same files
and its exit codes; and one real ``python -m tpuprof_torch profile`` child
that loads neither ``jax`` nor any ``tpuprof`` module."""

import json
import os
import re
import subprocess
import sys

import jax  # noqa: F401  (JAX stays on the CPU: tests/conftest.py)
import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

import tpuprof
import tpuprof_torch
from tpuprof import cli as ref_cli
from tpuprof.artifact import compute_drift as ref_compute_drift
from tpuprof.artifact import drift_to_html as ref_drift_to_html
from tpuprof.artifact import read_artifact as ref_read_artifact
from tpuprof.errors import CorruptArtifactError as RefCorruptArtifactError
from tpuprof.errors import exit_code as ref_exit_code
from tpuprof_torch import cli
from tpuprof_torch.artifact import read_artifact
from tpuprof_torch.report import render
from tpuprof_torch.report.export import stats_to_json
from torch_route import same_hash_route  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH = "512"
SUCCESS = re.compile(r"^tpuprof_torch: ([\d,]+) rows x (\d+) cols -> (.+) "
                     r"in [\d.]+s \(([\d,]+|nan) rows/s\)$")


def _frame(n=3000, seed=11):
    rng = np.random.default_rng(seed)
    fare = rng.gamma(2.0, 7.5, n)
    df = pd.DataFrame({
        "fare_amount": fare,
        "tip_amount": fare * 0.2 + rng.normal(0, 0.5, n),
        "trip_distance": rng.exponential(2.5, n),
        "passenger_count": rng.integers(1, 7, n).astype(np.int64),
        "vendor_id": rng.choice(["CMT", "VTS", "DDS"], n,
                                p=[0.5, 0.4, 0.1]),
        "pickup_datetime": pd.Timestamp("2019-01-01") + pd.to_timedelta(
            rng.integers(0, 31 * 24 * 3600, n), unit="s"),
        "store_and_fwd": rng.random(n) < 0.3,
        "const_col": 1.0,
        "record_id": [f"id_{i:06d}" for i in range(n)],
    })
    df.loc[rng.choice(n, 200, replace=False), "fare_amount"] = np.nan
    df.loc[rng.choice(n, 100, replace=False), "vendor_id"] = None
    return df


def drifted(df, seed=12):
    """``fare_amount`` shifted by one standard deviation, and the share of
    one-passenger trips raised from about 1/6 to 1/2 (``passenger_count``
    codes a category as an integer; the drift engine reads a string
    column only through its top-k set, distinct count and missing share,
    so a share change there does not reach drift)."""
    out = df.copy()
    out["fare_amount"] = out["fare_amount"] + out["fare_amount"].std()
    rng = np.random.default_rng(seed)
    out.loc[rng.random(len(out)) < 0.4, "passenger_count"] = 1
    return out


def _write(df, path, row_group_size=700):
    pq.write_table(pa.Table.from_pandas(df, preserve_index=False), path,
                   row_group_size=row_group_size)
    return str(path)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    df = _frame()
    return {"root": root, "base": _write(df, root / "base.parquet"),
            "drift": _write(drifted(df), root / "drift.parquet")}


def _profile(capsys, *argv):
    """(exit code, stderr lines) of ``profile`` in process."""
    rc = cli.main(["profile", *argv])
    return rc, capsys.readouterr().err.strip().splitlines()


@pytest.fixture(scope="module")
def artifacts(data):
    """Port artifacts of the base and drifted files."""
    out = {}
    for name in ("base", "drift"):
        out[name] = str(data["root"] / f"{name}.artifact.json")
        assert cli.main(["profile", data[name], "-o",
                         str(data["root"] / f"{name}.html"), "--device",
                         "cpu", "--batch-rows", BATCH, "--artifact",
                         out[name]]) == 0
    return out


def test_profile_writes_report_stats_json_and_artifact(data, tmp_path,
                                                       capsys, monkeypatch):
    seen = {}
    real = render.to_standalone_html

    def capture(stats, config, **kw):
        seen["stats"], seen["config"] = stats, config
        return real(stats, config, **kw)

    monkeypatch.setattr(render, "to_standalone_html", capture)
    html, js, art = (str(tmp_path / f) for f in ("r.html", "s.json",
                                                 "a.json"))
    rc, err = _profile(capsys, data["base"], "-o", html, "--device", "cpu",
                       "--batch-rows", BATCH, "--stats-json", js,
                       "--artifact", art)
    assert rc == 0 and len(err) == 1
    m = SUCCESS.match(err[0])
    assert m and m.group(1) == "3,000" and m.group(2) == "9" \
        and m.group(3) == html
    stats = seen["stats"]
    with open(html, encoding="utf-8") as fh:
        assert fh.read() == real(stats, seen["config"])
    assert stats["_phases"]["scan_a"] > 0 and "scan_b" in stats["_phases"]
    with open(js) as fh:
        doc = json.load(fh)
    assert doc == json.loads(json.dumps(stats_to_json(stats)))
    again = tpuprof_torch.ProfileReport(data["base"], device="cpu",
                                        batch_rows=int(BATCH))
    assert doc == json.loads(json.dumps(again.to_json_dict()))
    for reader in (read_artifact, ref_read_artifact):
        a = reader(art)
        assert a.stats == doc and a.meta["source"] == data["base"]
        assert a.meta["tpuprof_version"] == tpuprof_torch.__version__
        assert set(a.sketches["bin_seeds"]) == {
            "fare_amount", "tip_amount", "trip_distance", "passenger_count",
            "store_and_fwd", "const_col"}


@pytest.mark.parametrize("flags,fields,check", [
    (["--bins", "7"], {"bins": 7}, lambda d, a: all(
        len(h["counts"]) == 7 for h in a.sketches["histograms"].values())),
    (["--corr-reject", "0.999"], {"corr_reject": 0.999},
     lambda d, a: d["variables"]["tip_amount"]["type"] == "NUM"),
    (["--columns", "record_id,fare_amount"],
     {"columns": ("record_id", "fare_amount")},
     lambda d, a: list(d["variables"]) == ["record_id", "fare_amount"]),
    (["--spearman"], {"spearman": True},
     lambda d, a: "spearman" in d["correlations"]),
    (["--single-pass", "--sketch-size", "64"],
     {"exact_passes": False, "quantile_sketch_size": 64},
     lambda d, a: d["variables"]["fare_amount"]["mode_approx"]),
    (["--hll-precision", "6", "--scan-batches", "2", "--prepare-workers",
      "2", "--pass-b-kernel", "legacy", "--profile-passes", "fused"],
     {"hll_precision": 6, "scan_batches": 2, "prepare_workers": 2,
      "pass_b_kernel": "legacy", "profile_passes": "fused"},
     lambda d, a: d["variables"]["trip_distance"]["distinct_approx"]),
    (["--prep-workers", "3", "--nested", "opaque", "--ingest-retries", "0",
      "--retry-backoff", "0", "--max-quarantined", "2", "--quarantine-log",
      "never-written.jsonl", "--drain-timeout", "60"],
     {"prep_workers": 3, "nested": "opaque", "ingest_retries": 0,
      "retry_backoff_s": 0.0, "max_quarantined": 2,
      "quarantine_log": "never-written.jsonl", "drain_timeout_s": 60.0},
     lambda d, a: "quarantine" not in d
     and not os.path.exists("never-written.jsonl")),
])
def test_profile_flags_reach_the_profile(data, tmp_path, capsys, flags,
                                         fields, check):
    """Each flag lands in its config field (the artifact's config
    fingerprint covers every field) and shows in the result."""
    js, art = str(tmp_path / "s.json"), str(tmp_path / "a.json")
    rc, _ = _profile(capsys, data["base"], "-o", str(tmp_path / "r.html"),
                     "--device", "cpu", "--batch-rows", BATCH,
                     "--stats-json", js, "--artifact", art, *flags)
    assert rc == 0
    a = read_artifact(art)
    expected = tpuprof_torch.ProfilerConfig(
        batch_rows=int(BATCH), artifact_path=art, **fields)
    assert a.meta["config"]["fingerprint"] == expected.fingerprint()
    with open(js) as fh:
        assert check(json.load(fh), a)


def test_fused_seeded_profile_equals_two_pass(data, artifacts, tmp_path,
                                              capsys):
    docs = []
    for extra in ([], ["--profile-passes", "fused", "--seed-edges",
                       artifacts["base"]]):
        js = str(tmp_path / f"s{len(docs)}.json")
        rc, _ = _profile(capsys, data["base"], "-o",
                         str(tmp_path / "r.html"), "--device", "cpu",
                         "--batch-rows", BATCH, "--stats-json", js, *extra)
        assert rc == 0
        with open(js) as fh:
            docs.append(json.load(fh))
    assert docs[0] == docs[1]


def _verb_actions(parser, verb):
    sub = next(a for a in parser._actions
               if isinstance(a, type(parser._subparsers._group_actions[0])))
    return {a.dest: a for a in sub.choices[verb]._actions
            if a.dest != "help"}


@pytest.mark.parametrize("verb", ["profile", "diff", "serve", "watch",
                                  "submit", "history", "backtest", "lint"])
def test_flags_mirror_the_reference(verb):
    """Every flag of the reference is the port's, with its name, default,
    choices and type; ``--device`` stands beside ``--backend`` in the verbs
    that run a profile."""
    ref = _verb_actions(ref_cli.build_parser(), verb)
    mine = _verb_actions(cli.build_parser(), verb)
    for dest, act in mine.items():
        if dest == "device":
            continue
        r = ref[dest]
        assert (act.option_strings, act.default, act.choices, act.type,
                act.nargs, act.const) == \
            (r.option_strings, r.default, r.choices, r.type, r.nargs,
             r.const), dest
    if verb in ("profile", "serve", "watch"):
        assert set(mine) == set(ref) | {"device"}
    else:
        assert set(mine) == set(ref)


@pytest.mark.parametrize("case", ["unknown_column", "missing_path",
                                  "bad_config", "bad_guard_config",
                                  "bad_device"])
def test_input_errors_exit_2(data, tmp_path, capsys, case):
    html = str(tmp_path / "r.html")
    argv = [data["base"], "-o", html, "--device", "cpu"]
    if case == "unknown_column":
        argv += ["--columns", "fare_amount,nope"]
    elif case == "missing_path":
        argv[0] = str(tmp_path / "absent.parquet")
    elif case == "bad_config":
        argv += ["--bins", "0"]
    elif case == "bad_guard_config":
        argv += ["--max-quarantined", "-1"]
    else:
        argv[4] = "warp9"
    rc, err = _profile(capsys, *argv)
    assert rc == 2 and len(err) == 1
    assert err[0].startswith("tpuprof_torch: error: ")
    assert not os.path.exists(html)


def _stats_json(main, argv, tmp_path, tag):
    sj = str(tmp_path / f"{tag}.json")
    assert main(["profile", *argv, "-o", str(tmp_path / f"{tag}.html"),
                 "--batch-rows", BATCH, "--stats-json", sj]) == 0
    with open(sj) as fh:
        return json.load(fh)


def test_nested_flag_changes_the_output_as_the_reference(tmp_path, capsys):
    rng = np.random.default_rng(3)
    n = 1500
    table = pa.table({
        "x": rng.normal(size=n),
        "tags": pa.array([None if i % 6 == 0 else [int(i % 5)] * (i % 3)
                          for i in range(n)], type=pa.list_(pa.int64()))})
    path = str(tmp_path / "nested.parquet")
    pq.write_table(table, path)
    for policy in ("stringify", "opaque"):
        mine = _stats_json(cli.main, [path, "--device", "cpu", "--nested",
                                      policy], tmp_path, f"p-{policy}")
        ref = _stats_json(ref_cli.main, [path, "--backend", "tpu",
                                         "--nested", policy,
                                         "--no-compile-cache"],
                          tmp_path, f"r-{policy}")
        capsys.readouterr()
        for fld in ("type", "count", "n_missing", "distinct_count",
                    "memorysize"):
            assert mine["variables"]["tags"][fld] == \
                ref["variables"]["tags"][fld], (policy, fld)
        assert mine["freq"].get("tags") == ref["freq"].get("tags")
        assert (mine["variables"]["tags"]["distinct_count"] is None) == \
            (policy == "opaque")


def test_max_quarantined_flag_changes_the_output_as_the_reference(
        data, tmp_path, capsys, monkeypatch):
    from tpuprof.testing import faults as ref_faults
    from tpuprof_torch.testing import faults
    monkeypatch.setattr(faults, "_plan", None)
    monkeypatch.setattr(ref_faults, "_plan", None)
    docs = {}
    for name, main, extra, mod in (
            ("port", cli.main, ["--device", "cpu"], faults),
            ("ref", ref_cli.main, ["--backend", "tpu", "--no-compile-cache"],
             ref_faults)):
        mod.configure("prep:fatal@2")
        with pytest.raises(RuntimeError, match="injected fatal"):
            main(["profile", data["base"], "-o", str(tmp_path / "x.html"),
                  "--batch-rows", BATCH, "--prepare-workers", "1", *extra])
        mod.configure("prep:fatal@2")
        docs[name] = _stats_json(
            main, [data["base"], "--max-quarantined", "1",
                   "--prepare-workers", "1", *extra], tmp_path, name)
        mod.reset()
    capsys.readouterr()
    mine, ref = docs["port"], docs["ref"]
    # the second batch of the first 700-row group: its last 188 rows
    assert [(e["site"], e["cursor"], e["rows"]) for e in mine["quarantine"]] \
        == [(e["site"], e["cursor"], e["rows"]) for e in ref["quarantine"]] \
        == [("prep", 2, 700 - int(BATCH))]
    assert mine["table"]["n"] == ref["table"]["n"] == 3000 - 188
    html = (tmp_path / "port.html").read_text(encoding="utf-8")
    assert "Degraded run" in html


@pytest.mark.parametrize("keep", ["1", "3"])
def test_checkpoint_flags_resume_a_crashed_profile(data, tmp_path, capsys,
                                                   keep):
    """``--checkpoint``, ``--checkpoint-every`` and ``--checkpoint-keep``:
    a profile killed by a ``fold`` fault leaves its checkpoint (and with
    ``--checkpoint-keep 3`` its rotation), the rerun resumes, removes
    them, and its ``--stats-json`` equals an uninterrupted profile's."""
    from tpuprof_torch.testing import faults
    ck = str(tmp_path / "scan.ckpt")
    flags = ["--checkpoint", ck, "--checkpoint-every", "2",
             "--checkpoint-keep", keep]
    base = [data["base"], "--device", "cpu"]
    control = _stats_json(cli.main, base, tmp_path, "control")
    faults.configure("fold:1@5")
    try:
        with pytest.raises(Exception, match="injected"):
            cli.main(["profile", *base, *flags, "-o",
                      str(tmp_path / "x.html"), "--batch-rows", BATCH])
    finally:
        faults.reset()
    assert os.path.exists(ck)
    assert os.path.exists(ck + ".1") == (keep == "3")
    resumed = _stats_json(cli.main, [*base, *flags], tmp_path, "resumed")
    capsys.readouterr()
    assert resumed == control
    assert not any(n.startswith("scan.ckpt") for n in os.listdir(tmp_path))


def test_unreadable_checkpoint_exits_3(data, tmp_path, capsys):
    ck = tmp_path / "scan.ckpt"
    ck.write_bytes(b"junk")
    html = str(tmp_path / "r.html")
    rc, err = _profile(capsys, data["base"], "-o", html, "--device", "cpu",
                       "--checkpoint", str(ck))
    assert rc == 3 == ref_exit_code(
        __import__("tpuprof.errors").errors.CorruptCheckpointError("x"))
    # the error line, then where the flight recorder's bundle went
    assert len(err) == 2 and "checkpoint" in err[0]
    assert err[1].startswith("tpuprof_torch: postmortem: ")
    assert os.path.exists(err[1].split(": ", 2)[2])
    assert not os.path.exists(html)


def test_without_cuda_profile_fails_and_reads_nothing(data, tmp_path,
                                                      capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    html = str(tmp_path / "r.html")
    rc, err = _profile(capsys, data["base"], "-o", html)
    assert rc == 2 and len(err) == 1
    assert err[0].startswith("tpuprof_torch: error: no CUDA device")
    assert not os.path.exists(html)


def test_diff_equals_reference_compute_drift(artifacts, tmp_path, capsys,
                                             monkeypatch):
    out, js = str(tmp_path / "d.html"), str(tmp_path / "d.json")
    rc = cli.main(["diff", artifacts["base"], artifacts["drift"], "-o", out,
                   "--json", js])
    err = capsys.readouterr().err.strip().splitlines()
    assert rc == 0 and len(err) == 1
    assert err[0].startswith(f"tpuprof_torch: diff {artifacts['base']} -> "
                             f"{artifacts['drift']}: DRIFT — 2 drifting")
    with open(js) as fh:
        drift = json.load(fh)
    ref = ref_compute_drift(ref_read_artifact(artifacts["base"]),
                            ref_read_artifact(artifacts["drift"]))
    assert drift == json.loads(json.dumps(ref))
    status = {c: e["status"] for c, e in drift["columns"].items()}
    assert {c for c, s in status.items() if s == "drift"} == \
        {"fare_amount", "passenger_count"}
    assert {c for c, s in status.items() if s != "drift"} == \
        {c for c in status if c not in ("fare_amount", "passenger_count")}
    assert all(s == "ok" for c, s in status.items()
               if c not in ("fare_amount", "passenger_count"))
    monkeypatch.setattr(tpuprof, "__version__", tpuprof_torch.__version__)
    with open(out, encoding="utf-8") as fh:
        assert fh.read() == ref_drift_to_html(ref)


@pytest.mark.parametrize("case,expected", [
    ("same", 0), ("drift", 0), ("drift_fail", 1), ("same_fail", 0),
    ("missing", 2), ("torn", 6), ("thresholds", 0)])
def test_diff_exit_codes(artifacts, tmp_path, capsys, case, expected):
    a, b = artifacts["base"], artifacts["drift"]
    extra = []
    if case.startswith("same"):
        b = a
    if case.endswith("fail"):
        extra = ["--fail-on-drift"]
    if case == "missing":
        b = str(tmp_path / "absent.json")
    if case == "torn":
        with open(artifacts["drift"], "rb") as fh:
            blob = fh.read()
        b = str(tmp_path / "torn.json")
        with open(b, "wb") as fh:
            fh.write(blob[: len(blob) // 2])
        assert ref_exit_code(RefCorruptArtifactError("x")) == expected
    if case == "thresholds":
        # thresholds no column reaches: verdict ok under --fail-on-drift
        extra = ["--psi-threshold", "1e9", "--ks-threshold", "2",
                 "--fail-on-drift"]
    rc = cli.main(["diff", a, b, "-o", str(tmp_path / "d.html"), *extra])
    err = capsys.readouterr().err.strip().splitlines()
    assert rc == expected and len(err) == 1
    if case in ("missing", "torn"):
        assert err[0].startswith("tpuprof_torch: error: ")


def test_python_m_profile_loads_no_jax_and_no_reference(data, tmp_path):
    """A real ``python -m tpuprof_torch profile`` child: exit 0, the
    success line, and ``-X importtime`` lists every module it imported:
    neither ``jax`` nor any ``tpuprof`` module is among them."""
    html = str(tmp_path / "r.html")
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run(
        [sys.executable, "-X", "importtime", "-m", "tpuprof_torch",
         "profile", data["base"], "-o", html, "--device", "cpu",
         "--batch-rows", BATCH, "--artifact", str(tmp_path / "a.json")],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stderr.splitlines()
    mods = {ln.rsplit("|", 1)[1].strip() for ln in lines
            if ln.startswith("import time:") and "|" in ln}
    assert "tpuprof_torch.cli" in mods and "torch" in mods
    top = {m.split(".")[0] for m in mods}
    assert not top & {"jax", "jaxlib", "tpuprof"}, sorted(top)
    rest = [ln for ln in lines if not ln.startswith("import time:")]
    assert len(rest) == 1 and SUCCESS.match(rest[0]), rest
    assert os.path.getsize(html) > 0
