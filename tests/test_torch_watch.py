"""The port's drift watch (``tpuprof_torch/serve/watch.py``) against the
reference's (``tpuprof/serve/watch.py``).

One source sequence — stable, stable, drifted, drifted again in the same
shape, a schema change, a hung profile under ``job_timeout_s``, a poisoned
file, recovered — runs through both packages' ``DriftWatcher`` (the port's
scheduler on the CPU, the reference's on JAX's CPU backend), one cycle at
a time.  The alerts (kind, severity, columns, counts, exit codes), the
sealed manifests and the retained chain must be the same, and the drift
between the two cycles around the jump agrees per column at PSI/KS
``atol=5e-4``.  Then: manifests cross-read, a torn manifest is
``CorruptManifestError`` and the watch rebuilds from the chain, the
``watch_cycle`` fault site, ``source_key``, a fused watch whose second
undrifted cycle hits every lane and re-bins nothing, and the ``watch``
verb with ``--cycles``.  Every wait is bounded.
"""

import json
import os
import time

import jax  # noqa: F401  (JAX stays on the CPU: tests/conftest.py)
import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from tpuprof.artifact import compute_drift as ref_compute_drift
from tpuprof.artifact import read_artifact as ref_read_artifact
from tpuprof.errors import CorruptManifestError as RefCorruptManifest
from tpuprof.serve import DriftWatcher as RefWatcher
from tpuprof.serve import ProfileScheduler as RefScheduler
from tpuprof.serve import watch as ref_watch
from tpuprof.testing import faults as ref_faults
from tpuprof_torch import cli
from tpuprof_torch.artifact import compute_drift, read_artifact
from tpuprof_torch.errors import CorruptManifestError
from tpuprof_torch.runtime import singlepass
from tpuprof_torch.serve import DriftWatcher, ProfileScheduler
from tpuprof_torch.serve import watch as watchmod
from tpuprof_torch.testing import faults
from torch_route import same_hash_route  # noqa: F401  (autouse)

CFG = {"batch_rows": 1024}
WAIT = 600


def _frame(shift=0.0, scale=1.0, n=3000, schema=False):
    rng = np.random.default_rng(0)
    df = pd.DataFrame({
        "a": rng.normal(10, 2, n) * scale + shift,
        "b": rng.exponential(1.0, n),
        "c": rng.choice(["x", "y", "z"], n),
    })
    if schema:
        df = df.drop(columns=["b"]).assign(d=rng.normal(0, 1, n))
    return df


def _write(path, df):
    pq.write_table(pa.Table.from_pandas(df, preserve_index=False),
                   path + ".tmp")
    os.replace(path + ".tmp", path)


@pytest.fixture(scope="module")
def port_sched():
    s = ProfileScheduler(workers=1, device="cpu")
    yield s
    s.shutdown(timeout=WAIT)


@pytest.fixture(scope="module")
def ref_sched():
    s = RefScheduler(workers=1)
    yield s
    s.shutdown()


@pytest.fixture(autouse=True)
def no_faults():
    faults.reset()
    ref_faults.reset()
    yield
    faults.reset()
    ref_faults.reset()


# (step name, data writer or None, fault spec or None)
STEPS = [
    ("stable", lambda p: _write(p, _frame()), None),
    ("stable_again", None, None),
    ("drifted", lambda p: _write(p, _frame(shift=100.0, scale=4.0)), None),
    ("drifted_same_shape",
     lambda p: _write(p, _frame(shift=300.0, scale=16.0)), None),
    ("schema_change", lambda p: _write(p, _frame(schema=True)), None),
    ("hung", None, "serve_job:sleep=2@1"),
    ("poisoned", lambda p: open(p, "wb").write(b"not parquet" * 50), None),
    ("recovered", lambda p: _write(p, _frame(schema=True)), None),
]


def _mask_alert(a):
    out = {k: v for k, v in a.items()
           if k not in ("ts", "source", "baseline", "artifact", "error")}
    for k in ("baseline", "artifact"):
        if a.get(k):
            out[k] = os.path.basename(a[k])
    if "error" in a:
        out["error_class"] = a["error"].split(":")[0]
    return out


def _mask_manifest(doc):
    out = {k: v for k, v in doc.items()
           if k not in ("source", "updated_unix", "integrity")}
    if doc.get("last_artifact"):
        out["last_artifact"] = os.path.basename(doc["last_artifact"])
    return out


def _scenario(tmp, Watcher, sched, fmod, tag):
    src = str(tmp / tag / "watched.parquet")
    os.makedirs(os.path.dirname(src))
    spool = str(tmp / tag / "spool")
    records, drift3 = [], None
    watcher = None
    for i, (name, writer, spec) in enumerate(STEPS, 1):
        if writer is not None:
            writer(src)
        if name == "hung":
            # a restart with a job watchdog: the manifest carries the
            # cycle counter, the alert cursor and the dedup key over
            watcher = Watcher(spool, [src], sched, every_s=0, keep=3,
                              job_timeout_s=0.5, config_kwargs=dict(CFG))
        elif watcher is None or name == "poisoned":
            watcher = Watcher(spool, [src], sched, every_s=0, keep=3,
                              config_kwargs=dict(CFG))
        if spec:
            fmod.configure(spec)
        rec = watcher.run_cycle(watcher.watches[0])
        fmod.reset()
        records.append({k: v for k, v in rec.items()
                        if k not in ("source", "seconds")})
        if name == "hung":
            time.sleep(2.0)     # let the abandoned job body finish
        if name == "drifted":
            w = watcher.watches[0]
            drift3 = (w.artifact_path(2), w.artifact_path(3))
    w = watcher.watches[0]
    with open(w.alerts_path) as fh:
        feed = json.load(fh)
    return {"records": records,
            "alerts": [_mask_alert(a) for a in feed],
            "manifest": _mask_manifest(watchmod.read_manifest(
                w.manifest_path)),
            "chain": [c for c, _ in w.chain()],
            "warehouse": sorted(os.listdir(os.path.join(
                spool, "warehouse", w.key))),
            "drift_paths": drift3, "key": w.key, "src": src}


@pytest.fixture(scope="module")
def scenarios(tmp_path_factory, port_sched, ref_sched):
    tmp = tmp_path_factory.mktemp("twatch")
    out = {}
    try:
        out["port"] = _scenario(tmp, DriftWatcher, port_sched, faults,
                                "port")
        out["ref"] = _scenario(tmp, RefWatcher, ref_sched, ref_faults,
                               "ref")
    finally:
        faults.reset()
        ref_faults.reset()
    return out


def test_cycle_records_equal(scenarios):
    port, ref = scenarios["port"]["records"], scenarios["ref"]["records"]
    assert [r["status"] for r in port] == [r["status"] for r in ref] == [
        "ok", "ok", "drift", "drift", "drift", "failed", "failed", "ok"]
    assert port == ref


def test_alerts_equal(scenarios):
    port, ref = scenarios["port"]["alerts"], scenarios["ref"]["alerts"]
    assert port == ref
    kinds = [(a["kind"], a["severity"]) for a in port]
    assert kinds.count(("drift", "drift")) == 2     # the episode dedups
    hung = [a for a in port if a.get("exit_code") == 4]
    assert len(hung) == 1 and hung[0]["error_class"] == "RuntimeError"
    assert port[0]["columns"] == ["a"]


def test_manifests_and_chain_equal(scenarios):
    for k in ("manifest", "chain", "warehouse"):
        assert scenarios["port"][k] == scenarios["ref"][k], k
    assert scenarios["port"]["chain"] == [8, 5, 4]
    assert scenarios["port"]["manifest"]["cycle"] == 8


def test_drift_at_the_jump_agrees(scenarios):
    pa2, pa3 = scenarios["port"]["drift_paths"]
    ra2, ra3 = scenarios["ref"]["drift_paths"]
    # the jump's artifacts have rotated out of the chain (keep=3); the
    # warehouse generations keep them: rebuild the drift from Parquet
    from tpuprof_torch.artifact.drift import ks_statistic, psi_statistic
    from tpuprof_torch.warehouse import history
    res = {}
    for tag in ("port", "ref"):
        s = scenarios[tag]
        root = os.path.join(os.path.dirname(s["src"]), "spool",
                            "warehouse", s["key"])
        doc = history.query_trend(root)
        res[tag] = {e["generation"]: e["columns"] for e in doc["series"]}
    for gen in res["port"]:
        for col, m in res["port"][gen].items():
            r = res["ref"][gen][col]
            for stat in ("psi", "ks"):
                if m[stat] is None:
                    assert r[stat] is None
                else:
                    np.testing.assert_allclose(m[stat], r[stat], atol=5e-4)
    assert res["port"][3]["a"]["psi"] > 1.0
    assert psi_statistic and ks_statistic and pa2 and ra2 and pa3 and ra3


def test_drift_report_between_cycles_agrees(tmp_path, port_sched,
                                            ref_sched):
    """compute_drift over each package's own artifacts of the same two
    sources: per-column PSI and KS within 5e-4."""
    arts = {}
    for tag, Watcher, sched in (("port", DriftWatcher, port_sched),
                                ("ref", RefWatcher, ref_sched)):
        src = str(tmp_path / tag / "s.parquet")
        os.makedirs(os.path.dirname(src))
        _write(src, _frame())
        watcher = Watcher(str(tmp_path / tag / "spool"), [src], sched,
                          every_s=0, keep=5, config_kwargs=dict(CFG))
        w = watcher.watches[0]
        watcher.run_cycle(w)
        _write(src, _frame(shift=1.0, scale=1.2))
        watcher.run_cycle(w)
        arts[tag] = (w.artifact_path(1), w.artifact_path(2))
    mine = compute_drift(read_artifact(arts["port"][0]),
                         read_artifact(arts["port"][1]))
    ref = ref_compute_drift(ref_read_artifact(arts["ref"][0]),
                            ref_read_artifact(arts["ref"][1]))
    assert mine["summary"]["verdict"] == ref["summary"]["verdict"]
    for col, e in mine["columns"].items():
        r = ref["columns"][col]
        assert e["status"] == r["status"]
        for k in ("psi", "ks"):
            if e.get(k) is not None:
                np.testing.assert_allclose(e[k], r[k], atol=5e-4)


def test_source_key_is_the_reference_key(tmp_path):
    for s in (str(tmp_path / "x" / "data.parquet"), "data.parquet",
              "/a/b/c/", "s p a c e.pq", "dir/"):
        assert watchmod.source_key(s) == ref_watch.source_key(s)
    a = watchmod.source_key(str(tmp_path / "x" / "data.parquet"))
    assert a != watchmod.source_key(str(tmp_path / "y" / "data.parquet"))
    assert a.startswith("data.parquet-")


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_manifests_cross_read(tmp_path, writer):
    path = str(tmp_path / "manifest.json")
    state = {"source": "s.parquet", "cycle": 7,
             "last_artifact": "cycle_00000007.artifact.json",
             "alert_seq": 3, "last_alert_key": ["drift", "warn", ["a"]]}
    (watchmod if writer == "port" else ref_watch).write_manifest(path,
                                                                 state)
    with open(path, "rb") as fh:
        data = fh.read()
    a, b = watchmod.read_manifest(path), ref_watch.read_manifest(path)
    assert a == b and a["cycle"] == 7
    torn = str(tmp_path / "torn.json")
    for cut in range(0, len(data), 7):
        with open(torn, "wb") as fh:
            fh.write(data[:cut])
        with pytest.raises(CorruptManifestError):
            watchmod.read_manifest(torn)
        with pytest.raises(RefCorruptManifest):
            ref_watch.read_manifest(torn)


def test_torn_manifest_rebuilds_from_chain(tmp_path, port_sched):
    src = str(tmp_path / "s.parquet")
    _write(src, _frame())
    spool = str(tmp_path / "spool")
    watcher = DriftWatcher(spool, [src], port_sched, every_s=0, keep=3,
                           config_kwargs=dict(CFG))
    w = watcher.watches[0]
    assert watcher.run_cycle(w)["status"] == "ok"
    assert watcher.run_cycle(w)["status"] == "ok"
    with open(w.manifest_path, "rb") as fh:
        data = fh.read()
    with open(w.manifest_path, "wb") as fh:
        fh.write(data[: len(data) // 2])
    with pytest.raises(CorruptManifestError):
        watchmod.read_manifest(w.manifest_path)
    w2 = DriftWatcher(spool, [src], port_sched, every_s=0, keep=3,
                      config_kwargs=dict(CFG)).watches[0]
    assert w2.cycle == 2
    corrupt = [a for a in w2.alerts if a["kind"] == "corrupt_manifest"]
    assert len(corrupt) == 1
    assert "CorruptManifestError" in corrupt[0]["error"]


def test_watch_cycle_fault_is_a_failed_cycle(tmp_path, port_sched):
    src = str(tmp_path / "s.parquet")
    _write(src, _frame())
    watcher = DriftWatcher(str(tmp_path / "spool"), [src], port_sched,
                           every_s=0, config_kwargs=dict(CFG))
    w = watcher.watches[0]
    faults.configure("watch_cycle:fatal@1")
    rec = watcher.run_cycle(w)
    assert rec["status"] == "failed"
    assert "injected fatal" in w.alerts[0]["error"]
    assert w.alerts[0]["kind"] == "failed_cycle"
    assert faults.injected("watch_cycle") == 1
    faults.reset()
    assert watcher.run_cycle(w)["status"] == "ok"
    assert w.cycle == 2


def test_fused_watch_hits_every_lane_and_rebins_nothing(tmp_path,
                                                        port_sched):
    src = str(tmp_path / "s.parquet")
    _write(src, _frame())
    watcher = DriftWatcher(
        str(tmp_path / "spool"), [src], port_sched, every_s=0,
        config_kwargs=dict(CFG, profile_passes="fused"))
    w = watcher.watches[0]
    assert watcher.run_cycle(w)["status"] == "ok"      # cold: a sketch
    c0 = (singlepass.edge_hits, singlepass.edge_misses, singlepass.rebins)
    assert watcher.run_cycle(w)["status"] == "ok"      # seeded: cycle 1
    c1 = (singlepass.edge_hits, singlepass.edge_misses, singlepass.rebins)
    assert c1[0] - c0[0] == 2           # both numeric lanes hit
    assert (c1[1] - c0[1], c1[2] - c0[2]) == (0, 0)
    # and the fused cycle's stats equal a two-pass profile's
    two = DriftWatcher(str(tmp_path / "spool2"), [src], port_sched,
                       every_s=0, config_kwargs=dict(CFG)).watches
    assert two
    a = read_artifact(w.artifact_path(2)).stats["variables"]
    one = port_sched.submit(source=src, stats_json=str(tmp_path / "t.json"),
                            config_kwargs=dict(CFG))
    assert port_sched.wait(one, timeout=WAIT).state == "done"
    with open(tmp_path / "t.json") as fh:
        b = json.load(fh)["variables"]
    for col in ("a", "b"):
        for k in ("count", "mean", "std", "min", "max", "histogram"):
            assert a[col].get(k) == b[col].get(k), (col, k)


def test_watch_verb_with_cycles(tmp_path, capsys):
    src = str(tmp_path / "s.parquet")
    _write(src, _frame())
    spool = str(tmp_path / "spool")
    rc = cli.main(["watch", spool, src, "--device", "cpu", "--every", "0",
                   "--cycles", "2", "--keep", "2", "--config-json",
                   json.dumps(CFG), "--no-compile-cache"])
    err = capsys.readouterr().err
    assert rc == 0, err
    assert "2 ok, 0 warn, 0 drift, 0 failed cycles" in err
    key = watchmod.source_key(src)
    assert watchmod.read_manifest(os.path.join(
        spool, "watch", key, "manifest.json"))["cycle"] == 2
    assert len(os.listdir(os.path.join(spool, "warehouse", key))) == 2
    assert cli.main(["watch", spool, src, "--device", "cpu",
                     "--config-json", "[1]"]) == 2
