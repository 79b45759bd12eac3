"""Elastic fleet profiles of the port, end to end on the CPU.

The reference's ``TestElasticCollect`` and ``TestTwoProcessHostDeath``
(``tests/test_fleet_runtime.py``) against ``tpuprof_torch.describe(...,
device="cpu", elastic=True)`` on a Parquet directory of four fragments: one
member equals the static profile exactly; a member killed by
``host_death:@k`` after a checkpoint and restarted with the same id adopts
its claims and cursor and equals an uninterrupted member exactly; a restart
whose checkpoint covers fragments a survivor stole discards it; the
checkpoint carries the finished fragments (``fleet_done``); two member
processes sharing a fleet dir equal one process, their ``.fleet.prom``
labelled by member id; a member killed by ``host_death:@2`` leaves a
survivor that steals its fragments and equals the clean run.  Then the
satellites: ``write_fleet_labeled`` gives the reference's bytes for the same
wires, ``elastic`` without a fleet dir or under a process group raises
``InputError``, and a profile that is not elastic carries no fleet key in its
checkpoint.
"""

import json
import os
import time
import unittest.mock as mock

import jax  # noqa: F401  (JAX stays on the CPU: tests/conftest.py)
import pytest

import tpuprof_torch
from tpuprof.obs import fleet as ref_obs_fleet
from tpuprof.obs import metrics as ref_metrics
from tpuprof_torch.errors import HostDeathError, InputError
from tpuprof_torch.obs import fleet as obs_fleet
from tpuprof_torch.obs import metrics as obs_metrics
from tpuprof_torch.report.export import stats_to_json
from tpuprof_torch.runtime import checkpoint as ckpt
from tpuprof_torch.runtime import distributed
from tpuprof_torch.testing import faults
from torch_ranks import (export_close, finish, launch, mixed_dataset, plain,
                         worker_env)

BATCH = 256         # 900-row fragments: four batches each


@pytest.fixture(autouse=True)
def _isolation():
    faults.reset()
    was = obs_metrics.enabled()
    obs_metrics.set_enabled(True)
    obs_metrics.registry().reset()
    yield
    obs_metrics.registry().reset()
    obs_metrics.set_enabled(was)
    faults.reset()


@pytest.fixture(scope="module")
def ds(tmp_path_factory):
    return mixed_dataset(tmp_path_factory.mktemp("fleet") / "ds")


@pytest.fixture(scope="module")
def static(ds):
    return plain(stats_to_json(tpuprof_torch.describe(
        ds, device="cpu", batch_rows=BATCH)))


def _elastic(ds, fleet, host="h0", **kw):
    return plain(stats_to_json(tpuprof_torch.describe(
        ds, device="cpu", batch_rows=BATCH, elastic=True,
        fleet_dir=str(fleet), fleet_host_id=host, liveness_timeout_s=30.0,
        **kw)))


def test_single_member_equals_static_exactly(ds, static, tmp_path):
    # one member claims the fragments in manifest order: the static stream
    assert _elastic(ds, tmp_path / "fleet") == static


def test_join_adopts_claims_and_checkpoint_exactly(ds, tmp_path):
    """Killed at the 7th batch, after the save at 4 (one fragment, one
    staged group), the member restarts with the same id: it adopts its
    claims and the cursor, replays the claims after the save, and equals
    an uninterrupted member byte for byte."""
    def run(tag):
        return _elastic(ds, tmp_path / f"fleet{tag}", scan_batches=4,
                        checkpoint_path=str(tmp_path / f"ck{tag}"),
                        checkpoint_every_batches=4)
    control = run(1)
    faults.configure("host_death:@7", seed=0)
    with pytest.raises(HostDeathError):
        run(2)
    faults.reset()
    assert os.path.exists(tmp_path / "ck2")
    assert run(2) == control
    assert not os.path.exists(tmp_path / "ck2")


def test_restart_after_steal_discards_the_tainted_checkpoint(ds, static,
                                                             tmp_path):
    fleet, ck = tmp_path / "fleet", str(tmp_path / "ck")
    faults.configure("host_death:@7", seed=0)
    with pytest.raises(HostDeathError):
        _elastic(ds, fleet, "h0", checkpoint_path=ck,
                 checkpoint_every_batches=3)
    faults.reset()
    assert os.path.exists(ck)
    # the survivor steals h0's claims and finishes alone
    export_close(_elastic(ds, fleet, "h1"), static)
    # h0 restarts: its checkpoint's fold covers stolen fragments
    export_close(_elastic(ds, fleet, "h0", checkpoint_path=ck,
                          checkpoint_every_batches=3), static)


def test_checkpoint_carries_the_finished_fragments(ds, tmp_path):
    ck = str(tmp_path / "ck")
    faults.configure("host_death:@7", seed=0)
    with pytest.raises(HostDeathError):
        _elastic(ds, tmp_path / "fleet", checkpoint_path=ck,
                 checkpoint_every_batches=5)
    faults.reset()
    payload = ckpt.load_payload(ck)
    assert payload["host_blob"]["fleet_done"] == [0]
    assert payload["cursor"] == 5


def test_not_elastic_checkpoint_has_no_fleet_key(ds, tmp_path):
    saved = []
    real = ckpt.save

    def spy(path, state, host_blob, cursor, meta, **kw):
        saved.append(set(host_blob))
        return real(path, state, host_blob, cursor, meta, **kw)

    with mock.patch.object(ckpt, "save", spy):
        tpuprof_torch.describe(ds, device="cpu", batch_rows=BATCH,
                               checkpoint_path=str(tmp_path / "ck"),
                               checkpoint_every_batches=4)
    assert saved and all("fleet_done" not in keys for keys in saved)


MEMBER = """
import json, os, sys, time
host, ds, out, fleet = sys.argv[1:5]
peers = sys.argv[5:]
import tpuprof_torch
# start together: the members named after the fleet dir all join before
# either scans (a member that starts late finds nothing left to claim)
open(f"{fleet}.ready.{host}", "w").close()
t0 = time.monotonic()
while not all(os.path.exists(f"{fleet}.ready.{p}") for p in peers):
    assert time.monotonic() - t0 < 60, "peers never started"
    time.sleep(0.02)
from tpuprof_torch.errors import HostDeathError, exit_code
from tpuprof_torch.obs import metrics
from tpuprof_torch.report.export import stats_to_json
from tpuprof_torch.testing import faults
try:
    stats = tpuprof_torch.describe(
        ds, device="cpu", batch_rows=256, elastic=True, fleet_dir=fleet,
        fleet_host_id=host, liveness_timeout_s=3.0, metrics_enabled=True,
        metrics_path=out + ".jsonl")
except HostDeathError as exc:
    json.dump({"died": True, "injected": faults.injected("host_death")},
              open(out, "w"))
    sys.exit(exit_code(exc))
reg = metrics.registry()
json.dump({"stats": stats_to_json(stats),
           "stolen": reg.counter("tpuprof_fragments_stolen_total").total(),
           "rebalances": reg.counter(
               "tpuprof_fleet_rebalances_total").total()}, open(out, "w"))
"""


def _wait_for(path, what, timeout=60.0):
    t0 = time.monotonic()
    while not any(n.startswith(what) for n in
                  (os.listdir(path) if os.path.isdir(path) else ())):
        assert time.monotonic() - t0 < timeout, f"no {what} in {path}"
        time.sleep(0.05)


def test_two_member_processes_equal_one(ds, static, tmp_path):
    fleet = str(tmp_path / "fleet")
    outs = [str(tmp_path / f"{h}.json") for h in "ab"]
    procs = [launch(MEMBER, [h, ds, o, fleet, "a", "b"])
             for h, o in zip("ab", outs)]
    for rc, log in finish(procs):
        assert rc == 0, log[-3000:]
    got = [json.load(open(o)) for o in outs]
    assert got[0]["stats"] == got[1]["stats"]
    export_close(plain(got[0]["stats"]), static)
    # both joined (parts of both cover the fragments), and the live
    # leader (the lowest id) wrote the fleet view, labelled by id
    parts = [n for n in os.listdir(fleet) if n.startswith("part.a.")]
    assert sorted(n.split(".")[2] for n in parts) == ["a", "b"]
    from test_obs_smoke import parse_prom
    prom = parse_prom(open(outs[0] + ".jsonl.fleet.prom").read())
    rss = {lab.get("host") for _n, lab, _v in
           prom["tpuprof_host_rss_bytes"]["samples"]}
    assert rss == {"a", "b"}
    rows = sum(v for _n, _l, v in
               prom["tpuprof_ingest_rows_total"]["samples"])
    assert rows == 2 * 3600     # the two passes over the whole table
    assert not os.path.exists(outs[1] + ".jsonl.fleet.prom")


def test_survivor_of_a_host_death_equals_the_clean_run(ds, static,
                                                       tmp_path):
    """Member ``a`` dies at its 2nd batch (``host_death:@2``), having
    claimed fragments it never contributes; ``b`` starts once ``a`` holds a
    claim, steals what ``a`` left and finishes with the clean run's
    stats."""
    fleet = str(tmp_path / "fleet")
    outs = [str(tmp_path / f"{h}.json") for h in "ab"]
    victim = launch(MEMBER, ["a", ds, outs[0], fleet],
                    env=worker_env(TPUPROF_FAULTS="host_death:@2"))
    _wait_for(fleet, "claim.a.")
    survivor = launch(MEMBER, ["b", ds, outs[1], fleet])
    (rc_a, log_a), (rc_b, log_b) = finish([victim, survivor])
    assert rc_a == 8, log_a[-2000:]
    assert rc_b == 0, log_b[-2000:]
    assert json.load(open(outs[0])) == {"died": True, "injected": 1}
    got = json.load(open(outs[1]))
    export_close(plain(got["stats"]), static)
    steals = [n for n in os.listdir(fleet) if n.startswith("steal.")]
    claims_a = [n for n in os.listdir(fleet) if n.startswith("claim.")
                and open(os.path.join(fleet, n)).read() == "a"]
    assert claims_a and got["rebalances"] >= 1
    assert got["stolen"] == len(steals) >= 1


def test_write_fleet_labeled_gives_the_reference_bytes(tmp_path):
    def wire(mod, rows, depth):
        reg = mod.MetricsRegistry(enabled=True)
        reg.counter("tpuprof_ingest_rows_total", "rows").inc(rows)
        reg.gauge("tpuprof_prep_queue_depth", "depth").set(depth)
        reg.histogram("tpuprof_span_seconds", "spans").observe(
            0.25, name="scan_a")
        return reg.to_wire()
    wires = {"b": wire(obs_metrics, 7, 2), "a": wire(obs_metrics, 5, 1)}
    ref_wires = {"b": wire(ref_metrics, 7, 2), "a": wire(ref_metrics, 5, 1)}
    assert wires == ref_wires
    mine = obs_fleet.write_fleet_labeled(str(tmp_path / "p"), wires)
    theirs = ref_obs_fleet.write_fleet_labeled(str(tmp_path / "r"),
                                               ref_wires)
    assert open(mine, "rb").read() == open(theirs, "rb").read()
    assert 'host="a"' in open(mine).read()
    assert obs_fleet.write_fleet_labeled(None, wires) is None


def test_elastic_needs_a_fleet_dir(ds, monkeypatch):
    monkeypatch.delenv("TPUPROF_FLEET_DIR", raising=False)
    with pytest.raises(InputError, match="fleet_dir"):
        tpuprof_torch.describe(ds, device="cpu", elastic=True)


def test_elastic_refuses_a_process_group(ds, tmp_path, monkeypatch):
    monkeypatch.setattr(distributed, "process_info", lambda: (0, 2))
    with pytest.raises(InputError, match="process group"):
        tpuprof_torch.describe(ds, device="cpu", elastic=True,
                               fleet_dir=str(tmp_path / "fleet"))


def test_member_id_cannot_be_a_path(ds, tmp_path):
    with pytest.raises(InputError, match="filename"):
        _elastic(ds, tmp_path / "fleet", host="../evil")
