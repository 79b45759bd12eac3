"""The port's serve daemon over a spool directory, and its two verbs.

``tpuprof_torch.serve.ServeDaemon`` on ``device="cpu"``: a spool round trip
through ``write_job``/``wait_result``; a job file the reference's
``tpuprof.serve.write_job`` drops, answered here and read by the
reference's ``read_result`` (the wire is the reference's, byte for byte in
schema); torn result files (``CorruptResultError``) and torn job files (a
rejected record); restart recovery (pending jobs run, answered ones never
re-run); two claim-mode daemons on one spool answering each job once, a
dead peer's claim stolen, and the graceful drain handing queued claims
back.  Then the verbs: ``serve``/``submit`` refusals in process (the HTTP
edge's flags exit 2 naming the later slice; no CUDA without ``--device
cpu`` exits 2), and two child processes: ``serve --once --device cpu``
answering ``submit`` jobs, and a ``SIGTERM`` drain exiting 0.  Every wait
has a timeout.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import jax  # noqa: F401  (JAX stays on the CPU: tests/conftest.py)
import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from tpuprof.serve import read_result as ref_read_result
from tpuprof.serve import write_job as ref_write_job
from tpuprof_torch import ProfileReport, cli
from tpuprof_torch.errors import CorruptResultError, exit_code
from tpuprof_torch.runtime import fleet
from tpuprof_torch.serve import (JOB_SCHEMA, RESULT_SCHEMA, ServeDaemon,
                                 read_result, wait_result, write_job)
from tpuprof_torch.serve.server import poll_intervals
from tpuprof_torch.testing import faults
from torch_route import same_hash_route  # noqa: F401  (autouse)

REPO = str(Path(__file__).resolve().parents[1])
BATCH = 512
WAIT = 120


@pytest.fixture(scope="module")
def source(tmp_path_factory):
    rng = np.random.default_rng(5)
    n = 2000
    df = pd.DataFrame({"x": rng.normal(size=n), "y": rng.gamma(2.0, 1.0, n),
                       "k": rng.choice(["p", "q", "r"], n)})
    path = tmp_path_factory.mktemp("daemon") / "t.parquet"
    pq.write_table(pa.Table.from_pandas(df, preserve_index=False), path,
                   row_group_size=600)
    return str(path)


@pytest.fixture(scope="module")
def one_shot(source):
    return json.dumps(ProfileReport(source, device="cpu", batch_rows=BATCH)
                      .to_json_dict(), sort_keys=True)


@pytest.fixture(autouse=True)
def no_faults():
    faults.reset()
    yield
    faults.reset()


def _serve(daemon):
    t = threading.Thread(target=daemon.run, daemon=True)
    t.start()
    return t


def _stats(path):
    with open(path) as fh:
        return json.dumps(json.load(fh), sort_keys=True)


def test_spool_round_trip(tmp_path, source, one_shot):
    spool = str(tmp_path / "spool")
    d = ServeDaemon(spool, device="cpu", poll_interval=0.02)
    t = _serve(d)
    try:
        jid = write_job(spool, source, tenant="a",
                        stats_json=str(tmp_path / "s.json"),
                        config_kwargs={"batch_rows": BATCH},
                        deadline_unix_ms=int((time.time() + 600) * 1000))
        res = wait_result(spool, jid, timeout=WAIT, poll_interval=0.01)
    finally:
        d.close(timeout=WAIT)
        t.join(timeout=WAIT)
    assert not t.is_alive()
    assert res["schema"] == RESULT_SCHEMA and res["status"] == "done"
    assert (res["id"], res["tenant"], res["rows"], res["cols"]) \
        == (jid, "a", 2000, 3)
    assert res["deadline_unix_ms"] > 0 and "cache_hit" in res
    assert _stats(tmp_path / "s.json") == one_shot
    # the request is consumed once its result landed
    assert os.listdir(os.path.join(spool, "jobs")) == []


def test_reference_client_job_is_answered(tmp_path, source, one_shot):
    """The reference's ``write_job`` drops the request, the port's daemon
    answers it, the reference's ``read_result`` reads the answer."""
    spool = str(tmp_path / "spool")
    jid = ref_write_job(spool, source, stats_json=str(tmp_path / "s.json"),
                        config_kwargs={"batch_rows": BATCH,
                                       "backend": "tpu"})
    with open(os.path.join(spool, "jobs", f"{jid}.json")) as fh:
        assert json.load(fh)["schema"] == JOB_SCHEMA
    d = ServeDaemon(spool, device="cpu", poll_interval=0.02)
    try:
        d.run(once=True)
    finally:
        d.close(timeout=WAIT)
    res = ref_read_result(spool, jid)
    assert res["schema"] == RESULT_SCHEMA and res["status"] == "done"
    assert res == read_result(spool, jid)
    assert _stats(tmp_path / "s.json") == one_shot


def test_torn_result_is_typed(tmp_path):
    spool = tmp_path / "spool"
    (spool / "results").mkdir(parents=True)
    assert read_result(str(spool), "nope") is None
    (spool / "results" / "j1.json").write_text('{"schema": "tpuprof-se')
    with pytest.raises(CorruptResultError, match="torn or corrupt"):
        read_result(str(spool), "j1")
    t0 = time.monotonic()
    with pytest.raises(CorruptResultError):
        wait_result(str(spool), "j1", timeout=0.2, poll_interval=0.01)
    assert time.monotonic() - t0 < 5
    (spool / "results" / "j2.json").write_text("[1, 2]")
    with pytest.raises(CorruptResultError, match="not a result record"):
        read_result(str(spool), "j2")
    with pytest.raises(TimeoutError, match="is `tpuprof serve"):
        wait_result(str(spool), "j3", timeout=0.05, poll_interval=0.01)
    assert exit_code(CorruptResultError("x")) == 6


def test_torn_job_file_is_answered_rejected(tmp_path):
    spool = tmp_path / "spool"
    (spool / "jobs").mkdir(parents=True)
    (spool / "jobs" / "bad.json").write_text("{not json")
    (spool / "jobs" / "foreign.json").write_text(
        json.dumps({"schema": "other-v9", "source": "x"}))
    d = ServeDaemon(str(spool), device="cpu", poll_interval=0.02)
    try:
        d.run(once=True)
    finally:
        d.close(timeout=WAIT)
    for jid, why in (("bad", "unreadable job file"),
                     ("foreign", "is not tpuprof-serve-job-v1")):
        res = read_result(str(spool), jid)
        assert res["status"] == "rejected" and why in res["error"]


def test_rejected_job_result_and_poll_backoff(tmp_path, source):
    spool = str(tmp_path / "spool")
    jid = write_job(spool, source, config_kwargs={"nope": 1})
    d = ServeDaemon(spool, device="cpu", poll_interval=0.02)
    try:
        d.run(once=True)
    finally:
        d.close(timeout=WAIT)
    res = read_result(spool, jid)
    assert res["status"] == "rejected" and "nope" in res["error"]
    gaps = [next(g) for g in [poll_intervals(0.1, cap=0.4)] for _ in range(6)]
    assert all(0.07 <= x <= 0.5 for x in gaps) and gaps[-1] > 0.25


def test_restart_recovery(tmp_path, source, one_shot):
    """Pending job files run after a restart; a job whose result landed
    before a crash is consumed, never re-run."""
    spool = str(tmp_path / "spool")
    pending = write_job(spool, source, stats_json=str(tmp_path / "p.json"),
                        config_kwargs={"batch_rows": BATCH})
    done = write_job(spool, source, stats_json=str(tmp_path / "d.json"),
                     config_kwargs={"batch_rows": BATCH})
    with open(os.path.join(spool, "results", f"{done}.json"), "w") as fh:
        json.dump({"schema": RESULT_SCHEMA, "id": done, "status": "done",
                   "rows": -1}, fh)
    d = ServeDaemon(spool, device="cpu", poll_interval=0.02)
    try:
        d.run(once=True)
        st = d.scheduler.stats()
    finally:
        d.close(timeout=WAIT)
    assert st["requests"] == 1 and st["done"] == 1
    assert read_result(spool, pending)["status"] == "done"
    assert read_result(spool, done)["rows"] == -1
    assert not (tmp_path / "d.json").exists()
    assert _stats(tmp_path / "p.json") == one_shot
    assert os.listdir(os.path.join(spool, "jobs")) == []


def test_two_claim_daemons_answer_each_job_once(tmp_path, source):
    spool = str(tmp_path / "spool")
    ids = [write_job(spool, source, config_kwargs={"batch_rows": BATCH,
                                                   "bins": 3 + i})
           for i in range(6)]
    daemons = [ServeDaemon(spool, device="cpu", poll_interval=0.02,
                           claim_jobs=True, daemon_id=name, workers=1,
                           liveness_timeout_s=30)
               for name in ("d1", "d2")]
    threads = [_serve(d) for d in daemons]
    try:
        results = [wait_result(spool, jid, timeout=WAIT, poll_interval=0.01)
                   for jid in ids]
    finally:
        for d in daemons:
            d.close(timeout=WAIT)
        for t in threads:
            t.join(timeout=WAIT)
    assert all(r["status"] == "done" for r in results)
    computed = sum(d.scheduler.stats()["computed"] for d in daemons)
    assert computed == len(ids)
    assert {r["daemon"] for r in results} <= {"d1", "d2"}
    assert os.listdir(os.path.join(spool, "claims")) == []
    assert os.listdir(os.path.join(spool, "daemons")) == []


def test_dead_peer_claim_is_stolen(tmp_path, source):
    spool = str(tmp_path / "spool")
    jid = write_job(spool, source, config_kwargs={"batch_rows": BATCH})
    os.makedirs(os.path.join(spool, "claims"))
    # a peer that claimed the job and died: no heartbeat file at all
    assert fleet.excl_create(os.path.join(spool, "claims", f"{jid}.claim"),
                             "ghost")
    d = ServeDaemon(spool, device="cpu", poll_interval=0.02,
                    claim_jobs=True, daemon_id="alive",
                    liveness_timeout_s=0.5)
    t = _serve(d)
    try:
        res = wait_result(spool, jid, timeout=WAIT, poll_interval=0.01)
    finally:
        d.close(timeout=WAIT)
        t.join(timeout=WAIT)
    assert res["status"] == "done" and res["daemon"] == "alive"
    assert os.listdir(os.path.join(spool, "claims")) == []


def test_live_peer_claim_is_left_alone_and_drain_releases(tmp_path,
                                                          source):
    spool = str(tmp_path / "spool")
    theirs = write_job(spool, source, config_kwargs={"batch_rows": BATCH})
    os.makedirs(os.path.join(spool, "claims"))
    os.makedirs(os.path.join(spool, "daemons"))
    fleet.atomic_write(os.path.join(spool, "daemons", "hb.peer"), b"alive\n")
    assert fleet.excl_create(
        os.path.join(spool, "claims", f"{theirs}.claim"), "peer")
    d = ServeDaemon(spool, device="cpu", poll_interval=0.02,
                    claim_jobs=True, daemon_id="me", workers=1,
                    liveness_timeout_s=60)
    faults.configure("serve_job:sleep=1@1")
    try:
        mine = [write_job(spool, source, config_kwargs={"batch_rows": BATCH,
                                                        "bins": b})
                for b in (4, 5)]
        d.poll_once()
        assert set(d._pending) == set(mine)
        assert read_result(spool, theirs) is None
        deadline = time.monotonic() + WAIT
        while not any(j.state == "running" for j in d._pending.values()):
            assert time.monotonic() < deadline
            time.sleep(0.01)
    finally:
        d.close(timeout=WAIT)
    # the running job finished here; the queued one was handed back: its
    # job file stays, unclaimed, for a peer
    answered = [j for j in mine if read_result(spool, j) is not None]
    assert len(answered) == 1
    left = set(os.listdir(os.path.join(spool, "jobs")))
    assert left == {f"{theirs}.json"} | {f"{j}.json" for j in mine
                                          if j not in answered}
    assert sorted(os.listdir(os.path.join(spool, "claims"))) \
        == [f"{theirs}.claim"]
    assert d.scheduler.stats()["released"] == 1


def test_submit_local_is_durable_and_answered(tmp_path, source):
    spool = str(tmp_path / "spool")
    d = ServeDaemon(spool, device="cpu", poll_interval=0.02,
                    claim_jobs=True, daemon_id="solo")
    t = _serve(d)
    try:
        job = d.submit_local(source, config_kwargs={"batch_rows": BATCH})
        res = wait_result(spool, job.id, timeout=WAIT, poll_interval=0.01)
        bad = d.submit_local(source, config_kwargs={"bins": 0})
        assert bad.state == "rejected"
        assert read_result(spool, bad.id)["status"] == "rejected"
    finally:
        d.close(timeout=WAIT)
        t.join(timeout=WAIT)
    assert res["status"] == "done" and d.scheduler.stats()["computed"] == 1


# ---------------------------------------------------------------------------
# the verbs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("argv", [
    ["serve", "{spool}", "--http", "0", "--device", "cpu"],
    ["serve", "{spool}", "--serve-auth-file", "a.txt", "--device", "cpu"],
    ["serve", "{spool}", "--breaker-threshold", "3", "--device", "cpu"],
    ["submit", "--url", "http://127.0.0.1:1", "{spool}"],
])
def test_http_edge_flags_exit_2_naming_the_later_slice(tmp_path, capsys,
                                                       argv):
    spool = str(tmp_path / "spool")
    rc = cli.main([a.format(spool=spool) for a in argv])
    err = capsys.readouterr().err
    assert rc == 2 and "serve 3b (the HTTP edge)" in err
    assert len(err.strip().splitlines()) == 1
    assert not os.path.exists(os.path.join(spool, "jobs"))


def test_serve_without_cuda_refuses(tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = cli.main(["serve", str(tmp_path / "spool"), "--once"])
    assert rc == 2 and "no CUDA device" in capsys.readouterr().err


def test_submit_needs_a_spool_and_a_source(capsys):
    assert cli.main(["submit"]) == 2
    assert "spool directory and a source" in capsys.readouterr().err


def test_serve_once_in_process_with_submit_exit_codes(tmp_path, source,
                                                      capsys):
    spool = str(tmp_path / "spool")
    assert cli.main(["submit", spool, source, "--no-wait",
                     "--batch-rows", str(BATCH)]) == 0
    jid = capsys.readouterr().out.strip()
    assert cli.main(["submit", spool, source, "--no-wait",
                     "--config-json", '{"nope": 1}']) == 0
    bad = capsys.readouterr().out.strip()
    assert cli.main(["serve", spool, "--once", "--device", "cpu",
                     "--poll-interval", "0.02"]) == 0
    err = capsys.readouterr().err
    assert "served 2 jobs (1 done, 0 failed, 1 rejected)" in err
    assert "nvcc builds 0" in err
    assert read_result(spool, jid)["status"] == "done"
    assert read_result(spool, bad)["status"] == "rejected"
    assert cli.main(["submit", spool, source, "--config-json", "[1]"]) == 2
    assert cli.main(["submit", spool, source, "--timeout", "0.05"]) == 4


def _child_env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("TPUPROF_FAULTS", None)
    return env


def test_serve_once_child_answers_submit_children(tmp_path, source,
                                                  one_shot):
    """``python -m tpuprof_torch serve --once --device cpu`` answers the
    jobs ``submit --no-wait`` dropped, then ``submit`` waits on a third."""
    spool = str(tmp_path / "spool")
    py = [sys.executable, "-m", "tpuprof_torch"]
    code = (
        "import sys\n"
        "from tpuprof_torch import cli\n"
        f"sys.exit(cli.main(['submit', {spool!r}, {source!r}, "
        f"'--no-wait', '--stats-json', {str(tmp_path / 'a.json')!r}, "
        f"'--batch-rows', '{BATCH}']))\n")
    sub = subprocess.run([sys.executable, "-c", code], env=_child_env(),
                         cwd=REPO, capture_output=True, text=True,
                         timeout=WAIT)
    assert sub.returncode == 0, sub.stderr
    jid = sub.stdout.strip()
    out = subprocess.run(py + ["serve", spool, "--once", "--device", "cpu",
                               "--poll-interval", "0.02"],
                         env=_child_env(), cwd=REPO, capture_output=True,
                         text=True, timeout=WAIT)
    assert out.returncode == 0, out.stderr
    assert "served 1 jobs (1 done" in out.stderr
    assert read_result(spool, jid)["status"] == "done"
    assert _stats(tmp_path / "a.json") == one_shot
    assert os.path.isdir(os.path.join(spool, "aot"))


def test_sigterm_drains_and_exits_0(tmp_path, source):
    spool = str(tmp_path / "spool")
    proc = subprocess.Popen(
        [sys.executable, "-m", "tpuprof_torch", "serve", spool, "--device",
         "cpu", "--poll-interval", "0.02", "--aot-cache", "off"],
        env=_child_env(), cwd=REPO, stderr=subprocess.PIPE, text=True)
    try:
        lines = []
        deadline = time.monotonic() + WAIT
        while time.monotonic() < deadline:
            line = proc.stderr.readline()
            lines.append(line)
            if "serving" in line or not line:
                break
        assert "serving" in lines[-1], lines
        jid = write_job(spool, source, config_kwargs={"batch_rows": BATCH})
        res = wait_result(spool, jid, timeout=WAIT, poll_interval=0.02)
        assert res["status"] == "done"
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=WAIT)
        rest = proc.stderr.read()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=WAIT)
    assert rc == 0, rest
    assert "served 1 jobs (1 done, 0 failed, 0 rejected)" in rest
    assert "postmortem" not in rest
