"""The port's chaos harness (``tpuprof_torch/testing/chaos.py``) against the
reference's (``tpuprof/testing/chaos.py``).

``build_storm(seed)`` is a pure function of ``random.Random(seed)``: its
plan and fingerprint equal the reference's for the same seed and shape,
and every scripted fault parses in the port's grammar and names a site the
port registers.  Then the transport fault seams of the port's edge, and a
seeded single-process mini storm that loses no job.  The three-daemon
subprocess storm (``serve --http 0 --device cpu`` children, a SIGKILL
victim, byte identity across daemons) is ``slow``, as in the reference.
"""

import os

import jax  # noqa: F401  (JAX stays on the CPU: tests/conftest.py)
import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from tpuprof.testing import chaos as ref_chaos
from tpuprof.testing import faults as ref_faults
from tpuprof_torch.errors import ServeUnavailableError
from tpuprof_torch.serve import submit_job, wait_result, write_job
from tpuprof_torch.testing import faults
from tpuprof_torch.testing.chaos import (CONFIG_VARIANTS, build_storm,
                                         run_storm)
from test_torch_http import _http, port_edge
from torch_route import same_hash_route  # noqa: F401  (autouse)


@pytest.fixture
def parquet_path(tmp_path):
    rng = np.random.default_rng(0)
    n = 3000
    df = pd.DataFrame({"a": rng.normal(10, 2, n),
                       "b": rng.exponential(1.0, n),
                       "c": rng.choice(["x", "y", "z"], n)})
    path = str(tmp_path / "t.parquet")
    pq.write_table(pa.Table.from_pandas(df, preserve_index=False), path)
    return path


@pytest.fixture(autouse=True)
def no_faults():
    faults.reset()
    yield
    faults.reset()


@pytest.mark.parametrize("seed,n_daemons,n_jobs", [
    (0, 3, 9), (1, 3, 9), (7, 3, 9), (19, 3, 9), (4096, 3, 9),
    (5, 1, 3), (11, 1, 3), (2 ** 31 - 1, 4, 12)])
def test_fingerprint_equals_reference(seed, n_daemons, n_jobs):
    mine = build_storm(seed, n_daemons=n_daemons, n_jobs=n_jobs)
    ref = ref_chaos.build_storm(seed, n_daemons=n_daemons, n_jobs=n_jobs)
    assert mine.to_doc() == ref.to_doc()
    assert mine.fingerprint() == ref.fingerprint()
    assert CONFIG_VARIANTS == ref_chaos.CONFIG_VARIANTS


def test_storm_is_a_pure_function_of_the_seed():
    assert build_storm(7).fingerprint() == build_storm(7).fingerprint()
    assert len({build_storm(s).fingerprint() for s in range(8)}) == 8
    plan = build_storm(3)
    plan.submits[0]["tenant"] = "tampered"
    assert plan.fingerprint() != build_storm(3).fingerprint()
    single = build_storm(5, n_daemons=1, n_jobs=3)
    assert not any(d.is_victim for d in single.daemons)
    assert single.kill_after_results == 0
    with pytest.raises(ValueError):
        build_storm(1, n_daemons=0)


@pytest.mark.parametrize("seed", [0, 1, 19, 4096])
def test_every_scripted_fault_parses_and_is_registered(seed):
    plan = build_storm(seed)
    assert sum(d.is_victim for d in plan.daemons) == 1
    for script in plan.daemons:
        parsed = faults.FaultPlan.from_spec(script.faults_spec, seed=seed)
        assert parsed.rules, script.faults_spec
        assert set(parsed.rules) <= faults.SITES
        assert set(parsed.rules) <= ref_faults.SITES


def test_accept_fault_delays_but_never_kills_the_loop(tmp_path):
    faults.configure("http_accept:2@1")
    with port_edge(str(tmp_path / "spool")) as (_daemon, edge):
        code, doc, _ = _http("GET", edge.url + "/v1/healthz")
        assert code == 200 and doc["status"] == "ready"
        assert faults.injected("http_accept") == 2


def test_write_fault_resets_one_conn_keeps_serving(tmp_path):
    faults.configure("http_write:1@1")
    with port_edge(str(tmp_path / "spool")) as (_daemon, edge):
        with pytest.raises(Exception):
            _http("GET", edge.url + "/v1/healthz", timeout=10)
        assert faults.injected("http_write") == 1
        code, doc, _ = _http("GET", edge.url + "/v1/healthz")
        assert code == 200 and doc["status"] == "ready"


def test_seeded_faults_lose_no_jobs(parquet_path, tmp_path):
    """One live edge under the seed's fault plan: every submit — over HTTP
    when the edge answers, spooled when chaos eats the exchange — ends in
    exactly one done result."""
    plan = build_storm(11, n_daemons=1, n_jobs=3)
    script = plan.daemons[0]
    spool = str(tmp_path / "spool")
    faults.install(faults.FaultPlan.from_spec(script.faults_spec,
                                              seed=plan.seed))
    with port_edge(spool) as (_daemon, edge):
        jids = []
        for sub in plan.submits:
            cfg = dict(CONFIG_VARIANTS[sub["variant"]])
            try:
                code, doc = submit_job(edge.url, parquet_path,
                                       tenant=sub["tenant"],
                                       config_kwargs=cfg, timeout=10)
                assert code == 202, doc
                jids.append(doc["id"])
            except ServeUnavailableError:
                jids.append(write_job(spool, parquet_path,
                                      tenant=sub["tenant"],
                                      config_kwargs=cfg))
        for jid in jids:
            assert wait_result(spool, jid, timeout=300)["status"] == "done"
        code, doc, _ = _http("GET", edge.url + "/v1/healthz")
        assert code == 200 and doc["status"] == "ready"
    assert len(set(jids)) == len(jids) == 3


def test_flip_one_warehouse_byte(tmp_path):
    from tpuprof_torch.testing.chaos import _flip_one_warehouse_byte
    spool = str(tmp_path / "s")
    _flip_one_warehouse_byte(spool)             # nothing there: a no-op
    d = os.path.join(spool, "warehouse", "k")
    os.makedirs(d)
    path = os.path.join(d, "gen_00000001.stats.parquet")
    with open(path, "wb") as fh:
        fh.write(bytes(range(16)))
    _flip_one_warehouse_byte(spool)
    with open(path, "rb") as fh:
        blob = fh.read()
    assert blob[8] == 8 ^ 0xFF and blob[:8] == bytes(range(8))


@pytest.mark.slow
def test_scripted_storm_holds_every_invariant(parquet_path, tmp_path):
    plan = build_storm(19)
    report = run_storm(plan, str(tmp_path), parquet_path, timeout=600,
                       device="cpu")
    for jid, res in report.results.items():
        assert res.get("status") == "done", (jid, res)
    assert {f"{j}.json" for j in report.results} <= \
        set(report.spool_results)
    assert report.byte_identity_violations() == []
    assert report.tracebacks() == {}
    for script in plan.daemons:
        rc = report.exit_codes[script.daemon_id]
        assert rc == (-9 if script.is_victim else 0), (script.daemon_id, rc)
