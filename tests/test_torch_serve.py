"""The port's serve scheduler, job queue and caches against the reference.

``tpuprof_torch.serve`` (jobs, the keyed runner cache, the read tier, the
scheduler) on ``device="cpu"``, held against ``tpuprof.serve``: the job
state machine and wire record, the bounded multi-tenant queue (quotas,
depth, backlog, close), ``percentile``, ``runner_key`` (every keyed field
and none other), the runner cache (hits, misses, LRU, racing threads, a
cached runner serving many profiles with unchanged stats), admission
rejects, a failed job beside a live scheduler, the ``serve_job`` fault
under ``job_timeout_s``, deadlines and cancel, coalescing, the read tier
(``ResultCache``'s CRC demote and LRU by entries and bytes, the reference's
bytes for ``canonical_body``/``etag_for``/``source_fingerprint``), and 4
concurrent mixed-shape jobs, each equal to the port's one-shot
``ProfileReport`` and, at ROADMAP's tolerances, to the reference's
``ProfileReport(backend="tpu")`` (JAX on CPU devices, Pallas in interpret
mode).  Every wait has a timeout.
"""

import dataclasses
import json
import sys
import threading
import time

import jax  # noqa: F401  (JAX stays on the CPU: tests/conftest.py)
import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

import tpuprof
from tpuprof import schema as ref_schema
from tpuprof.serve import cache as ref_cache
from tpuprof.serve import jobs as ref_jobs
from tpuprof_torch import ProfileReport
from tpuprof_torch.config import ProfilerConfig
from tpuprof_torch.errors import CorruptReadCacheError
from tpuprof_torch.report.export import stats_to_json
from tpuprof_torch.serve import ProfileScheduler, cache, jobs
from tpuprof_torch.serve.jobs import (DONE, FAILED, QUEUED, REJECTED,
                                      RUNNING, Job, JobQueue, QueueClosed,
                                      QueueFull, TenantQuotaExceeded)
from tpuprof_torch.testing import faults
from torch_route import same_hash_route  # noqa: F401  (autouse)

RTOL, ATOL, RHO_ATOL = 5e-4, 1e-5, 5e-4
BATCH = 512
WAIT = 120          # seconds any wait may take before the test fails
MOMENTS = ("mean", "std", "variance", "sum", "mad", "skewness", "kurtosis")


def _frame(n=2500, seed=11):
    rng = np.random.default_rng(seed)
    df = pd.DataFrame({
        "a": rng.normal(5.0, 2.0, n),
        "b": rng.gamma(2.0, 3.0, n).astype(np.float32),
        "c": rng.integers(0, 50, n).astype(np.int64),
        "d": rng.normal(0.0, 1.0, n),
        "tag": rng.choice(["x", "y", "z", "w"], n),
    })
    df["e"] = df["a"] * 0.5 + rng.normal(0, 0.1, n)
    df.loc[rng.choice(n, 120, replace=False), "a"] = np.nan
    return df


@pytest.fixture(scope="module")
def source(tmp_path_factory):
    root = tmp_path_factory.mktemp("serve")
    path = root / "t.parquet"
    pq.write_table(pa.Table.from_pandas(_frame(), preserve_index=False),
                   path, row_group_size=700)
    return str(path)


@pytest.fixture
def sched():
    s = ProfileScheduler(workers=2, device="cpu")
    yield s
    s.shutdown(wait=True, timeout=WAIT)


@pytest.fixture(autouse=True)
def no_faults():
    faults.reset()
    yield
    faults.reset()


def _one_shot(source, **kw):
    return json.dumps(ProfileReport(source, device="cpu", batch_rows=BATCH,
                                    **kw).to_json_dict(), sort_keys=True)


def _job_stats(path):
    with open(path) as fh:
        return json.dumps(json.load(fh), sort_keys=True)


# ---------------------------------------------------------------------------
# the job state machine and the queue, against the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mod", [jobs, ref_jobs], ids=["port", "ref"])
def test_job_state_machine(mod):
    j = mod.Job("s.parquet", job_id="j1")
    with pytest.raises(ValueError, match="illegal transition"):
        j.to(mod.DONE)
    j.to(mod.RUNNING).to(mod.DONE)
    assert j.seconds is not None and j.queue_seconds is not None
    with pytest.raises(ValueError):
        j.to(mod.FAILED)
    k = mod.Job("s.parquet").to(mod.FAILED, error="late", exit_code=11)
    assert (k.state, k.error, k.exit_code) == ("failed", "late", 11)
    assert mod.TERMINAL == ("done", "failed", "rejected")


def test_job_wire_record_is_the_reference():
    """The same lifecycle on both packages' ``Job`` gives the same wire
    dict (the latencies aside)."""
    docs = []
    for mod in (jobs, ref_jobs):
        j = mod.Job("/d/t.parquet", output="/o.html", tenant="t9",
                    job_id="j7", stats_json="/s.json",
                    config_kwargs={"bins": 3}, deadline_unix=1234.5)
        j.cache_hit = True
        j.coalesced_with = "j6"
        j.to(mod.RUNNING).to(mod.FAILED, error="boom", exit_code=4)
        j.result = {"rows": 5}
        j.reject_kind = "QueueFull"
        doc = j.to_wire()
        assert isinstance(doc.pop("seconds"), float)
        assert isinstance(doc.pop("queue_seconds"), float)
        docs.append(doc)
    assert docs[0] == docs[1]
    assert docs[0]["deadline_unix_ms"] == 1234500


@pytest.mark.parametrize("mod", [jobs, ref_jobs], ids=["port", "ref"])
def test_queue_depth_quota_release_close(mod):
    q = mod.JobQueue(depth=2, tenant_quota=1)
    a, b = mod.Job("s", tenant="t1"), mod.Job("s", tenant="t2")
    q.admit(a)
    with pytest.raises(mod.TenantQuotaExceeded, match="quota 1"):
        q.admit(mod.Job("s", tenant="t1"))
    q.admit(b)
    with pytest.raises(mod.QueueFull, match="2 jobs queued"):
        q.admit(mod.Job("s", tenant="t3"))
    assert q.next(timeout=1) is a and len(q) == 1
    # a's tenant slot frees only at release (queued + running count)
    with pytest.raises(mod.TenantQuotaExceeded):
        q.admit(mod.Job("s", tenant="t1"))
    q.release(a)
    q.admit(mod.Job("s", tenant="t1"))
    snap = q.snapshot()
    assert snap["queued"] == 2 and snap["tenants_live"] == {"t1": 1,
                                                            "t2": 1}
    kept = q.drain(keep=lambda j: j.tenant == "t2")
    assert [j.tenant for j in kept] == ["t1"] and len(q) == 1
    q.close()
    with pytest.raises(mod.QueueClosed):
        q.admit(mod.Job("s"))
    assert q.next(timeout=1) is b and q.next(timeout=1) is None
    assert q.next(timeout=0.01) is None


@pytest.mark.parametrize("values,q", [
    ([], 50), ([3.0], 99), ([5.0, 1.0, 3.0], 50), ([5.0, 1.0, 3.0], 99),
    (list(np.linspace(0, 1, 17)), 50), (list(np.linspace(0, 1, 17)), 99)])
def test_percentile_is_the_reference(values, q):
    assert jobs.percentile(values, q) == ref_jobs.percentile(values, q)


# ---------------------------------------------------------------------------
# runner_key and the runner cache
# ---------------------------------------------------------------------------

BASE_KEY = cache.runner_key(ProfilerConfig(), 4, 2, ["cpu"])


@pytest.mark.parametrize("change", [
    {"batch_rows": 1024}, {"mesh_devices": 1}, {"hll_precision": 10},
    {"bins": 20}, {"pass_b_kernel": "legacy"}, {"profile_passes": "fused"}])
def test_runner_key_holds_each_launch_field(change):
    assert cache.runner_key(ProfilerConfig(**change), 4, 2, ["cpu"]) \
        != BASE_KEY


@pytest.mark.parametrize("change", [
    {"metrics_path": "m.jsonl"}, {"aot_cache_dir": "/store"},
    {"aot_cache": "off"}, {"seed_edges": "a.json"}, {"columns": ["a"]},
    {"job_timeout_s": 5.0}, {"checkpoint_path": "c.ckpt"},
    {"pass_b_kernel": "cumulative"}, {"profile_passes": "two_pass"},
    {"spearman": True}])
def test_runner_key_ignores_other_fields(change):
    assert cache.runner_key(ProfilerConfig(**change), 4, 2, ["cpu"]) \
        == BASE_KEY


def test_runner_key_shape_devices_and_env(monkeypatch):
    cfg = ProfilerConfig()
    assert cache.runner_key(cfg, 5, 2, ["cpu"]) != BASE_KEY
    assert cache.runner_key(cfg, 4, 3, ["cpu"]) != BASE_KEY
    assert cache.runner_key(cfg, 4, 2, ["cpu", "cpu"]) != BASE_KEY
    assert BASE_KEY[2] == (("cpu", None),)
    # env-resolved now: the key is what a build at this moment produces
    monkeypatch.setenv("TPUPROF_PROFILE_PASSES", "fused")
    assert cache.runner_key(cfg, 4, 2, ["cpu"])[-1] == "fused"
    # no device named is cuda:0, which does not exist here
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cache.runner_key(cfg, 4, 2)


def test_runner_cache_hits_misses_and_lru():
    rc = cache.RunnerCache(capacity=2)
    cfgs = [ProfilerConfig(bins=b) for b in (3, 4, 5)]
    r3 = rc.get(cfgs[0], 4, 1, ["cpu"])
    assert rc.get(ProfilerConfig(bins=3, metrics_path="x"), 4, 1,
                  ["cpu"]) is r3
    rc.get(cfgs[1], 4, 1, ["cpu"])
    rc.get(cfgs[2], 4, 1, ["cpu"])          # evicts bins=3 (LRU)
    assert cache.runner_key(cfgs[0], 4, 1, ["cpu"]) not in rc
    assert rc.get(cfgs[0], 4, 1, ["cpu"]) is not r3
    st = rc.stats()
    assert (st["hits"], st["misses"], st["runners"]) == (1, 4, 2)
    mesh = rc.get(cfgs[1], 4, 1, ["cpu", "cpu"])
    assert type(mesh).__name__ == "MeshRunner" and mesh.n_dev == 2
    rc.clear()
    assert rc.stats()["runners"] == 0


def test_runner_cache_racing_threads_share_one_runner():
    """Many threads, a short switch interval: one build, one runner."""
    rc = cache.RunnerCache()
    cfg = ProfilerConfig(bins=7)
    got, errors = [], []

    def worker():
        try:
            for _ in range(50):
                got.append(rc.get(cfg, 6, 2, ["cpu"]))
        except Exception as exc:    # noqa: BLE001 — reported below
            errors.append(exc)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=WAIT)
    finally:
        sys.setswitchinterval(old)
    assert not errors and not any(t.is_alive() for t in threads)
    assert len(got) == 800 and len({id(r) for r in got}) == 1
    assert rc.stats()["misses"] == 1 and rc.stats()["hits"] == 799


def test_cached_runner_serves_many_profiles_unchanged(source, monkeypatch):
    """Two profiles through one cached runner give the stats of two
    fresh runners."""
    cache.process_cache().clear()
    cached = [_one_shot(source), _one_shot(source, bins=6),
              _one_shot(source)]
    st = cache.cache_stats()
    assert st["misses"] == 2 and st["hits"] == 1
    monkeypatch.setenv("TPUPROF_RUNNER_CACHE", "0")
    assert not cache.cache_enabled()
    fresh = [_one_shot(source), _one_shot(source, bins=6)]
    assert cache.cache_stats()["hits"] == 1
    assert cached[0] == cached[2] == fresh[0] and cached[1] == fresh[1]


# ---------------------------------------------------------------------------
# the scheduler
# ---------------------------------------------------------------------------

def test_scheduler_refuses_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ProfileScheduler(workers=1)
    s = ProfileScheduler(workers=1, device="cpu")
    assert s.device == torch.device("cpu")
    s.shutdown(timeout=WAIT)


@pytest.mark.parametrize("kwargs,match", [
    ({"bogus": 1}, "unknown config options"),
    ({"backend": "cpu"}, "serve jobs run the gpu engine"),
    ({"bins": 0}, "bins must be >= 1"),
    ({"serve_http_port": 8080}, "serve 3b"),
    ({"aot_cache": "maybe"}, "aot_cache"),
])
def test_admission_rejects(sched, source, kwargs, match):
    j = sched.submit(source=source, config_kwargs=kwargs)
    assert j.state == REJECTED and j.reject_kind in ("ValueError",
                                                     "NotImplementedError")
    assert match in j.error
    assert sched.stats()["rejected"] == 1


def test_reference_engine_name_is_this_engine(sched, source, tmp_path):
    """A reference client's job names ``backend="tpu"``: it runs here."""
    j = sched.submit(source=source, stats_json=str(tmp_path / "s.json"),
                     config_kwargs={"backend": "tpu", "batch_rows": BATCH})
    assert sched.wait(j, timeout=WAIT).state == DONE, j.error
    assert _job_stats(tmp_path / "s.json") == _one_shot(source)


def test_failed_job_does_not_stop_the_scheduler(sched, source, tmp_path):
    bad = sched.submit(source=str(tmp_path / "missing.parquet"))
    assert sched.wait(bad, timeout=WAIT).state == FAILED
    assert bad.exit_code is not None and bad.error
    faults.configure("serve_job:fatal@1")
    boom = sched.submit(source=source, config_kwargs={"batch_rows": BATCH})
    assert sched.wait(boom, timeout=WAIT).state == FAILED
    assert "injected fatal fault" in boom.error and boom.exit_code == 1
    ok = sched.submit(source=source, stats_json=str(tmp_path / "s.json"),
                      config_kwargs={"batch_rows": BATCH})
    assert sched.wait(ok, timeout=WAIT).state == DONE, ok.error
    assert ok.result == {"rows": 2500, "cols": 6}
    st = sched.stats()
    assert (st["done"], st["failed"]) == (1, 2)


def test_serve_job_hang_fails_on_the_watchdog(source, tmp_path):
    s = ProfileScheduler(workers=1, device="cpu", job_timeout_s=0.5)
    try:
        faults.configure("serve_job:sleep=2@1")
        hung = s.submit(source=source, config_kwargs={"batch_rows": BATCH})
        assert s.wait(hung, timeout=WAIT).state == FAILED
        assert hung.exit_code == 4 and "WatchdogTimeout" in hung.error
        assert hung.seconds < 2.0
        faults.reset()
        nxt = s.submit(source=source, stats_json=str(tmp_path / "s.json"),
                       config_kwargs={"batch_rows": BATCH})
        assert s.wait(nxt, timeout=WAIT).state == DONE, nxt.error
        assert _job_stats(tmp_path / "s.json") == _one_shot(source)
        # a job's own deadline beats the daemon's
        own = s.submit(source=source, config_kwargs={
            "batch_rows": BATCH, "job_timeout_s": 60.0})
        assert own._config.job_timeout_s == 60.0
        assert s.wait(own, timeout=WAIT).state == DONE
    finally:
        s.shutdown(timeout=WAIT)


def test_deadline_and_cancel_never_start_a_job(source):
    s = ProfileScheduler(workers=1, device="cpu")
    try:
        faults.configure("serve_job:sleep=1@1")
        slow = s.submit(source=source, config_kwargs={"batch_rows": BATCH})
        deadline = time.monotonic() + WAIT
        while slow.state == QUEUED and time.monotonic() < deadline:
            time.sleep(0.01)
        late = s.submit(source=source, deadline_unix=time.time() - 5,
                        config_kwargs={"batch_rows": BATCH})
        gone = s.submit(source=source, config_kwargs={"batch_rows": BATCH})
        assert s.cancel(gone.id) and not s.cancel(slow.id)
        for j in (slow, late, gone):
            s.wait(j, timeout=WAIT)
        assert slow.state == DONE
        assert late.state == FAILED and late.exit_code == 11
        assert "DeadlineExceededError" in late.error
        assert gone.state == FAILED and "cancelled" in gone.error
        st = s.stats()
        assert (st["deadline_expired"], st["cancelled"], st["computed"]) \
            == (1, 1, 1)
        assert late.started_at is None and gone.started_at is None
    finally:
        s.shutdown(timeout=WAIT)


def test_backlog_sheds_and_release_queued(source):
    s = ProfileScheduler(workers=1, device="cpu", serve_backlog=1)
    try:
        faults.configure("serve_job:sleep=1@1")
        first = s.submit(source=source, config_kwargs={"batch_rows": BATCH})
        deadline = time.monotonic() + WAIT
        while first.state == QUEUED and time.monotonic() < deadline:
            time.sleep(0.01)
        queued = s.submit(source=source, config_kwargs={"batch_rows": BATCH})
        shed = s.submit(source=source, config_kwargs={"batch_rows": BATCH})
        assert shed.state == REJECTED and shed.reject_kind == "BacklogFull"
        assert s.retry_after_s() > 0
        released = s.release_queued()
        assert released == [queued] and queued.state == QUEUED
        assert s.wait(first, timeout=WAIT).state == DONE
        st = s.stats()
        assert (st["shed"], st["released"]) == (1, 1)
    finally:
        s.shutdown(timeout=WAIT)


def test_coalescing_and_the_read_tier(source, tmp_path):
    s = ProfileScheduler(workers=2, device="cpu", read_cache="on")
    try:
        faults.configure("serve_job:sleep=1@1")
        a = s.submit(source=source, config_kwargs={"batch_rows": BATCH})
        b = s.submit(source=source, config_kwargs={"batch_rows": BATCH})
        assert b.coalesced_with == a.id
        for j in (a, b):
            assert s.wait(j, timeout=WAIT).state == DONE
        assert a.result == b.result == {"rows": 2500, "cols": 6}
        c = s.submit(source=source, config_kwargs={"batch_rows": BATCH})
        assert c.state == DONE and c.read_cache == "hit"
        assert c.result == a.result
        # a job with outputs must run: the write is the product
        d = s.submit(source=source, stats_json=str(tmp_path / "d.json"),
                     config_kwargs={"batch_rows": BATCH})
        assert d.read_cache is None and d.coalesced_with is None
        assert s.wait(d, timeout=WAIT).state == DONE
        st = s.stats()
        assert (st["computed"], st["coalesced"]) == (2, 1)
        assert st["read_cache"]["hits"] == 1
        assert set(st) == set(_ref_stats_keys())
        snap = s.snapshot()
        assert snap["counts"][DONE] == 4 and len(snap["recent"]) == 4
        hb = s.heartbeat()
        assert hb["done"] == 4 and hb["queued"] == 0
    finally:
        s.shutdown(timeout=WAIT)


def _ref_stats_keys():
    """The keys of the reference scheduler's ``stats()``."""
    from tpuprof.serve import ProfileScheduler as RefScheduler
    ref = RefScheduler(workers=1)
    try:
        return set(ref.stats())
    finally:
        ref.shutdown(timeout=WAIT)


def test_metrics_state_is_kept_for_jobs_that_say_nothing(sched, source):
    from tpuprof_torch.obs import metrics
    metrics.set_enabled(True)
    try:
        j = sched.submit(source=source, config_kwargs={"batch_rows": BATCH})
        assert j._config.metrics_enabled is True
        assert sched.wait(j, timeout=WAIT).state == DONE
        assert metrics.enabled()
        assert metrics.counter("tpuprof_serve_requests_total").value(
            status="done") >= 1
    finally:
        metrics.set_enabled(False)
        metrics.registry().reset()


# ---------------------------------------------------------------------------
# the read tier's cache
# ---------------------------------------------------------------------------

DOCS = [{"rows": 5, "cols": 2}, {"rows": 7, "cols": 3, "x": "é"},
        {"n": [1, 2.5, None], "nested": {"a": True}}]


@pytest.mark.parametrize("doc", DOCS)
def test_canonical_body_and_etag_are_the_reference(doc):
    body = cache.canonical_body(doc)
    assert body == ref_cache.canonical_body(doc)
    assert cache.etag_for(body) == ref_cache.etag_for(body)
    rc = cache.ResultCache()
    assert rc.put("k", doc) == cache.etag_for(body)
    assert rc.get("k") == (body, cache.etag_for(body))


def test_source_fingerprint_is_the_reference(source, tmp_path):
    assert cache.source_fingerprint(source) \
        == ref_cache.source_fingerprint(source)
    other = tmp_path / "gone.parquet"
    assert cache.source_fingerprint(str(other)) \
        == ref_cache.source_fingerprint(str(other))
    missing = cache.source_fingerprint(str(other))
    other.write_bytes(b"x")         # a file now: its size and mtime count
    assert cache.source_fingerprint(str(other)) != missing
    assert cache.source_fingerprint(str(other)) \
        == ref_cache.source_fingerprint(str(other))


def test_result_cache_crc_demotes_loudly(caplog):
    rc = cache.ResultCache()
    rc.put("k", {"rows": 1})
    payload, crc = rc._entries["k"]
    rc._entries["k"] = (payload[:-2] + b"9\n", crc)     # rot in memory
    assert rc.get("k") is None
    st = rc.stats()
    assert (st["demotes"], st["misses"], st["entries"], st["bytes"]) \
        == (1, 1, 0, 0)
    assert any("failed its CRC check" in r.message
               and r.levelname == "WARNING" for r in caplog.records)
    assert issubclass(CorruptReadCacheError, ValueError)


def test_result_cache_lru_by_entries_and_bytes():
    rc = cache.ResultCache(capacity=2, max_bytes=10 ** 6)
    for i in range(3):
        rc.put(i, {"i": i})
    assert rc.get(0) is None and rc.get(1) is not None
    assert rc.stats()["evictions"] == 1
    one = len(cache.canonical_body({"pad": "x" * 100}))
    rc = cache.ResultCache(capacity=100, max_bytes=2 * one)
    for i in range(3):
        rc.put(i, {"pad": str(i) * 100})
    assert rc.get(0) is None and rc.stats()["bytes"] == 2 * one
    assert rc.get(2) is not None
    rc.get(1)               # 1 is now the most recent; 2 goes next
    rc.put(3, {"pad": "3" * 100})
    assert rc.get(2) is None and rc.get(1) is not None
    big = rc.put("big", {"pad": "y" * (3 * one)})
    assert big.startswith('"crc32-') and rc.get("big") is None
    rc.clear()
    assert rc.stats()["entries"] == 0


# ---------------------------------------------------------------------------
# 4 concurrent mixed-shape jobs against both one-shots
# ---------------------------------------------------------------------------

SHAPES = {"all": {}, "proj": {"columns": ["d", "a", "tag"]},
          "bins": {"bins": 7}, "fused": {"profile_passes": "fused"}}


@pytest.fixture(scope="module")
def concurrent(source, tmp_path_factory):
    """4 jobs of two tenants on 2 workers: {shape: (job, stats path)}."""
    root = tmp_path_factory.mktemp("jobs")
    s = ProfileScheduler(workers=2, device="cpu")
    out = {}
    try:
        for i, (name, kw) in enumerate(SHAPES.items()):
            path = str(root / f"{name}.json")
            out[name] = (s.submit(source=source, tenant=f"t{i % 2}",
                                  stats_json=path, output=str(
                                      root / f"{name}.html"),
                                  config_kwargs={"batch_rows": BATCH,
                                                 **kw}), path)
        for job, _ in out.values():
            s.wait(job, timeout=WAIT)
    finally:
        s.shutdown(timeout=WAIT)
    return out


@pytest.mark.parametrize("shape", list(SHAPES))
def test_concurrent_job_equals_the_port_one_shot(concurrent, source, shape):
    job, path = concurrent[shape]
    assert job.state == DONE, job.error
    assert _job_stats(path) == _one_shot(source, **SHAPES[shape])
    kw = dict(SHAPES[shape])
    if kw.get("profile_passes") == "fused":
        # fused equals two-pass exactly
        assert _job_stats(path) == _one_shot(source)
    with open(job.output, encoding="utf-8") as fh:
        assert "<html" in fh.read()


@pytest.mark.parametrize("shape", list(SHAPES))
def test_concurrent_job_matches_the_reference(concurrent, source, shape):
    job, _ = concurrent[shape]
    kw = dict(SHAPES[shape])
    port = ProfileReport(source, device="cpu", batch_rows=BATCH,
                         **kw).description
    assert json.dumps(stats_to_json(port), sort_keys=True) \
        == _job_stats(concurrent[shape][1])
    ref = tpuprof.ProfileReport(source, backend="tpu", batch_rows=BATCH,
                                **kw).description
    assert list(port["variables"]) == list(ref["variables"])
    for name, rv in ref["variables"].items():
        pv = port["variables"][name]
        assert pv["type"] == rv["type"], name
        for fld in ("count", "n_missing", "distinct_count"):
            assert pv[fld] == rv[fld], (name, fld)
        if rv["type"] != ref_schema.NUM:
            continue
        for fld in ("n_zeros", "n_infinite", "min", "max"):
            assert pv[fld] == rv[fld], (name, fld)
        np.testing.assert_array_equal(pv["histogram"][0],
                                      rv["histogram"][0], err_msg=name)
        for fld in MOMENTS:
            np.testing.assert_allclose(pv[fld], rv[fld], rtol=RTOL,
                                       atol=ATOL, err_msg=f"{name}.{fld}")
    pp, rp = port["correlations"]["pearson"], ref["correlations"]["pearson"]
    np.testing.assert_allclose(pp.to_numpy(), rp.to_numpy(), rtol=0,
                               atol=RHO_ATOL, equal_nan=True)


def test_every_config_field_a_job_may_name_is_known():
    """Admission validates against the port's fields, which are the
    reference's."""
    from tpuprof.config import ProfilerConfig as RefConfig
    assert {f.name for f in dataclasses.fields(ProfilerConfig)} \
        == {f.name for f in dataclasses.fields(RefConfig)}
    assert RUNNING == "running" and QUEUED == "queued"
    assert issubclass(QueueFull, RuntimeError) \
        and issubclass(TenantQuotaExceeded, RuntimeError) \
        and issubclass(QueueClosed, RuntimeError)
    assert isinstance(JobQueue(), JobQueue) and Job("s").tenant == "default"
