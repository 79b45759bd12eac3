"""The port's HTTP edge (``tpuprof_torch/serve/http.py``) against the
reference's (``tpuprof/serve/http.py``).

Both edges run in process over a daemon with the same bearer-token file:
the port's on ``device="cpu"`` (the kernels' plain versions), the
reference's on JAX's CPU backend.  Every route answers with the same status
code, the same headers that matter (``ETag``, ``Retry-After``,
``WWW-Authenticate``, ``X-Tpuprof-Provenance``) and the same body once ids,
times and paths are masked: 400, 401, 404, 429, 503 and 304 included.  A
job round trip and ``submit --url`` give stats equal to the reference's
served stats at ROADMAP's tolerances.  Then the port alone: the three
``/v1/query`` tiers in order (computed, then cache and warehouse with no
job run and no launch), the breaker skipping a corrupt warehouse with the
answer still right, the slow-loris reaper, the connection cap, the header
and body caps, the graceful drain, ``load_auth_file`` against the
reference's on the same files, ``discover_edges``, exit 9 on a closed
port, and one ``serve --http 0 --device cpu`` child drained by SIGTERM.
Every socket, wait and join has a deadline of its own.
"""

import contextlib
import http.client
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import jax  # noqa: F401  (JAX stays on the CPU: tests/conftest.py)
import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from tpuprof.cli import main as ref_main
from tpuprof.errors import InputError as RefInputError
from tpuprof.serve import HttpEdge as RefEdge
from tpuprof.serve import ServeDaemon as RefDaemon
from tpuprof.serve import discover_edges as ref_discover_edges
from tpuprof.serve import load_auth_file as ref_load_auth_file
from tpuprof.testing import faults as ref_faults
from tpuprof_torch import ProfileReport, cli
from tpuprof_torch.errors import (InputError, ServeUnavailableError,
                                  exit_code)
from tpuprof_torch.kernels import fused, hist
from tpuprof_torch.serve import (HttpEdge, ServeDaemon, discover_edges,
                                 load_auth_file, submit_job,
                                 wait_result_http)
from tpuprof_torch.serve.breaker import CircuitBreaker
from tpuprof_torch.testing import faults
from tpuprof_torch.warehouse import append_artifact
from torch_route import same_hash_route  # noqa: F401  (autouse)

REPO = str(Path(__file__).resolve().parents[1])
CFG = {"batch_rows": 1024}
WAIT = 120
TOKENS = "# edge tokens\ntok1 alice\n\ntok2 bob\n"


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    return tmp_path_factory.mktemp("thttp")


@pytest.fixture(scope="module")
def source(workdir):
    rng = np.random.default_rng(0)
    n = 3000
    df = pd.DataFrame({"a": rng.normal(10, 2, n),
                       "b": rng.exponential(1.0, n),
                       "c": rng.choice(["x", "y", "z"], n)})
    path = str(workdir / "t.parquet")
    pq.write_table(pa.Table.from_pandas(df, preserve_index=False), path)
    old = time.time() - 3600            # older than any generation
    os.utime(path, (old, old))
    return path


@pytest.fixture(scope="module")
def auth_file(workdir):
    path = str(workdir / "tokens.txt")
    with open(path, "w") as fh:
        fh.write(TOKENS)
    return path


@contextlib.contextmanager
def running(Daemon, Edge, spool, auth_file=None, edge_kwargs=None,
            **daemon_kwargs):
    daemon_kwargs.setdefault("workers", 1)
    daemon_kwargs.setdefault("liveness_timeout_s", 5.0)
    daemon = Daemon(spool, poll_interval=0.03, claim_jobs=True,
                    daemon_id="d1", **daemon_kwargs)
    edge = Edge(daemon, port=0, auth_file=auth_file,
                **(edge_kwargs or {})).start()
    t = threading.Thread(target=daemon.run, daemon=True)
    t.start()
    try:
        yield daemon, edge
    finally:
        edge.close()
        daemon.stop_event.set()
        t.join(timeout=WAIT)
        daemon.close(timeout=WAIT)


def port_edge(spool, auth_file=None, edge_kwargs=None, **kw):
    return running(ServeDaemon, HttpEdge, spool, auth_file, edge_kwargs,
                   device="cpu", **kw)


@pytest.fixture(scope="module")
def edges(workdir, auth_file):
    with port_edge(str(workdir / "port_spool"), auth_file,
                   read_cache="on") as p, \
            running(RefDaemon, RefEdge, str(workdir / "ref_spool"),
                    auth_file, read_cache="on") as r:
        yield {"port": p, "ref": r}


@pytest.fixture(autouse=True)
def no_faults():
    faults.reset()
    ref_faults.reset()
    yield
    faults.reset()
    ref_faults.reset()


def _http(method, url, body=None, token=None, headers=None, timeout=60):
    hdrs = dict(headers or {})
    if body is not None:
        hdrs.setdefault("Content-Type", "application/json")
        if not isinstance(body, bytes):
            body = json.dumps(body).encode()
    if token:
        hdrs["Authorization"] = f"Bearer {token}"
    req = urllib.request.Request(url, data=body, headers=hdrs,
                                 method=method)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            raw, status, h = resp.read(), resp.status, resp.headers
    except urllib.error.HTTPError as exc:
        raw, status, h = exc.read(), exc.code, exc.headers
    try:
        doc = json.loads(raw) if raw else None
    except ValueError:
        doc = raw.decode("utf-8", "replace")
    return status, doc, h


VOLATILE = {"id", "created_unix", "started_unix", "finished_unix",
            "seconds", "queue_seconds", "ts", "deadline_unix_ms",
            "submitted_unix", "coalesced_with", "daemon", "tpuprof_version"}


def _mask(doc, paths=()):
    if isinstance(doc, dict):
        return {k: ("<v>" if k in VOLATILE else _mask(v, paths))
                for k, v in doc.items()}
    if isinstance(doc, list):
        return [_mask(v, paths) for v in doc]
    if isinstance(doc, str):
        for p in paths:
            doc = doc.replace(p, "<P>")
        return doc
    return doc


def _close(a, b, where=""):
    """ROADMAP's tolerances on two stats documents: integers, strings and
    histogram counts exact; floats at rtol=5e-4, atol=1e-5 (the printed
    ``display`` strings of floats are left out: their last digit follows
    the float)."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), where
        for k in a:
            if k in ("_phases", "_obs", "display"):
                continue
            _close(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"{where}[{i}]")
    elif isinstance(a, float) and not isinstance(a, bool):
        if np.isnan(a):
            assert np.isnan(b), where
        else:
            np.testing.assert_allclose(a, b, rtol=5e-4, atol=1e-5,
                                       err_msg=where)
    else:
        assert a == b, where


# -- route table against the reference --------------------------------------

ROUTES = {
    "no_route": ("GET", "/nope", None, None, {}),
    "no_v1_route": ("GET", "/v1/nope", None, "tok1", {}),
    "jobs_no_token": ("POST", "/v1/jobs", {"source": "x"}, None, {}),
    "jobs_bad_token": ("POST", "/v1/jobs", {"source": "x"}, "nope", {}),
    "jobs_not_json": ("POST", "/v1/jobs", b"{not json", "tok1", {}),
    "jobs_not_object": ("POST", "/v1/jobs", [1, 2], "tok1", {}),
    "jobs_bad_schema": ("POST", "/v1/jobs",
                        {"schema": "x-v9", "source": "s"}, "tok1", {}),
    "jobs_no_source": ("POST", "/v1/jobs", {"config": {}}, "tok1", {}),
    "jobs_bad_config": ("POST", "/v1/jobs", {"source": "s", "config": [1]},
                        "tok1", {}),
    "jobs_bad_output": ("POST", "/v1/jobs", {"source": "s", "output": 3},
                        "tok1", {}),
    "jobs_bad_deadline": ("POST", "/v1/jobs", {"source": "s"}, "tok1",
                          {"X-Tpuprof-Deadline-Ms": "soon"}),
    "jobs_bad_deadline_body": ("POST", "/v1/jobs",
                               {"source": "s", "deadline_unix_ms": "x"},
                               "tok1", {}),
    "jobs_unknown_option": ("POST", "/v1/jobs",
                            {"source": "{src}", "config": {"bogus": 1}},
                            "tok1", {}),
    "job_malformed_id": ("GET", "/v1/jobs/bad!id", None, "tok1", {}),
    "job_unknown": ("GET", "/v1/jobs/j0-unknown", None, "tok1", {}),
    "result_malformed_id": ("GET", "/v1/results/a%20b", None, "tok1", {}),
    "result_unknown": ("GET", "/v1/results/j0-unknown", None, "tok1", {}),
    "alerts_dots": ("GET", "/v1/watch/../alerts", None, "tok1", {}),
    "alerts_unknown": ("GET", "/v1/watch/k-0/alerts", None, "tok1", {}),
    "history_unknown": ("GET", "/v1/history/k-0?col=a", None, "tok1", {}),
    "query_no_body_source": ("POST", "/v1/query", {"cols": ["a"]}, "tok1",
                             {}),
    "query_bad_cols": ("POST", "/v1/query", {"source": "s", "cols": "a"},
                       "tok1", {}),
    "query_bad_stats": ("POST", "/v1/query",
                        {"source": "s", "cols": ["a"], "stats": "mean"},
                        "tok1", {}),
    "query_bad_config": ("POST", "/v1/query",
                         {"source": "s", "cols": ["a"], "config": 1},
                         "tok1", {}),
}


def _raw(method, edge, path, body, token, headers):
    """One exchange through http.client (urllib normalizes some paths)."""
    hdrs = dict(headers)
    if body is not None and not isinstance(body, bytes):
        body = json.dumps(body).encode()
    if body is not None:
        hdrs["Content-Type"] = "application/json"
    if token:
        hdrs["Authorization"] = f"Bearer {token}"
    conn = http.client.HTTPConnection(edge.host, edge.port, timeout=60)
    try:
        conn.request(method, path, body=body, headers=hdrs)
        resp = conn.getresponse()
        raw = resp.read()
        return resp.status, raw, resp.headers
    finally:
        conn.close()


@pytest.mark.parametrize("name", sorted(ROUTES))
def test_route_answers_like_reference(edges, source, name):
    method, path, body, token, headers = ROUTES[name]
    if isinstance(body, dict):
        body = {k: (v.format(src=source) if isinstance(v, str) else v)
                for k, v in body.items()}
    out = {}
    for tag in ("port", "ref"):
        daemon, edge = edges[tag]
        status, raw, h = _raw(method, edge, path, body, token, headers)
        try:
            doc = json.loads(raw)
        except ValueError:
            doc = raw.decode()
        out[tag] = (status, _mask(doc, (daemon.spool,)),
                    h.get("WWW-Authenticate"), h.get("Content-Type"))
    assert out["port"] == out["ref"]
    assert out["port"][0] in (400, 401, 404)


def test_healthz_and_metrics_like_reference(edges):
    shapes = {}
    for tag in ("port", "ref"):
        _, edge = edges[tag]
        status, doc, _ = _http("GET", edge.url + "/v1/healthz")
        shapes[tag] = (status, sorted(doc), doc["status"],
                       doc["breaker"], doc["draining"])
        status, text, h = _http("GET", edge.url + "/metrics")
        assert status == 200 and "tpuprof_http_requests_total" in text
        assert h["Content-Type"].startswith("text/plain")
    assert shapes["port"] == shapes["ref"]
    assert shapes["port"][0] == 200


def test_job_round_trip_like_reference(edges, source, workdir):
    out = {}
    for tag in ("port", "ref"):
        daemon, edge = edges[tag]
        stats = str(workdir / f"{tag}_rt.json")
        code, doc = submit_job(edge.url, source, stats_json=stats,
                               tenant="mallory", config_kwargs=CFG,
                               token="tok2")
        assert code == 202 and doc["tenant"] == "bob"   # the token wins
        res = wait_result_http(edge.url, doc["id"], timeout=WAIT,
                               token="tok2")
        status, job, _ = _http("GET", edge.url + "/v1/jobs/" + doc["id"],
                               token="tok2")
        s1, body1, h1 = _http("GET", edge.url + "/v1/results/" + doc["id"],
                              token="tok2")
        s2, body2, h2 = _http("GET", edge.url + "/v1/results/" + doc["id"],
                              token="tok2",
                              headers={"If-None-Match": h1["ETag"]})
        with open(stats) as fh:
            served = json.load(fh)
        out[tag] = {"wire": _mask({k: v for k, v in res.items()
                                   if k not in ("cache_hit",)},
                                  (stats, daemon.spool)),
                    "job": (status, job["status"]),
                    "etag": (s1, s2, body2, bool(h1["ETag"]),
                             h2["ETag"] == h1["ETag"]),
                    "stats": served}
    _close(out["port"].pop("stats"), out["ref"].pop("stats"))
    assert out["port"] == out["ref"]
    assert out["port"]["etag"][:3] == (200, 304, None)


def test_overload_codes_like_reference(workdir, source, auth_file):
    """A wedged first job: a second of the same tenant is 429 with the
    scheduler's reason, a third queues, a fourth sheds 503 with a
    Retry-After — on both edges."""
    out = {}
    for tag, ctx, fmod in (
            ("port", port_edge, faults),
            ("ref", lambda s, a, **kw: running(RefDaemon, RefEdge, s, a,
                                               **kw), ref_faults)):
        fmod.configure("serve_job:sleep=2@1")
        codes = []
        with ctx(str(workdir / f"{tag}_overload"), auth_file,
                 tenant_quota=1, serve_backlog=1,
                 read_cache="on") as (daemon, edge):
            def post(token, cfg):
                return _http("POST", edge.url + "/v1/jobs",
                             {"source": source, "config": cfg},
                             token=token)
            c1, d1, _ = post("tok1", {"batch_rows": 1024})
            deadline = time.monotonic() + WAIT
            while daemon.scheduler.job(d1["id"]).state != "running":
                assert time.monotonic() < deadline
                time.sleep(0.02)
            c2, d2, _ = post("tok1", {"batch_rows": 512})
            c3, d3, _ = post("tok2", {"batch_rows": 512})
            c4, d4, h4 = post("tok2", {"batch_rows": 2048})
            codes = [(c1, d1.get("status")), (c2, d2.get("reject_kind")),
                     (c3, d3.get("status")), (c4, d4.get("reject_kind")),
                     float(h4["Retry-After"]) > 0]
            assert "quota" in d2["error"]
            for d in (d1, d3):
                assert wait_result_http(edge.url, d["id"], timeout=WAIT,
                                        token="tok1")["status"] == "done"
        fmod.reset()
        out[tag] = codes
    assert out["port"] == out["ref"] == [
        (202, "queued"), (429, "TenantQuotaExceeded"), (202, "queued"),
        (503, "BacklogFull"), True]


def test_submit_url_stats_equal_reference(edges, source, workdir, capsys,
                                          monkeypatch):
    monkeypatch.setenv("TPUPROF_SERVE_TOKEN", "tok1")
    got = {}
    for tag, fn in (("port", cli.main), ("ref", ref_main)):
        _, edge = edges[tag]
        stats = str(workdir / f"{tag}_url.json")
        rc = fn(["submit", "--url", edge.url, source, "--stats-json",
                 stats, "--batch-rows", "1024", "--timeout", str(WAIT)])
        assert rc == 0, capsys.readouterr().err
        with open(stats) as fh:
            got[tag] = json.load(fh)
    _close(got["port"], got["ref"])
    # --no-wait prints the id; a wrong token is a local error (2)
    assert cli.main(["submit", "--url", edges["port"][1].url, source,
                     "--no-wait"]) == 0
    assert capsys.readouterr().out.strip().startswith("j")
    assert cli.main(["submit", "--url", edges["port"][1].url, source,
                     "--token", "wrong"]) == 2
    assert cli.main(["submit", "spool", source, "--url",
                     edges["port"][1].url]) == 2


def _closed_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_unreachable_edge_exits_9(source, capsys):
    url = f"http://127.0.0.1:{_closed_port()}"
    assert cli.main(["submit", "--url", url, source]) == 9
    err = capsys.readouterr().err
    assert "cannot reach" in err and len(err.strip().splitlines()) == 1
    with pytest.raises(ServeUnavailableError) as ei:
        submit_job(url, source)
    assert exit_code(ei.value) == 9 and isinstance(ei.value, OSError)
    assert ref_main(["submit", "--url", url, source]) == 9


# -- the query tiers ---------------------------------------------------------

def _query(edge, source, stats, token="tok1"):
    return _http("POST", edge.url + "/v1/query",
                 {"source": source, "cols": ["a", "b"], "stats": stats},
                 token=token)


def _launches():
    return fused.launches, fused.launches_ab, hist.launches


def test_query_tiers_in_order(workdir, source, auth_file):
    spool = str(workdir / "query_spool")
    # the narrow job a query runs: the one-shot columns= profile at the
    # default config (the query names none)
    one = ProfileReport(source, device="cpu",
                        columns=("a", "b")).description["variables"]
    breaker = CircuitBreaker(threshold=1, cooldown_s=3600)
    with port_edge(spool, auth_file, {"breaker": breaker},
                   read_cache="on") as (daemon, edge):
        sched = daemon.scheduler
        s, doc, h = _query(edge, source, ["mean", "std"])
        assert (s, h["X-Tpuprof-Provenance"]) == (200, "computed")
        for col in ("a", "b"):
            for st in ("mean", "std"):
                assert doc["columns"][col][st] == one[col][st]
        computed = sched.stats()["computed"]
        before = _launches()
        s2, doc2, h2 = _query(edge, source, ["mean", "std"])
        assert h2["X-Tpuprof-Provenance"] == "cache" and doc2 == doc
        s3, _, h3 = _query(edge, source, ["mean", "std"])
        assert h3["ETag"] == h2["ETag"]
        # a generation of the whole profile lands in the warehouse
        from tpuprof_torch.artifact import read_artifact, write_artifact
        art = str(workdir / "q.artifact.json")
        full = ProfileReport(source, device="cpu", batch_rows=1024)
        write_artifact(art, stats=full.description, source=source)
        for g in (1, 2):
            append_artifact(os.path.join(spool, "warehouse"),
                            read_artifact(art), source=source,
                            generation=g)
        s4, doc4, h4 = _query(edge, source, ["mean"])
        assert h4["X-Tpuprof-Provenance"] == "warehouse"
        assert doc4["generation"] == 2
        fv = full.description["variables"]
        assert doc4["columns"]["a"]["mean"] == fv["a"]["mean"]
        assert sched.stats()["computed"] == computed
        assert _launches() == before
        # every generation rots: the walk opens the breaker, the answer
        # is computed and right; the next query skips the warehouse
        wh = os.path.join(spool, "warehouse")
        for root, _, names in os.walk(wh):
            for n in names:
                with open(os.path.join(root, n), "r+b") as fh:
                    blob = fh.read()
                    fh.seek(len(blob) - 5)
                    fh.write(bytes([blob[-5] ^ 0xFF]))
        s5, doc5, h5 = _query(edge, source, ["mean", "max"])
        assert h5["X-Tpuprof-Provenance"] == "computed"
        assert breaker.state(os.path.abspath(source)) == "open"
        s6, doc6, h6 = _query(edge, source, ["max"])
        assert h6["X-Tpuprof-Provenance"] == "breaker_open"
        assert doc6["columns"]["a"]["max"] == one["a"]["max"]
        assert sched.stats()["computed"] == computed + 2
        _, hz, _ = _http("GET", edge.url + "/v1/healthz")
        assert os.path.abspath(source) in hz["breaker"]["open"]


def test_alert_and_history_feeds(workdir, source, auth_file):
    from tpuprof_torch.serve import DriftWatcher
    from tpuprof_torch.serve.watch import source_key
    spool = str(workdir / "feed_spool")
    with port_edge(spool, auth_file) as (daemon, edge):
        src = str(workdir / "feed.parquet")
        rng = np.random.default_rng(1)
        pd.DataFrame({"a": rng.normal(size=2000)}).to_parquet(src)
        w = DriftWatcher(spool, [src], daemon.scheduler, every_s=0,
                         config_kwargs=CFG)
        w.run(cycles=1)
        pd.DataFrame({"a": rng.normal(50, 9, 2000)}).to_parquet(src)
        w.run(cycles=1)
        key = source_key(src)
        s, feed, _ = _http("GET", f"{edge.url}/v1/watch/{key}/alerts",
                           token="tok1")
        assert s == 200 and feed[-1]["kind"] == "drift"
        assert _http("GET", f"{edge.url}/v1/watch/{key}/alerts")[0] == 401
        s, doc, h = _http("GET", f"{edge.url}/v1/history/{key}?col=a",
                          token="tok1")
        assert s == 200 and doc["generations"] == 2
        s2, _, _ = _http("GET", f"{edge.url}/v1/history/{key}?col=a",
                         token="tok1",
                         headers={"If-None-Match": h["ETag"]})
        assert s2 == 304
        s, doc, _ = _http("GET", f"{edge.url}/v1/history/{key}?trend=1",
                          token="tok1")
        assert s == 200 and doc["kind"] == "trend"
        assert _http("GET", f"{edge.url}/v1/history/{key}",
                     token="tok1")[0] == 400


# -- the transport's caps ------------------------------------------------------

def _recv_until_closed(sock, timeout):
    sock.settimeout(timeout)
    chunks = []
    try:
        while True:
            data = sock.recv(4096)
            if not data:
                break
            chunks.append(data)
    except (socket.timeout, OSError):
        pass
    return b"".join(chunks)


def test_slow_loris_is_reaped(tmp_path):
    with port_edge(str(tmp_path / "s"),
                   edge_kwargs={"conn_timeout_s": 0.5}) as (_, edge):
        sock = socket.create_connection((edge.host, edge.port), timeout=30)
        t0 = time.monotonic()
        try:
            sock.sendall(b"GET /v1/healthz HTT")
            got = _recv_until_closed(sock, timeout=10.0)
        finally:
            sock.close()
        assert got == b"" and time.monotonic() - t0 < 8.0


def test_header_and_body_caps(tmp_path, source):
    with port_edge(str(tmp_path / "s"),
                   edge_kwargs={"max_header_bytes": 2048,
                                "max_body_bytes": 2048}) as (_, edge):
        sock = socket.create_connection((edge.host, edge.port), timeout=30)
        try:
            sock.sendall(b"GET / HTTP/1.1\r\nX-Flood: " + b"a" * 4096)
            assert _recv_until_closed(sock, timeout=10.0) == b""
        finally:
            sock.close()
        conn = http.client.HTTPConnection(edge.host, edge.port, timeout=30)
        try:
            conn.request("POST", "/v1/jobs", body=b"x" * 4096,
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            doc = json.loads(resp.read())
            assert resp.status == 400 and "2048" in doc["error"]
            assert resp.getheader("Connection") == "close"
        finally:
            conn.close()


def test_connection_cap(tmp_path):
    with port_edge(str(tmp_path / "s"),
                   edge_kwargs={"max_connections": 1}) as (_, edge):
        first = socket.create_connection((edge.host, edge.port), timeout=30)
        try:
            first.sendall(b"GET /v1/healthz HTTP/1.1\r\nHost: x\r\n\r\n")
            first.settimeout(10)
            assert first.recv(12).startswith(b"HTTP/1.1 200")
            second = socket.create_connection((edge.host, edge.port),
                                              timeout=30)
            try:
                got = _recv_until_closed(second, timeout=10.0)
            finally:
                second.close()
            assert got.startswith(b"HTTP/1.1 503")
        finally:
            first.close()


def test_graceful_drain(tmp_path):
    with port_edge(str(tmp_path / "s")) as (daemon, edge):
        conn = http.client.HTTPConnection(edge.host, edge.port, timeout=30)
        try:
            conn.request("GET", "/v1/healthz")
            r = conn.getresponse()
            assert r.status == 200 and json.loads(r.read())["status"] \
                == "ready"
            assert discover_edges(daemon.spool) == {"d1": edge.url}
            daemon.stop_event.set()
            edge.stop_accepting()
            # the established keep-alive connection is still answered
            conn.request("GET", "/v1/healthz")
            r = conn.getresponse()
            assert r.status == 503 and json.loads(r.read())["status"] \
                == "draining"
            assert discover_edges(daemon.spool) == {}
            deadline = time.monotonic() + 10
            while True:
                try:
                    socket.create_connection((edge.host, edge.port),
                                             timeout=2).close()
                except OSError:
                    break
                assert time.monotonic() < deadline, "listener still open"
                time.sleep(0.05)
        finally:
            conn.close()


# -- auth files, discovery -----------------------------------------------------

AUTH_CASES = {
    "ok": TOKENS,
    "empty": "# nothing\n\n",
    "three_fields": "tok alice extra\n",
    "duplicate": "tok alice\ntok bob\n",
}


@pytest.mark.parametrize("name", sorted(AUTH_CASES) + ["unreadable"])
def test_load_auth_file_like_reference(tmp_path, name):
    path = str(tmp_path / "auth.txt")
    if name != "unreadable":
        with open(path, "w") as fh:
            fh.write(AUTH_CASES[name])
    try:
        mine = ("ok", load_auth_file(path))
    except InputError as exc:
        mine = ("err", str(exc))
    try:
        ref = ("ok", ref_load_auth_file(path))
    except RefInputError as exc:
        ref = ("err", str(exc))
    assert mine == ref
    assert (mine[0] == "ok") == (name == "ok")


def test_discover_edges_like_reference(tmp_path):
    spool = str(tmp_path / "s")
    os.makedirs(os.path.join(spool, "daemons"))
    for name, body in (("http.a", "http://h:1\n"), ("http.b", ""),
                       ("hb.a", "alive"), (".tmp.http.c", "x"),
                       ("http.d", "http://h:4")):
        with open(os.path.join(spool, "daemons", name), "w") as fh:
            fh.write(body)
    assert discover_edges(spool) == ref_discover_edges(spool) \
        == {"a": "http://h:1", "d": "http://h:4"}
    assert discover_edges(str(tmp_path / "none")) == {}


def test_transport_fault_sites(tmp_path):
    """``http_accept`` skips one accept round, ``http_write`` drops one
    connection; the loop keeps serving."""
    with port_edge(str(tmp_path / "s")) as (_, edge):
        faults.configure("http_accept:1@1,http_write:1@1")
        deadline = time.monotonic() + 30
        answered = 0
        while answered < 2:
            assert time.monotonic() < deadline
            try:
                s, doc, _ = _http("GET", edge.url + "/v1/healthz",
                                  timeout=5)
                answered += s == 200
            except (OSError, http.client.HTTPException):
                pass
        assert faults.injected("http_accept") == 1
        assert faults.injected("http_write") == 1


def test_serve_http_child_drains_on_sigterm(tmp_path, source, auth_file):
    spool = str(tmp_path / "spool")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.Popen(
        [sys.executable, "-m", "tpuprof_torch", "serve", spool, "--http",
         "0", "--device", "cpu", "--serve-auth-file", auth_file,
         "--breaker-threshold", "2", "--serve-conn-timeout", "5"],
        cwd=REPO, env=env, stderr=subprocess.PIPE, text=True)
    try:
        deadline = time.monotonic() + WAIT
        while not discover_edges(spool):
            assert proc.poll() is None and time.monotonic() < deadline
            time.sleep(0.1)
        url = next(iter(discover_edges(spool).values()))
        assert _http("POST", url + "/v1/jobs", {"source": source})[0] \
            == 401
        stats = str(tmp_path / "s.json")
        rc = cli.main(["submit", "--url", url, source, "--token", "tok1",
                       "--stats-json", stats, "--batch-rows", "1024",
                       "--timeout", str(WAIT)])
        assert rc == 0
        proc.send_signal(signal.SIGTERM)
        _, err = proc.communicate(timeout=WAIT)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate(timeout=30)
    assert proc.returncode == 0, err
    assert "http edge on http://127.0.0.1:" in err and "(auth required)" \
        in err
    assert "served 1 jobs (1 done" in err
    assert "Traceback" not in err


def test_bad_edge_flags_exit_2(tmp_path, capsys):
    bad = str(tmp_path / "empty_tokens")
    open(bad, "w").close()
    rc = cli.main(["serve", str(tmp_path / "spool"), "--http", "0",
                   "--device", "cpu", "--serve-auth-file", bad, "--once"])
    err = capsys.readouterr().err
    assert rc == 2 and "http edge:" in err and "lists no tokens" in err
