"""Network serving plane of the port: the HTTP edge over the serve daemon.

Counterpart of ``tpuprof/serve/http.py``, with its routes, status codes,
headers and wire schemas (``tpuprof-serve-job-v1`` /
``tpuprof-serve-result-v1`` / ``tpuprof-query-v1``), so a client of either
package talks to an edge of the other.  ``python -m tpuprof_torch serve
SPOOL --http PORT`` puts a network front door on the existing scheduler: a
selector-based stdlib HTTP server (no new dependency).  The edge OWNS no
job lifecycle: admission, quotas, watchdogs and typed failures stay in
serve/scheduler.py; HTTP is a second client of the machinery the file
spool uses — and the spool stays the durability layer (every
HTTP-accepted job is spooled + claimed before it is admitted, so a killed
daemon's jobs are stolen and answered by fleet peers).  The edge's threads
never touch CUDA: only the scheduler's workers launch kernels.

Routes::

    POST /v1/jobs                submit one job -> 202 {"id", ...};
                                 quota/depth rejection -> 429 with the
                                 scheduler's reject reason; malformed
                                 body -> 400 (never a daemon crash);
                                 draining daemon -> 503; backlog shed
                                 -> 503 with a jittered
                                 Retry-After derived from the observed
                                 drain rate — read-tier hits keep
                                 serving while compute degrades
    POST /v1/query               {source, cols, stats} -> the values
                                 doc, answered from the cheapest tier
                                 that is still CORRECT: the edge
                                 result cache, else a column-pruned
                                 read of the newest fresh warehouse
                                 generation, else a narrow (column-
                                 subset) profile job; the serving tier
                                 is on the X-Tpuprof-Provenance header
                                 and the computing tier in the body
    GET  /v1/jobs/<id>           lifecycle view (local live state,
                                 else the spool's terminal record,
                                 else "queued" for a peer's job)
    GET  /v1/results/<id>        the terminal record: 200 when landed
                                 (ETag + If-None-Match -> 304), 202
                                 while pending, 404 unknown
    GET  /v1/watch/<key>/alerts  a watched source's alerts.json feed
                                 (read-only — watch consumers poll
                                 the edge, not the spool filesystem)
    GET  /v1/history/<key>       warehouse history series (ETag +
                                 If-None-Match -> 304)
    GET  /v1/healthz             daemon readiness for fleet balancers
                                 (unauthenticated, like /metrics):
                                 200 ready, 503 warming (the restart
                                 prewarm of runtime/aot.py in
                                 progress — keys loaded/
                                 pending in the body), 503 draining;
                                 the body carries read-cache entries/
                                 bytes/hit-rate + computed/coalesced
                                 counts (read-tier health)
    GET  /metrics                Prometheus text exposition of the
                                 process registry (the scrape surface;
                                 unauthenticated by design, like every
                                 /metrics in the fleet)

The transport: one selector event loop owns every
socket — accept, keep-alive reads, response writes — and parsed
requests run on a small bounded worker pool, so thousands of idle
keep-alive connections cost file descriptors, not threads (the
thread-per-socket edge pinned one Python thread per open connection).
Conditional requests ride strong CRC ETags (serve/cache.py
``etag_for``): a balancer or client that re-validates an unchanged
result gets a bodyless 304 instead of a re-serialized answer.

Auth: a ``serve_auth_file`` of ``<token> <tenant>`` lines maps bearer
tokens onto tenants — the tenant id feeds the per-tenant quotas, so one
leaked curl loop cannot starve the card for everyone else.
With a token file configured, every ``/v1/*`` request must carry
``Authorization: Bearer <token>`` (401 otherwise) and the token's
tenant OVERRIDES anything the body claims: identity comes from the
credential, not the payload.

The client half (``submit --url http://host:port src``) lives
here too: submit + poll over HTTP with the same jittered backoff the
file-spool ``wait_result`` uses, and a typed
:class:`~tpuprof.errors.ServeUnavailableError` (exit code 9) when the
edge cannot be reached at all.
"""

from __future__ import annotations

import collections
import io
import json
import os
import re
import selectors
import socket
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from http.client import parse_headers
from http.client import responses as _HTTP_REASONS
from typing import Any, Dict, Optional, Tuple

from tpuprof_torch.errors import (CorruptResultError, InputError,
                            ServeUnavailableError)
from tpuprof_torch.obs import events as _obs_events
from tpuprof_torch.obs import metrics as _obs_metrics
from tpuprof_torch.serve.server import (JOB_SCHEMA, RESULT_SCHEMA, ServeDaemon,
                                  poll_intervals, read_result)
from tpuprof_torch.testing import faults as _faults

_REQUESTS = _obs_metrics.counter(
    "tpuprof_http_requests_total",
    "HTTP edge requests by status code and route pattern")
_REQUEST_SECONDS = _obs_metrics.histogram(
    "tpuprof_http_request_seconds",
    "HTTP edge request handling latency (receive -> response written) "
    "— does NOT include the job's own runtime, only the edge")
_PUSHDOWN = _obs_metrics.counter(
    "tpuprof_query_pushdown_total",
    "/v1/query answers by serving tier (cache|warehouse|computed)")

MAX_BODY_BYTES = 1 << 20            # a job request is a small JSON doc;
                                    # anything bigger is garbage or abuse

QUERY_SCHEMA = "tpuprof-query-v1"   # the /v1/query answer document

_ID_RE = re.compile(r"^[A-Za-z0-9._-]+$")


def load_auth_file(path: str) -> Dict[str, str]:
    """Parse a bearer-token file: one ``<token> <tenant>`` pair per
    line, blank lines and ``#`` comments ignored.  Every failure is a
    typed :class:`InputError` — a daemon must refuse to start half-
    authenticated, not silently serve an open edge."""
    try:
        with open(path, encoding="utf-8") as fh:
            lines = fh.read().splitlines()
    except OSError as exc:
        raise InputError(
            f"serve_auth_file {path!r} is unreadable "
            f"({type(exc).__name__}: {exc})") from exc
    tokens: Dict[str, str] = {}
    for n, raw in enumerate(lines, 1):
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        if len(parts) != 2:
            raise InputError(
                f"serve_auth_file {path}:{n}: expected '<token> "
                f"<tenant>', got {raw!r}")
        token, tenant = parts
        if token in tokens:
            raise InputError(
                f"serve_auth_file {path}:{n}: token listed twice "
                "(each token maps to exactly one tenant)")
        tokens[token] = tenant
    if not tokens:
        raise InputError(
            f"serve_auth_file {path!r} lists no tokens — an auth file "
            "with nothing in it would lock every client out; remove "
            "the flag for an open edge")
    return tokens


# ---------------------------------------------------------------------------
# server side
# ---------------------------------------------------------------------------

MAX_HEADER_BYTES = 64 << 10         # request line + headers cap — a
                                    # buffer that grows past this with
                                    # no complete head is a flood
HTTP_WORKERS = 8                    # bounded handler pool: concurrency
                                    # of request HANDLING, decoupled
                                    # from how many sockets are open


class _Conn:
    """One client connection's loop-owned state."""
    __slots__ = ("sock", "rbuf", "wbuf", "busy", "close_after",
                 "dropped", "events", "deadline", "pending_job")

    def __init__(self, sock):
        self.sock = sock
        self.rbuf = b""             # bytes read, not yet parsed
        self.wbuf = b""             # response bytes not yet written
        self.busy = False           # a request is in flight (no
                                    # pipelining ambiguity: dispatch
                                    # waits for the answer)
        self.close_after = False    # close once wbuf drains
        self.dropped = False
        self.events = 0             # current selector interest mask
        self.deadline = None        # monotonic cutoff for the CURRENT
                                    # I/O obligation (finish sending a
                                    # request / drain a response); a
                                    # trickling client cannot extend it
                                    # — the slow-loris defense.  None
                                    # while a handler runs:
                                    # job time is the watchdog's beat.
        self.pending_job = None     # job id this connection is owed an
                                    # answer for — a disconnect before
                                    # the answer cancels it if still
                                    # unclaimed


class _SelectorHttpServer:
    """Selector-based async HTTP/1.1 server: ONE event
    loop thread owns accept + every socket's reads/writes, and parsed
    requests are handled on a bounded :class:`ThreadPoolExecutor` —
    thousands of idle keep-alive connections cost file descriptors,
    not Python threads.

    Keeps the stdlib server's driving surface (``server_address``,
    ``serve_forever``/``shutdown``/``server_close``).  Routing stays
    in :meth:`HttpEdge.handle`; this class only speaks the wire:
    request-line + header parse (:func:`http.client.parse_headers` —
    case-insensitive, exactly what ``handle`` already consumes),
    Content-Length bodies capped at :data:`MAX_BODY_BYTES`, keep-alive
    per HTTP/1.1 semantics, partial writes finished under
    ``EVENT_WRITE``."""

    def __init__(self, address, workers: int = HTTP_WORKERS,
                 max_connections: Optional[int] = None,
                 conn_timeout_s: Optional[float] = None,
                 max_header_bytes: Optional[int] = None,
                 max_body_bytes: Optional[int] = None):
        from tpuprof_torch.config import (resolve_serve_conn_timeout,
                                    resolve_serve_max_body_bytes,
                                    resolve_serve_max_connections,
                                    resolve_serve_max_header_bytes)
        # per-connection abuse caps: an open socket is a
        # bounded liability — a ceiling on how many, a deadline on each
        # I/O obligation, and byte caps on what one request may send
        self.max_connections = resolve_serve_max_connections(
            max_connections)
        self.conn_timeout_s = resolve_serve_conn_timeout(conn_timeout_s)
        self.max_header_bytes = resolve_serve_max_header_bytes(
            max_header_bytes)
        self.max_body_bytes = resolve_serve_max_body_bytes(
            max_body_bytes)
        self.edge = None            # set by HttpEdge after construction
        self._listen = socket.create_server(address, backlog=128)
        self._listen.setblocking(False)
        self.server_address = self._listen.getsockname()
        self._sel = selectors.DefaultSelector()
        self._sel.register(self._listen, selectors.EVENT_READ,
                           ("listen", None))
        # self-pipe: workers finishing a response (and shutdown) wake
        # the select() so the loop never sleeps on a ready answer
        self._wake_r, self._wake_w = socket.socketpair()
        self._wake_r.setblocking(False)
        self._wake_w.setblocking(False)
        self._sel.register(self._wake_r, selectors.EVENT_READ,
                           ("wake", None))
        self._pool = ThreadPoolExecutor(
            max_workers=max(int(workers), 1),
            thread_name_prefix="tpuprof-http-worker")
        self._lock = threading.Lock()
        self._completed: "collections.deque[Tuple[_Conn, bytes]]" = \
            collections.deque()
        self._conns: set = set()
        self._stop = threading.Event()
        self._stopped = threading.Event()
        self._accepting = True          # loop-thread view
        self._stop_accept = threading.Event()   # cross-thread request

    # -- loop --------------------------------------------------------------

    def serve_forever(self) -> None:
        try:
            while not self._stop.is_set():
                for key, mask in self._sel.select(timeout=0.5):
                    kind, conn = key.data
                    if kind == "listen":
                        self._accept()
                    elif kind == "wake":
                        try:
                            while self._wake_r.recv(4096):
                                pass
                        except (BlockingIOError, OSError):
                            pass
                    else:
                        if mask & selectors.EVENT_WRITE:
                            self._flush(conn)
                        if mask & selectors.EVENT_READ \
                                and not conn.dropped:
                            self._readable(conn)
                if self._stop_accept.is_set() and self._accepting:
                    self._pause_listener()
                self._drain_completed()
                self._sweep_deadlines()
        finally:
            self._stopped.set()

    def shutdown(self) -> None:
        self._stop.set()
        self._wake()
        self._stopped.wait(timeout=10)

    def stop_accepting(self) -> None:
        """Graceful-drain step 1: close the listening socket
        (the port frees immediately for a replacement daemon) while
        every established connection keeps its reads, its in-flight
        handlers, and its pending writes.  Thread-safe; the loop thread
        does the actual unregister on its next tick."""
        self._stop_accept.set()
        self._wake()

    def _pause_listener(self) -> None:
        self._accepting = False
        try:
            self._sel.unregister(self._listen)
        except (KeyError, OSError):
            pass
        try:
            self._listen.close()
        except OSError:
            pass

    def _sweep_deadlines(self) -> None:
        """Reap connections past their I/O deadline — the slow-loris
        defense: a client trickling header bytes (or never draining its
        response) holds a socket for at most ``conn_timeout_s``, because
        progress does NOT extend the deadline; only completing the
        obligation clears it."""
        now = time.monotonic()
        for conn in [c for c in self._conns
                     if c.deadline is not None and now > c.deadline]:
            self._drop(conn)

    def server_close(self) -> None:
        for sock in (self._listen, self._wake_r, self._wake_w):
            try:
                sock.close()
            except OSError:
                pass
        for conn in list(self._conns):
            try:
                conn.sock.close()
            except OSError:
                pass
        self._conns.clear()
        try:
            self._sel.close()
        except OSError:
            pass
        self._pool.shutdown(wait=False)

    def _wake(self) -> None:
        try:
            self._wake_w.send(b"x")
        except (BlockingIOError, OSError):
            pass

    # -- socket events (loop thread only) ----------------------------------

    def _accept(self) -> None:
        while self._accepting:
            try:
                # chaos seam: an injected accept failure
                # (EMFILE under fd pressure) must skip THIS round and
                # leave the listener registered — the loop survives
                _faults.hit("http_accept")
                sock, _addr = self._listen.accept()
            except (BlockingIOError, OSError):
                return
            except Exception:       # noqa: BLE001 — injected fault
                return
            sock.setblocking(False)
            if len(self._conns) >= self.max_connections:
                # connection ceiling: the newcomer gets a terse 503 and
                # the door — accepting unboundedly would turn every fd
                # the OS grants into loop state an attacker sized
                try:
                    sock.send(b"HTTP/1.1 503 Service Unavailable\r\n"
                              b"Connection: close\r\n"
                              b"Content-Length: 0\r\n\r\n")
                except OSError:
                    pass
                try:
                    sock.close()
                except OSError:
                    pass
                continue
            conn = _Conn(sock)
            conn.deadline = time.monotonic() + self.conn_timeout_s
            self._conns.add(conn)
            self._interest(conn, selectors.EVENT_READ)

    def _interest(self, conn: _Conn, events: int) -> None:
        """Set the selector interest mask for a connection (0 parks it
        — a busy connection with a request in flight is watched for
        NOTHING: reads pause until its answer is written)."""
        if conn.dropped or events == conn.events:
            return
        if conn.events and not events:
            self._sel.unregister(conn.sock)
        elif events and not conn.events:
            self._sel.register(conn.sock, events, ("conn", conn))
        elif events:
            self._sel.modify(conn.sock, events, ("conn", conn))
        conn.events = events

    def _drop(self, conn: _Conn) -> None:
        if conn.dropped:
            return
        conn.dropped = True
        if conn.pending_job is not None:
            # the client this answer was for is gone: cancel the job if
            # no worker claimed it yet (claimed jobs finish and publish
            # to the result cache — coalescing followers still win)
            jid, conn.pending_job = conn.pending_job, None
            if self.edge is not None:
                try:
                    self.edge.client_gone(jid)
                except Exception:   # noqa: BLE001 — dropping must not
                    pass            # take the loop down
        if conn.events:
            try:
                self._sel.unregister(conn.sock)
            except (KeyError, OSError):
                pass
            conn.events = 0
        try:
            conn.sock.close()
        except OSError:
            pass
        self._conns.discard(conn)

    def _readable(self, conn: _Conn) -> None:
        try:
            data = conn.sock.recv(64 << 10)
        except (BlockingIOError, InterruptedError):
            return
        except OSError:
            self._drop(conn)
            return
        if not data:
            self._drop(conn)        # peer closed (a busy connection's
            return                  # drop cancels its pending job)
        conn.rbuf += data
        if conn.busy and len(conn.rbuf) > \
                self.max_header_bytes + self.max_body_bytes:
            self._drop(conn)        # flooding while an answer is owed
            return
        self._maybe_dispatch(conn)

    def _maybe_dispatch(self, conn: _Conn) -> None:
        """Parse one complete request off the buffer and hand it to
        the worker pool; incomplete requests wait for more bytes."""
        if conn.busy or conn.dropped:
            return
        head_end = conn.rbuf.find(b"\r\n\r\n")
        if head_end < 0:
            if len(conn.rbuf) > self.max_header_bytes:
                self._drop(conn)    # header flood, no valid request
            return
        head_lines = conn.rbuf[:head_end].split(b"\r\n")
        try:
            request_line = head_lines[0].decode("latin-1")
            method, path, version = request_line.split()
            headers = parse_headers(io.BytesIO(
                b"\r\n".join(head_lines[1:]) + b"\r\n\r\n"))
        except (ValueError, UnicodeDecodeError):
            self._drop(conn)        # not HTTP — no answer owed
            return
        try:
            length = int(headers.get("Content-Length") or 0)
        except ValueError:
            length = -1
        body: Optional[bytes] = None
        if 0 <= length <= self.max_body_bytes:
            total = head_end + 4 + length
            if len(conn.rbuf) < total:
                return              # body still arriving
            body = conn.rbuf[head_end + 4:total]
            conn.rbuf = conn.rbuf[total:]
        else:
            # oversized/garbage length: the handler answers 400 (body
            # None), and the connection closes — the unread body bytes
            # make the stream unframeable
            conn.rbuf = b""
            conn.close_after = True
        if version == "HTTP/1.0":
            conn.close_after = conn.close_after or \
                (headers.get("Connection") or "").lower() != "keep-alive"
        else:
            if (headers.get("Connection") or "").lower() == "close":
                conn.close_after = True
        conn.busy = True
        conn.deadline = None        # handler time is the job
                                    # watchdog's business, not the
                                    # transport's
        # reads stay on while answering: a peer that disconnects
        # mid-handling is noticed by the empty recv (and its pending
        # job cancelled) instead of discovered at write time; dispatch
        # of buffered pipelined bytes still waits on `busy`
        self._pool.submit(self._handle, conn, method, path, body,
                          headers)

    def _flush(self, conn: _Conn) -> None:
        if conn.dropped:
            return
        if conn.wbuf:
            try:
                # chaos seam: a connection reset mid-
                # response — the client sees a torn answer, the loop
                # drops the socket and keeps serving everyone else
                _faults.hit("http_write")
            except Exception:       # noqa: BLE001 — injected fault
                self._drop(conn)
                return
            try:
                sent = conn.sock.send(conn.wbuf)
                conn.wbuf = conn.wbuf[sent:]
            except (BlockingIOError, InterruptedError):
                pass
            except OSError:
                self._drop(conn)
                return
        if conn.wbuf:
            self._interest(conn, selectors.EVENT_WRITE)
            return
        if conn.busy:
            return                  # response not queued yet
        if conn.close_after:
            self._drop(conn)
            return
        # response fully delivered: the idle keep-alive clock starts
        conn.deadline = time.monotonic() + self.conn_timeout_s
        self._interest(conn, selectors.EVENT_READ)
        if conn.rbuf:
            # the client already sent its next keep-alive request
            self._maybe_dispatch(conn)

    def _drain_completed(self) -> None:
        while True:
            with self._lock:
                if not self._completed:
                    return
                conn, payload = self._completed.popleft()
            if conn.dropped:
                continue
            conn.pending_job = None     # the answer is on its way out:
                                        # the id is (being) delivered,
                                        # the job is the client's now
            conn.wbuf += payload
            conn.busy = False
            # the write obligation gets its own deadline: a client that
            # never drains its answer is a held fd, not a served one
            conn.deadline = time.monotonic() + self.conn_timeout_s
            self._flush(conn)

    # -- request handling (worker pool) ------------------------------------

    def _handle(self, conn: _Conn, method: str, path: str,
                body: Optional[bytes], headers) -> None:
        t0 = time.perf_counter()
        extra: Optional[Dict[str, str]] = None
        try:
            res = self.edge.handle(method, path, body, headers,
                                   conn=conn)
            code, rbody, route = res[0], res[1], res[2]
            if len(res) > 3:
                extra = res[3]
        except Exception as exc:    # noqa: BLE001 — an edge answers
            code, route = 500, "error"
            rbody, extra = {"error": f"{type(exc).__name__}: {exc}"}, None
        response = self._render(code, rbody, extra,
                                close=conn.close_after)
        with self._lock:
            self._completed.append((conn, response))
        self._wake()
        _REQUESTS.inc(code=str(code), route=route)
        _REQUEST_SECONDS.observe(time.perf_counter() - t0)

    @staticmethod
    def _render(code: int, body, extra: Optional[Dict[str, str]],
                close: bool) -> bytes:
        if isinstance(body, bytes):
            payload = body
            ctype = "text/plain; version=0.0.4; charset=utf-8"
        else:
            payload = json.dumps(body, indent=1, default=str).encode()
            ctype = "application/json"
        headers = dict(extra or {})
        ctype = headers.pop("Content-Type", ctype)
        reason = _HTTP_REASONS.get(code, "Unknown")
        lines = [f"HTTP/1.1 {code} {reason}",
                 "Server: tpuprof-serve"]
        if code == 401:
            lines.append("WWW-Authenticate: Bearer")
        lines.append(f"Content-Type: {ctype}")
        lines.append(f"Content-Length: {len(payload)}")
        for name, value in headers.items():
            lines.append(f"{name}: {value}")
        lines.append("Connection: close" if close
                     else "Connection: keep-alive")
        head = ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1")
        return head + payload


class HttpEdge:
    """One daemon's HTTP front door: a :class:`_SelectorHttpServer`
    delegating every route to the daemon's spool + scheduler.  Bind
    with ``port=0`` for an ephemeral port (CI — no collisions on a
    busy box); the bound port is on :attr:`port` and advertised in
    ``SPOOL/daemons/http.<daemon-id>`` for fleet-local discovery."""

    def __init__(self, daemon: ServeDaemon, port: int = 0,
                 host: str = "127.0.0.1",
                 auth_file: Optional[str] = None,
                 max_connections: Optional[int] = None,
                 conn_timeout_s: Optional[float] = None,
                 max_header_bytes: Optional[int] = None,
                 max_body_bytes: Optional[int] = None,
                 breaker=None):
        self.daemon = daemon
        self.tokens = load_auth_file(auth_file) if auth_file else None
        self.httpd = _SelectorHttpServer(
            (host, int(port)),
            max_connections=max_connections,
            conn_timeout_s=conn_timeout_s,
            max_header_bytes=max_header_bytes,
            max_body_bytes=max_body_bytes)
        self.httpd.edge = self
        # warehouse-pushdown circuit breaker: the daemon's
        # if it built one, else the process-wide default — a rotting
        # source's corrupt-walk tax is paid once, not per query
        if breaker is None:
            breaker = getattr(daemon, "breaker", None)
        if breaker is None:
            from tpuprof_torch.serve.breaker import default_breaker
            breaker = default_breaker()
        self.breaker = breaker
        self.host = host
        self.port = int(self.httpd.server_address[1])
        self._thread: Optional[threading.Thread] = None
        self._advert: Optional[str] = None

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def start(self) -> "HttpEdge":
        self._thread = threading.Thread(
            target=self.httpd.serve_forever, daemon=True,
            name=f"tpuprof-http-{self.port}")
        self._thread.start()
        # advertise the endpoint next to the heartbeats: fleet-local
        # clients (and a CI harness, which binds port 0)
        # discover the edge from the spool instead of parsing stderr
        from tpuprof_torch.runtime import fleet as _fleet
        daemons = os.path.join(self.daemon.spool, "daemons")
        os.makedirs(daemons, exist_ok=True)
        self._advert = os.path.join(
            daemons, f"http.{self.daemon.daemon_id or 'edge'}")
        _fleet.atomic_write(self._advert, (self.url + "\n").encode())
        return self

    def stop_accepting(self) -> None:
        """Graceful-drain step 1: pull the spool advert (no
        new discovery) and close the listening socket, while every
        established connection keeps draining — in-flight answers are
        delivered, not torn."""
        if self._advert:
            try:
                os.unlink(self._advert)
            except OSError:
                pass
            self._advert = None
        self.httpd.stop_accepting()

    def client_gone(self, job_id: str) -> None:
        """The connection owed this job's answer dropped: cancel the
        job if no worker claimed it yet (the scheduler refuses once it
        is running, terminal, or carrying coalesced followers)."""
        self.daemon.scheduler.cancel(job_id)

    def close(self) -> None:
        if self._advert:
            try:
                os.unlink(self._advert)
            except OSError:
                pass
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=10)

    # -- routing -----------------------------------------------------------

    def handle(self, method: str, path: str, body: Optional[bytes],
               headers, conn=None) -> Tuple:
        """(status, body, route-pattern[, extra-headers]) for one
        request.  ``body`` as bytes passes through verbatim (the
        /metrics exposition, pre-serialized conditional answers);
        anything else is JSON-encoded by the transport.  The optional
        fourth element is a header dict (ETag, provenance, an
        overriding Content-Type).  ``conn`` is the transport's
        connection record when there is one — the disconnect-
        cancellation hook rides it."""
        path, _, query = path.partition("?")
        if method == "GET" and path == "/metrics":
            return (200,
                    _obs_metrics.registry().render_text().encode(),
                    "/metrics")
        if method == "GET" and path == "/v1/healthz":
            # unauthenticated like /metrics: a fleet balancer's probe
            # carries no tenant credential, and readiness leaks nothing
            # a scrape of /metrics does not already say
            return self._healthz()
        if not path.startswith("/v1/"):
            return 404, {"error": f"no route {path!r}"}, "other"
        tenant = None
        if self.tokens is not None:
            auth = headers.get("Authorization") or ""
            token = auth[len("Bearer "):] if auth.startswith("Bearer ") \
                else None
            tenant = self.tokens.get(token) if token else None
            if tenant is None:
                # unknown and missing tokens answer identically: an
                # auth probe learns nothing about which tokens exist
                return (401, {"error": "missing or unknown bearer "
                                       "token"}, "auth")
        if method == "POST" and path == "/v1/jobs":
            return self._post_job(body, tenant, headers, conn)
        if method == "POST" and path == "/v1/query":
            return self._post_query(body, tenant, headers, conn)
        if method == "GET":
            m = re.match(r"^/v1/jobs/([^/]+)$", path)
            if m:
                return self._get_job(m.group(1))
            m = re.match(r"^/v1/results/([^/]+)$", path)
            if m:
                return self._get_result(m.group(1), headers)
            m = re.match(r"^/v1/watch/([^/]+)/alerts$", path)
            if m:
                return self._get_alerts(m.group(1))
            m = re.match(r"^/v1/history/([^/]+)$", path)
            if m:
                return self._get_history(m.group(1), query, headers)
        return 404, {"error": f"no route {method} {path!r}"}, "other"

    @staticmethod
    def _conditional(doc: Dict[str, Any], route: str, headers,
                     extra: Optional[Dict[str, str]] = None) -> Tuple:
        """Shared conditional-request wrapper:
        serialize the answer canonically, stamp its strong CRC ETag,
        and honor ``If-None-Match`` with a bodyless 304 — the client
        re-validates an unchanged result for ~60 header bytes instead
        of a full re-serialized document."""
        from tpuprof_torch.serve.cache import canonical_body, etag_for
        payload = canonical_body(doc)
        etag = etag_for(payload)
        hdrs = {"ETag": etag, "Content-Type": "application/json"}
        hdrs.update(extra or {})
        inm = (headers.get("If-None-Match") or "") if headers else ""
        if inm and (inm.strip() == "*"
                    or etag in [t.strip() for t in inm.split(",")]):
            return 304, b"", route, hdrs
        return 200, payload, route, hdrs

    def _healthz(self) -> Tuple[int, Any, str]:
        """Daemon readiness + the store's prewarm progress: 200
        only when this daemon would answer a job at warm-class
        latency.  A fleet balancer holds traffic on the 503s —
        ``draining`` (graceful stop in progress, the QueueClosed
        semantic) or ``warming`` (the restart prewarm still adopting
        its top-K runner keys' kernel libraries; the body carries keys loaded/pending so
        dashboards can show progress).  Jobs are ACCEPTED in every
        state short of draining — warming only means the first ones
        may pay a load."""
        route = "/v1/healthz"
        daemon = self.daemon
        prewarmer = getattr(daemon, "prewarmer", None)
        prewarm = prewarmer.status() if prewarmer is not None else None
        body: Dict[str, Any] = {
            "daemon": daemon.daemon_id,
            "aot_cache_dir": getattr(daemon, "aot_cache_dir", None),
            "prewarm": prewarm,
        }
        sched = daemon.scheduler
        with sched._lock:
            body["active"] = len(sched._active)
            # read-tier health: balancers and
            # dashboards see cache size/hit-rate and the exactly-once
            # ledger (computed vs coalesced) next to warming state
            body["computed"] = sched._computed
            body["coalesced"] = sched._coalesced
            # overload ledger: submitted = terminal counts + live jobs
            # (nothing lost, nothing double-computed)
            # (nothing lost, nothing double-computed)
            body["requests"] = sched._submitted
            body["counts"] = dict(sched._counts)
            body["shed"] = sched._shed
            body["deadline_expired"] = sched._deadline_expired
            body["cancelled"] = sched._cancelled
            body["released"] = sched._released
        body["serve_backlog"] = sched.serve_backlog
        body["queued"] = len(sched._queue)
        body["connections"] = len(self.httpd._conns)
        body["breaker"] = self.breaker.snapshot() \
            if self.breaker is not None else None
        rc = getattr(sched, "read_cache", None)
        body["read_cache"] = rc.stats() if rc is not None else None
        body["draining"] = daemon.stop_event.is_set()
        if body["draining"]:
            body["status"] = "draining"
            return 503, body, route
        if prewarm is not None and not prewarm["done"]:
            body["status"] = "warming"
            return 503, body, route
        body["status"] = "ready"
        return 200, body, route

    def _post_job(self, body: Optional[bytes],
                  auth_tenant: Optional[str], headers=None,
                  conn=None) -> Tuple[int, Any, str]:
        route = "/v1/jobs"
        # a corrupt request body is the CLIENT's failure: 400 with the
        # parse error, never a daemon crash, never a spooled job
        if body is None:
            return (400, {"error": "missing or oversized request body "
                                   f"(cap {self.httpd.max_body_bytes} "
                                   "bytes)"},
                    route)
        try:
            req = json.loads(body)
        except ValueError as exc:
            return (400, {"error": f"request body is not JSON "
                                   f"({exc})"}, route)
        if not isinstance(req, dict):
            return (400, {"error": "request body must be a JSON "
                                   "object"}, route)
        if req.get("schema") not in (None, JOB_SCHEMA):
            return (400, {"error": f"job schema {req.get('schema')!r} "
                                   f"is not {JOB_SCHEMA}"}, route)
        source = req.get("source")
        if not isinstance(source, str) or not source:
            return 400, {"error": "job needs a 'source' path"}, route
        config = req.get("config")
        if config is not None and not isinstance(config, dict):
            return (400, {"error": "'config' must be a JSON object of "
                                   "ProfilerConfig kwargs"}, route)
        for key in ("output", "stats_json", "artifact", "tenant"):
            v = req.get(key)
            if v is not None and not isinstance(v, str):
                return 400, {"error": f"{key!r} must be a string"}, route
        # identity comes from the credential when auth is on — a body
        # naming someone else's tenant is billing fraud, not a knob
        tenant = auth_tenant if auth_tenant is not None \
            else (req.get("tenant") or "default")
        # client deadline: the header is a RELATIVE budget
        # ("answer within N ms of receipt"); the body field is the
        # absolute wire form (deadline_unix_ms) a spool forwarder
        # carries.  The header wins — it is what THIS client asked.
        deadline_unix = None
        hdr = headers.get("X-Tpuprof-Deadline-Ms") if headers else None
        if hdr is not None:
            try:
                ms = int(hdr)
                if ms < 1:
                    raise ValueError
            except (TypeError, ValueError):
                return (400, {"error": "X-Tpuprof-Deadline-Ms must be "
                                       "a positive integer millisecond "
                                       f"budget, got {hdr!r}"}, route)
            deadline_unix = time.time() + ms / 1000.0
        elif req.get("deadline_unix_ms") is not None:
            try:
                deadline_unix = int(req["deadline_unix_ms"]) / 1000.0
            except (TypeError, ValueError):
                return (400, {"error": "'deadline_unix_ms' must be an "
                                       "integer epoch-millisecond "
                                       "deadline"}, route)
        job = self.daemon.submit_local(
            source, output=req.get("output"), tenant=tenant,
            stats_json=req.get("stats_json"),
            artifact=req.get("artifact"), config_kwargs=config,
            deadline_unix=deadline_unix)
        if job.state == "rejected":
            # the scheduler's admission hook decides the status class:
            # resource pressure (full queue / tenant over quota) is
            # 429 retry-later WITH the scheduler's reject reason; a
            # draining daemon is 503; a backlog shed is 503
            # WITH a jittered Retry-After sized to the observed drain
            # rate; a bad config is the request's own fault (400)
            wire = dict(job.to_wire())
            wire["schema"] = RESULT_SCHEMA
            if job.reject_kind == "BacklogFull":
                retry = self.daemon.scheduler.retry_after_s()
                return (503, wire, route,
                        {"Retry-After": f"{retry:g}"})
            if job.reject_kind in ("QueueFull", "TenantQuotaExceeded"):
                code = 429
            elif job.reject_kind == "QueueClosed":
                code = 503
            else:
                code = 400
            return code, wire, route
        if conn is not None:
            # owe this connection the 202: a disconnect before it is
            # written cancels the job if still unclaimed
            conn.pending_job = job.id
        return (202, {"schema": JOB_SCHEMA, "id": job.id,
                      "tenant": job.tenant, "status": job.state},
                route)

    def _get_job(self, jid: str) -> Tuple[int, Any, str]:
        route = "/v1/jobs/<id>"
        if not _ID_RE.match(jid):
            return 400, {"error": f"malformed job id {jid!r}"}, route
        job = self.daemon.scheduler.job(jid)
        if job is not None:
            return 200, dict(job.to_wire()), route
        try:
            res = read_result(self.daemon.spool, jid)
        except CorruptResultError as exc:
            return 500, {"error": f"{type(exc).__name__}: {exc}"}, route
        if res is not None:
            return 200, res, route
        if os.path.exists(os.path.join(self.daemon.dirs["jobs"],
                                       f"{jid}.json")):
            # spooled but not ours: queued on (or stealable from) a
            # fleet peer — the edge answers for the whole fleet
            return 200, {"id": jid, "status": "queued"}, route
        return 404, {"error": f"unknown job {jid!r}"}, route

    def _get_result(self, jid: str, headers=None) -> Tuple:
        route = "/v1/results/<id>"
        if not _ID_RE.match(jid):
            return 400, {"error": f"malformed job id {jid!r}"}, route
        try:
            res = read_result(self.daemon.spool, jid)
        except CorruptResultError as exc:
            # server-side rot: the poller's re-poll contract applies
            # (the writer may still atomically replace it), so answer
            # 500 with the typed name and let the client keep polling
            return 500, {"error": f"{type(exc).__name__}: {exc}"}, route
        if res is not None:
            # terminal records are immutable, so the CRC ETag is a
            # permanent validator: a re-poll with If-None-Match costs
            # a 304, not a re-read + re-serialize
            return self._conditional(res, route, headers)
        if jid in self.daemon.scheduler._jobs \
                or os.path.exists(os.path.join(self.daemon.dirs["jobs"],
                                               f"{jid}.json")):
            return 202, {"id": jid, "status": "pending"}, route
        return 404, {"error": f"unknown job {jid!r}"}, route

    def _get_alerts(self, key: str) -> Tuple[int, Any, str]:
        route = "/v1/watch/<key>/alerts"
        # the key names a directory: the charset check plus the
        # dots-only rejection ("..") keeps reads inside SPOOL/watch/
        if not _ID_RE.match(key) or set(key) <= {"."}:
            return 400, {"error": f"malformed watch key {key!r}"}, route
        path = os.path.join(self.daemon.spool, "watch", key,
                            "alerts.json")
        try:
            with open(path, "rb") as fh:
                data = fh.read()
        except OSError:
            return (404, {"error": f"no alert feed for watch key "
                                   f"{key!r}"}, route)
        # the feed is written atomically (watch.py _atomic_write) and
        # is already JSON — stream the bytes; no parse, no copy drift
        return 200, data or b"[]", route

    def _get_history(self, key: str, query: str,
                     headers=None) -> Tuple:
        """The warehouse history feed off the edge:
        ``GET /v1/history/<key>?col=price&stat=mean`` answers the stat
        series, ``?trend=1[&col=price]`` the PSI/KS-over-time series —
        both the same ``tpuprof-history-v1`` document `tpuprof history`
        prints, read from the spool's warehouse the watch loop feeds.
        Answers carry the shared CRC ETag and honor If-None-Match
        (an unchanged warehouse re-poll costs a 304)."""
        from urllib.parse import parse_qs
        route = "/v1/history/<key>"
        if not _ID_RE.match(key) or set(key) <= {"."}:
            return (400, {"error": f"malformed warehouse key {key!r}"},
                    route)
        params = parse_qs(query or "")

        def one(name, default=None):
            vals = params.get(name)
            return vals[0] if vals else default

        dirpath = os.path.join(self.daemon.spool, "warehouse", key)
        if not os.path.isdir(dirpath):
            return (404, {"error": f"no warehouse history for key "
                                   f"{key!r}"}, route)
        from tpuprof_torch.errors import (CorruptWarehouseError, InputError,
                                    WarehouseUnavailableError)
        from tpuprof_torch.warehouse import query_stat, query_trend
        try:
            if one("trend") in ("1", "true", "yes"):
                doc = query_trend(dirpath, col=one("col"))
            else:
                col = one("col")
                if not col:
                    return (400, {"error": "history needs ?col=<name> "
                                          "(or ?trend=1)"}, route)
                doc = query_stat(dirpath, col, one("stat", "mean"))
        except InputError as exc:
            return 404, {"error": str(exc)}, route
        except WarehouseUnavailableError as exc:
            # the daemon's own environment lacks pyarrow: the edge is
            # honest about it — 501 "not implemented here", not a 500
            return 501, {"error": str(exc)}, route
        except CorruptWarehouseError as exc:
            return 500, {"error": f"{type(exc).__name__}: {exc}"}, route
        return self._conditional(doc, route, headers)

    # -- query pushdown -----------------------------------------------------

    def _post_query(self, body: Optional[bytes],
                    auth_tenant: Optional[str], headers,
                    conn=None) -> Tuple:
        """``POST /v1/query {source, cols, stats}``: answer column
        statistics from the CHEAPEST tier that is still correct —

        1. **cache**: the edge result cache holds this exact answer
           (byte-identical repeat, sub-millisecond, no I/O);
        2. **warehouse**: the newest readable warehouse generation
           post-dates the source — a column-pruned Parquet read (only
           the requested stat chunks materialize; no launch);
        3. **computed**: the source is stale/absent in the warehouse —
           a NARROW profile (``columns=cols``, the column-subset
           path) runs through the ordinary scheduler admission.

        The serving tier rides the ``X-Tpuprof-Provenance`` header (so
        a cache hit stays byte-identical to the answer it cached,
        whose body names the tier that COMPUTED it)."""
        route = "/v1/query"
        t0 = time.perf_counter()
        if body is None:
            return (400, {"error": "missing or oversized request body "
                                   f"(cap {self.httpd.max_body_bytes} "
                                   "bytes)"},
                    route)
        try:
            req = json.loads(body)
        except ValueError as exc:
            return (400, {"error": f"request body is not JSON "
                                   f"({exc})"}, route)
        if not isinstance(req, dict):
            return (400, {"error": "request body must be a JSON "
                                   "object"}, route)
        source = req.get("source")
        if not isinstance(source, str) or not source:
            return 400, {"error": "query needs a 'source' path"}, route
        cols = req.get("cols")
        if not isinstance(cols, list) or not cols \
                or not all(isinstance(c, str) for c in cols):
            return (400, {"error": "'cols' must be a non-empty list "
                                   "of column names"}, route)
        stats = req.get("stats") or ["mean"]
        if not isinstance(stats, list) \
                or not all(isinstance(s, str) for s in stats):
            return (400, {"error": "'stats' must be a list of stat "
                                   "names"}, route)
        config = req.get("config")
        if config is not None and not isinstance(config, dict):
            return (400, {"error": "'config' must be a JSON object of "
                                   "ProfilerConfig kwargs"}, route)
        tenant = auth_tenant if auth_tenant is not None \
            else (req.get("tenant") or "default")
        source = os.path.abspath(source)

        sched = self.daemon.scheduler
        rc = getattr(sched, "read_cache", None)
        key = None
        if rc is not None:
            from tpuprof_torch.serve.cache import source_fingerprint
            key = ("query", source_fingerprint(source), tuple(cols),
                   tuple(stats),
                   json.dumps(config or {}, sort_keys=True))
            hit = rc.get(key)
            if hit is not None:
                payload, etag = hit
                return self._query_response(
                    payload, etag, "cache", route, headers,
                    source, cols, stats, t0)

        # warehouse tier: the newest readable generation, column-pruned
        # — gated by the per-source circuit breaker: a
        # source whose generations keep reading corrupt pays the
        # corrupt-walk disk tax ONCE per cooldown, not per query
        from tpuprof_torch.errors import WarehouseUnavailableError
        from tpuprof_torch.warehouse import store as _store
        from tpuprof_torch.warehouse.history import query_columns
        dirpath = _store.source_dir(
            os.path.join(self.daemon.spool, "warehouse"), source)
        breaker = self.breaker
        breaker_open = breaker is not None \
            and not breaker.allow(source)
        gen_doc = None
        corrupt_reads: list = []
        if not breaker_open:
            try:
                gen_doc = query_columns(
                    dirpath, cols, stats,
                    on_corrupt=(
                        lambda path, exc:
                        (corrupt_reads.append(path),
                         breaker.record_failure(source))
                        if breaker is not None
                        else corrupt_reads.append(path)))
            except WarehouseUnavailableError:
                gen_doc = None      # no pyarrow here: compute answers
                                    # (environment, not rot — the
                                    # breaker does not count it)
            if breaker is not None and gen_doc is not None \
                    and not corrupt_reads:
                # a clean walk (no corrupt skips) is the probe/success
                # signal that closes a half-open breaker
                breaker.record_success(source)
        fresh = False
        if gen_doc is not None and not gen_doc["missing"]:
            created = gen_doc.get("created_unix")
            try:
                fresh = created is not None \
                    and created >= os.stat(source).st_mtime
            except OSError:
                # the source is gone: the warehouse is all there is,
                # and "stale" has nothing fresher to defer to
                fresh = True
        if fresh:
            doc = {"schema": QUERY_SCHEMA, "source": source,
                   "provenance": "warehouse",
                   "generation": gen_doc["generation"],
                   "rows": gen_doc.get("rows"),
                   "columns": gen_doc["columns"]}
            return self._query_answer(doc, key, rc, route, headers,
                                      cols, stats, t0)

        # computed tier: a NARROW profile — only the requested columns
        # run on the card (K1 and K2 over the subset, through columns=)
        from tpuprof_torch.serve.jobs import Job, new_job_id
        jid = new_job_id()
        tmp_stats = os.path.join(self.daemon.dirs["tmp"],
                                 f".query.{jid}.json")
        kwargs = dict(config or {})
        kwargs["columns"] = list(cols)
        job = sched.submit(Job(source=source, tenant=tenant,
                               job_id=jid, stats_json=tmp_stats,
                               config_kwargs=kwargs))
        if job.state == "rejected":
            wire = dict(job.to_wire())
            wire["schema"] = RESULT_SCHEMA
            if job.reject_kind == "BacklogFull":
                retry = sched.retry_after_s()
                return (503, wire, route,
                        {"Retry-After": f"{retry:g}"})
            if job.reject_kind in ("QueueFull", "TenantQuotaExceeded"):
                code = 429
            elif job.reject_kind == "QueueClosed":
                code = 503
            else:
                code = 400
            return code, wire, route
        if conn is not None:
            # this handler blocks on the answer: a client that
            # disconnects mid-wait cancels the job if no worker
            # claimed it yet
            conn.pending_job = job.id
        try:
            sched.wait(job, timeout=3600)
        except TimeoutError:
            return (504, {"error": f"query profile {job.id} still "
                                   f"{job.state} after 3600s"}, route)
        finally:
            if conn is not None:
                conn.pending_job = None
        if job.state != "done":
            code = 400 if job.exit_code == 2 else 500
            return (code, {"error": job.error,
                           "exit_code": job.exit_code}, route)
        try:
            with open(tmp_stats) as fh:
                stats_doc = json.load(fh)
        except (OSError, ValueError) as exc:
            return (500, {"error": f"query stats unreadable: "
                                   f"{type(exc).__name__}: {exc}"},
                    route)
        finally:
            try:
                os.unlink(tmp_stats)
            except OSError:
                pass
        variables = stats_doc.get("variables") or {}
        columns: Dict[str, Any] = {}
        for col in cols:
            var = variables.get(col) or {}
            columns[col] = {s: var.get(s) for s in stats}
        doc = {"schema": QUERY_SCHEMA, "source": source,
               # "breaker_open": computed BECAUSE the warehouse is
               # tripped for this source — operators see the detour
               "provenance": ("breaker_open" if breaker_open
                              else "computed"),
               "generation": None,
               "rows": job.result.get("rows"), "columns": columns}
        return self._query_answer(doc, key, rc, route, headers,
                                  cols, stats, t0)

    def _query_answer(self, doc: Dict[str, Any], key, rc, route: str,
                      headers, cols, stats, t0: float) -> Tuple:
        """Publish a freshly produced query answer to the result cache
        (repeats then serve byte-identically from tier 1) and frame
        the response."""
        from tpuprof_torch.serve.cache import canonical_body, etag_for
        payload = canonical_body(doc)
        etag = etag_for(payload)
        if rc is not None and key is not None:
            rc.put(key, doc)
        return self._query_response(payload, etag, doc["provenance"],
                                    route, headers, doc["source"],
                                    cols, stats, t0)

    def _query_response(self, payload: bytes, etag: str, tier: str,
                        route: str, headers, source, cols, stats,
                        t0: float) -> Tuple:
        _PUSHDOWN.inc(tier=tier)
        if _obs_metrics.enabled():
            _obs_events.emit("query_pushdown", source=str(source),
                             provenance=tier, cols=len(cols),
                             stats=len(stats),
                             seconds=round(time.perf_counter() - t0, 4))
        hdrs = {"ETag": etag, "Content-Type": "application/json",
                "X-Tpuprof-Provenance": tier}
        inm = (headers.get("If-None-Match") or "") if headers else ""
        if inm and etag in [t.strip() for t in inm.split(",")]:
            return 304, b"", route, hdrs
        return 200, payload, route, hdrs


# ---------------------------------------------------------------------------
# client side (``submit --url``)
# ---------------------------------------------------------------------------

def _request(url: str, method: str = "GET",
             payload: Optional[Dict[str, Any]] = None,
             token: Optional[str] = None,
             timeout: float = 30.0,
             extra_headers: Optional[Dict[str, str]] = None
             ) -> Tuple[int, Dict[str, Any]]:
    """One HTTP exchange -> (status, decoded JSON body).  An HTTP
    error status is a NORMAL return (the daemon answered); only
    failing to reach the daemon at all raises, and it raises the typed
    :class:`ServeUnavailableError` automation can branch on."""
    import urllib.error
    import urllib.request
    data = None
    headers = {"Accept": "application/json"}
    if payload is not None:
        data = json.dumps(payload).encode()
        headers["Content-Type"] = "application/json"
    if token:
        headers["Authorization"] = f"Bearer {token}"
    headers.update(extra_headers or {})
    req = urllib.request.Request(url, data=data, headers=headers,
                                 method=method)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            raw = resp.read()
            status = resp.status
    except urllib.error.HTTPError as exc:
        raw = exc.read()
        status = exc.code
    except (urllib.error.URLError, OSError) as exc:
        reason = getattr(exc, "reason", exc)
        raise ServeUnavailableError(
            f"cannot reach tpuprof serve at {url}: {reason} — is the "
            "daemon running with --http?") from exc
    try:
        doc = json.loads(raw) if raw else {}
    except ValueError:
        doc = {"error": raw.decode("utf-8", "replace")[:500]}
    if not isinstance(doc, dict):
        doc = {"body": doc}
    return status, doc


def submit_job(base_url: str, source: str, output: Optional[str] = None,
               tenant: Optional[str] = None,
               stats_json: Optional[str] = None,
               artifact: Optional[str] = None,
               config_kwargs: Optional[Dict[str, Any]] = None,
               token: Optional[str] = None,
               timeout: float = 30.0,
               deadline_ms: Optional[int] = None
               ) -> Tuple[int, Dict[str, Any]]:
    """POST one job to an HTTP edge.  Paths resolve to absolute
    client-side, exactly like the spool transport's ``write_job`` —
    the daemon's cwd is not the client's (the edge and its clients
    share storage the way spool clients do).  ``deadline_ms`` rides
    the ``X-Tpuprof-Deadline-Ms`` header: a relative
    answer-within budget the daemon enforces — a job still queued past
    it is never started and fails typed (exit code 11)."""
    payload: Dict[str, Any] = {
        "schema": JOB_SCHEMA,
        "source": os.path.abspath(source),
        "output": os.path.abspath(output) if output else None,
        "stats_json": os.path.abspath(stats_json) if stats_json else None,
        "artifact": os.path.abspath(artifact) if artifact else None,
        "config": dict(config_kwargs or {}),
    }
    if tenant is not None:
        payload["tenant"] = str(tenant)
    extra = {"X-Tpuprof-Deadline-Ms": str(int(deadline_ms))} \
        if deadline_ms is not None else None
    return _request(base_url.rstrip("/") + "/v1/jobs", method="POST",
                    payload=payload, token=token, timeout=timeout,
                    extra_headers=extra)


def wait_result_http(base_url: str, job_id: str,
                     timeout: Optional[float] = None,
                     poll_interval: float = 0.1,
                     token: Optional[str] = None) -> Dict[str, Any]:
    """Poll ``GET /v1/results/<id>`` until the terminal record lands —
    the HTTP twin of the spool's ``wait_result``, sharing its jittered
    exponential backoff and its corrupt-record
    contract: a 500 naming ``CorruptResultError`` is re-polled and
    surfaces TYPED at the deadline."""
    deadline = None if timeout is None else time.monotonic() + timeout
    backoff = poll_intervals(poll_interval)
    corrupt: Optional[CorruptResultError] = None
    url = f"{base_url.rstrip('/')}/v1/results/{job_id}"
    while True:
        status, doc = _request(url, token=token)
        if status == 200:
            return doc
        if status == 401:
            raise InputError(
                f"result poll for job {job_id} rejected: "
                f"{doc.get('error', 'unauthorized')}")
        corrupt = CorruptResultError(doc.get("error") or "corrupt") \
            if status == 500 and "CorruptResultError" in \
            str(doc.get("error")) else None
        if deadline is not None and time.monotonic() > deadline:
            if corrupt is not None:
                raise corrupt
            raise TimeoutError(
                f"no result for job {job_id} after {timeout}s at "
                f"{base_url} — the job may still be running "
                "server-side")
        sleep = next(backoff)
        if deadline is not None:
            sleep = min(sleep, max(deadline - time.monotonic(), 0.0)
                        + 0.001)
        time.sleep(sleep)


def discover_edges(spool: str) -> Dict[str, str]:
    """{daemon_id: url} from the spool's endpoint advertisements —
    how a CI harness (and fleet-local tooling) finds ephemeral-
    port edges without parsing daemon stderr."""
    daemons = os.path.join(spool, "daemons")
    out: Dict[str, str] = {}
    try:
        names = os.listdir(daemons)
    except OSError:
        return out
    for name in names:
        if not name.startswith("http.") or name.startswith(".tmp."):
            continue
        try:
            with open(os.path.join(daemons, name),
                      encoding="utf-8") as fh:
                url = fh.read().strip()
        except OSError:
            continue
        if url:
            out[name[len("http."):]] = url
    return out
