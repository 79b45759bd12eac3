"""The port's serve daemon over a spool directory, and the submit client.

Counterpart of ``tpuprof/serve/server.py``, with the reference's wire byte
for byte in schema (``JOB_SCHEMA``, ``RESULT_SCHEMA``): a job file that the
reference's ``write_job`` drops is answered here, and the reference's
``read_result`` reads the answer.  Transport is a spool DIRECTORY, not a
socket: one resident daemon per host holding the card, clients on the same
host (or shared storage) handing it work; requests and results are JSON
files written atomically (tmp + rename), so a crashed client or daemon
never leaves a torn message.

Layout under the spool dir::

    jobs/<id>.json      one request (tpuprof-serve-job-v1), written
                        atomically by ``submit``
    results/<id>.json   the terminal record (tpuprof-serve-result-v1),
                        written atomically by the daemon; the request
                        file is unlinked after the result lands, so a
                        restarted daemon re-runs only jobs with no result
    tmp/                atomic-write staging
    claims/             multi-daemon job claims (claim mode only):
                        <id>.claim owned-by content, <id>.steal.<g>
                        generation-g takeovers — runtime/fleet.py's
                        arbiters applied to whole jobs
    daemons/            one mtime heartbeat (hb.<daemon-id>) per live
                        daemon
    aot/                the store of built kernel libraries the serve verb
                        defaults to (runtime/aot.py)

**Fleet mode** (``claim_jobs=True``, ``serve --claim-jobs``): N daemons
share ONE spool.  Exactly one daemon runs each job — the atomic-create
claim is the only arbiter; a dead daemon's heartbeat goes stale and the
survivors steal its claimed-but-unanswered jobs at the next steal
generation.  Results stay exactly-once per id: they are keyed files
written atomically, and every ingest path skips a job whose result landed.

The daemon is a thin shell: scanning the spool and writing results; the
job lifecycle lives in ``serve/scheduler.py``.
"""

from __future__ import annotations

import json
import os
import random
import threading
import time
from typing import Any, Dict, Iterator, Optional

from tpuprof_torch.obs import events as _obs_events
from tpuprof_torch.obs import metrics as _obs_metrics
from tpuprof_torch.runtime import fleet as _fleet
from tpuprof_torch.serve.jobs import TERMINAL, Job, new_job_id
from tpuprof_torch.serve.scheduler import ProfileScheduler

JOB_SCHEMA = "tpuprof-serve-job-v1"
RESULT_SCHEMA = "tpuprof-serve-result-v1"

_CLAIMED = _obs_metrics.gauge(
    "tpuprof_serve_jobs_claimed",
    "spool jobs this daemon has claimed and not yet answered, by "
    "daemon id (fleet mode)")
_STOLEN = _obs_metrics.counter(
    "tpuprof_serve_jobs_stolen_total",
    "spool jobs taken over from dead fleet daemons, by daemon id")
_DRAIN_SECONDS = _obs_metrics.histogram(
    "tpuprof_serve_drain_seconds",
    "graceful-drain duration (stop signal -> daemon closed): in-flight "
    "jobs finished, unstarted claims released to fleet peers, results "
    "flushed")


def poll_intervals(initial: float = 0.1, cap: float = 2.0,
                   factor: float = 2.0,
                   jitter: float = 0.25) -> Iterator[float]:
    """Jittered exponential backoff for result polling
    (:func:`wait_result`).  Yields sleep durations starting at ``initial``,
    doubling to ``cap``, each scattered by ±``jitter`` so a burst of
    waiting clients never polls in lockstep against one daemon (the
    fixed 0.1 s busy-poll this replaced hammered shared-storage spools
    with N synchronized stat calls per second per client)."""
    delay = max(float(initial), 0.001)
    cap = max(float(cap), delay)
    while True:
        yield delay * (1.0 + random.uniform(-jitter, jitter))
        delay = min(delay * factor, cap)


def _spool_dirs(spool: str) -> Dict[str, str]:
    dirs = {name: os.path.join(spool, name)
            for name in ("jobs", "results", "tmp")}
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)
    return dirs


def _atomic_write_json(dirs: Dict[str, str], path: str,
                       payload: Dict[str, Any]) -> None:
    tmp = os.path.join(dirs["tmp"],
                       f".{os.path.basename(path)}.{os.getpid()}")
    with open(tmp, "w") as fh:
        json.dump(payload, fh, indent=1, default=str)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)


# ---------------------------------------------------------------------------
# client side (`tpuprof submit`)
# ---------------------------------------------------------------------------

def write_job(spool: str, source: str, output: Optional[str] = None,
              tenant: str = "default",
              stats_json: Optional[str] = None,
              artifact: Optional[str] = None,
              config_kwargs: Optional[Dict[str, Any]] = None,
              job_id: Optional[str] = None,
              deadline_unix_ms: Optional[int] = None) -> str:
    """Drop one request into the spool; returns the job id.  Paths in
    the request are resolved to absolute here — the daemon's cwd is not
    the client's.  ``deadline_unix_ms`` (absolute epoch milliseconds —
    relative budgets resolve client-side, where "now" is the submit
    instant) rides the wire so whichever daemon ingests the job —
    including a fleet peer that steals it — enforces the same cutoff."""
    dirs = _spool_dirs(spool)
    jid = job_id or new_job_id()
    payload = {
        "schema": JOB_SCHEMA, "id": jid, "tenant": str(tenant),
        "source": os.path.abspath(source),
        "output": os.path.abspath(output) if output else None,
        "stats_json": os.path.abspath(stats_json) if stats_json else None,
        "artifact": os.path.abspath(artifact) if artifact else None,
        "config": dict(config_kwargs or {}),
    }
    if deadline_unix_ms is not None:
        payload["deadline_unix_ms"] = int(deadline_unix_ms)
    _atomic_write_json(dirs, os.path.join(dirs["jobs"], f"{jid}.json"),
                       payload)
    return jid


def read_result(spool: str, job_id: str) -> Optional[Dict[str, Any]]:
    """One result read: the record dict, None when it has not landed
    yet, or a typed :class:`~tpuprof_torch.errors.CorruptResultError` when a
    file EXISTS but does not parse — never a raw ``JSONDecodeError``
    (the daemon writes atomically, so a torn record means a non-atomic
    filesystem crash or on-disk rot, which the caller must be able to
    tell apart from "the daemon has not answered")."""
    from tpuprof_torch.errors import CorruptResultError
    path = os.path.join(spool, "results", f"{job_id}.json")
    try:
        with open(path, "rb") as fh:
            data = fh.read()
    except OSError:
        return None                     # not answered yet
    try:
        doc = json.loads(data)
    except ValueError as exc:
        raise CorruptResultError(
            f"result file {path!r} is torn or corrupt "
            f"({type(exc).__name__}: {exc})") from exc
    if not isinstance(doc, dict):
        raise CorruptResultError(
            f"result file {path!r} decodes to {type(doc).__name__}, "
            "not a result record")
    return doc


def wait_result(spool: str, job_id: str, timeout: Optional[float] = None,
                poll_interval: float = 0.1) -> Dict[str, Any]:
    """Poll the results dir until the job's terminal record lands.

    ``poll_interval`` seeds a jittered exponential backoff
    (:func:`poll_intervals`): tight while a warm answer is plausible,
    backing off to a capped cadence for the long waits, never past the
    deadline.  A torn result file is re-polled, not fatal — on a
    non-atomic filesystem the writer's rename may still land a whole
    record — but at the deadline the typed :class:`CorruptResultError`
    surfaces instead of a misleading "is the daemon running?"
    timeout."""
    from tpuprof_torch.errors import CorruptResultError
    deadline = None if timeout is None else time.monotonic() + timeout
    corrupt: Optional[CorruptResultError] = None
    backoff = poll_intervals(poll_interval)
    while True:
        try:
            res = read_result(spool, job_id)
            corrupt = None
        except CorruptResultError as exc:
            res, corrupt = None, exc
        if res is not None:
            return res
        if deadline is not None and time.monotonic() > deadline:
            if corrupt is not None:
                raise corrupt
            raise TimeoutError(
                f"no result for job {job_id} after {timeout}s — is "
                f"`tpuprof serve {spool}` running?")
        sleep = next(backoff)
        if deadline is not None:
            # land ON the deadline, not one full backoff past it
            sleep = min(sleep, max(deadline - time.monotonic(), 0.0)
                        + 0.001)
        time.sleep(sleep)


# ---------------------------------------------------------------------------
# daemon side (`tpuprof serve`)
# ---------------------------------------------------------------------------

class ServeDaemon:
    """Spool watcher around a :class:`ProfileScheduler`.

    With ``claim_jobs=True`` the daemon is one member of a serve
    fleet: it heartbeats under ``daemons/hb.<daemon_id>``, ingests
    only the spool jobs it wins the atomic claim for, and steals a
    dead peer's claimed-but-unanswered jobs once the peer's heartbeat
    goes stale (``liveness_timeout_s``).  The default (False) is the
    historical single-daemon spool, byte-path untouched."""

    def __init__(self, spool: str,
                 scheduler: Optional[ProfileScheduler] = None,
                 poll_interval: float = 0.2,
                 claim_jobs: bool = False,
                 daemon_id: Optional[str] = None,
                 liveness_timeout_s: Optional[float] = None,
                 drain_timeout_s: Optional[float] = None,
                 aot_cache_dir: Optional[str] = None,
                 aot_cache: Optional[str] = None,
                 aot_prewarm: Optional[int] = None,
                 **scheduler_kwargs):
        self.spool = spool
        self.dirs = _spool_dirs(spool)
        self.poll_interval = max(float(poll_interval), 0.01)
        # graceful-drain budget: how long close() lets in-flight jobs
        # finish before giving up the wait — the SIGTERM-to-exit bound
        # the serve verb promises its operator
        from tpuprof_torch.config import resolve_serve_drain_timeout
        self.drain_timeout_s = resolve_serve_drain_timeout(
            drain_timeout_s)
        # the store of built kernel libraries (runtime/aot.py): the
        # daemon's restart-to-warm store.  The CLI defaults it to
        # SPOOL/aot; library embeddings opt in by passing a dir (or the
        # env twin)
        from tpuprof_torch.config import (resolve_aot_cache,
                                          resolve_aot_cache_dir,
                                          resolve_aot_prewarm)
        self.aot_cache_dir = None
        if resolve_aot_cache(aot_cache) == "on":
            self.aot_cache_dir = resolve_aot_cache_dir(aot_cache_dir)
        if scheduler is None and self.aot_cache_dir:
            scheduler_kwargs.setdefault("aot_cache_dir",
                                        self.aot_cache_dir)
        self.scheduler = scheduler if scheduler is not None \
            else ProfileScheduler(**scheduler_kwargs)
        # restart prewarm: adopt and warm the manifest's hottest runner
        # keys in the background while the poll loop below already
        # takes jobs
        self.prewarmer = None
        if self.aot_cache_dir:
            from tpuprof_torch.runtime import aot as _aot
            self.prewarmer = _aot.Prewarmer(
                self.aot_cache_dir, resolve_aot_prewarm(aot_prewarm),
                device=self.scheduler.device).start()
        self._pending: Dict[str, Job] = {}   # submitted, result not yet out
        self._seen: set = set()
        self.stop_event = threading.Event()
        self.claim_jobs = bool(claim_jobs)
        self.daemon_id = None
        self._hb_thread = None
        if self.claim_jobs:
            from tpuprof_torch.config import (resolve_fleet_host_id,
                                              resolve_liveness_timeout)
            self.daemon_id = resolve_fleet_host_id(daemon_id)
            if "/" in self.daemon_id:
                raise ValueError(
                    f"daemon_id {self.daemon_id!r} must be a plain "
                    "filename token (it names heartbeat/claim files)")
            self.liveness_timeout_s = \
                resolve_liveness_timeout(liveness_timeout_s)
            for name in ("claims", "daemons"):
                self.dirs[name] = os.path.join(spool, name)
                os.makedirs(self.dirs[name], exist_ok=True)
            # heartbeat BEFORE the first claim: a claim by a daemon
            # with no heartbeat file would read as instantly dead
            self._hb_path = os.path.join(self.dirs["daemons"],
                                         f"hb.{self.daemon_id}")
            _fleet.atomic_write(self._hb_path, b"alive\n")
            self._hb_thread = threading.Thread(
                target=self._beat, daemon=True,
                name=f"tpuprof-serve-hb-{self.daemon_id}")
            self._hb_thread.start()
            _obs_events.emit("serve_fleet_join", daemon=self.daemon_id,
                             spool=self.spool)

    # -- fleet membership (claim mode only) --------------------------------

    def _beat(self) -> None:
        # mtime refresh is the liveness signal, exactly the
        # runtime/fleet.py heartbeat contract; a SIGKILL stops the
        # refresh and the file goes stale, a graceful close() deletes
        # it so peers steal leftovers immediately
        interval = min(max(self.liveness_timeout_s / 4.0, 0.05), 2.0)
        while not self.stop_event.wait(interval):
            try:
                os.utime(self._hb_path)
            except OSError:
                try:
                    _fleet.atomic_write(self._hb_path, b"alive\n")
                except OSError:
                    pass

    def _daemon_alive(self, daemon_id: str) -> bool:
        try:
            mtime = os.path.getmtime(
                os.path.join(self.dirs["daemons"], f"hb.{daemon_id}"))
        except OSError:
            return False            # no heartbeat file = dead
        return time.time() - mtime < self.liveness_timeout_s

    def _scan_claims(self) -> Dict[str, tuple]:
        """One directory read -> {job_id: (generation, owner_path)};
        the owner's NAME is read lazily (only for jobs we might act
        on).  Generation 0 is the original claim, g >= 1 are steals —
        highest generation owns the job."""
        out: Dict[str, tuple] = {}
        try:
            names = os.listdir(self.dirs["claims"])
        except OSError:
            return out
        for name in names:
            if name.startswith("."):
                continue            # in-flight atomic-write temps
            if name.endswith(".claim"):
                jid, gen = name[: -len(".claim")], 0
            else:
                jid, _, g = name.rpartition(".steal.")
                if not jid or not g.isdigit():
                    continue
                gen = int(g)
            cur = out.get(jid)
            if cur is None or gen > cur[0]:
                out[jid] = (gen,
                            os.path.join(self.dirs["claims"], name))
        return out

    def _try_own(self, jid: str,
                 claims: Dict[str, tuple]) -> bool:
        """Claim-mode arbiter for one spooled job: True exactly when
        THIS daemon owns it now (fresh claim won, already ours from a
        restart, or stolen from a dead peer)."""
        claim_path = os.path.join(self.dirs["claims"], f"{jid}.claim")
        cur = claims.get(jid)
        if cur is None:
            # unclaimed: the atomic hardlink create is the whole
            # arbiter — exactly one winner, losers see EEXIST
            return _fleet.excl_create(claim_path, self.daemon_id)
        gen, owner_path = cur
        owner = _fleet.read_small(owner_path)
        if owner == self.daemon_id:
            # ours — either submit_local claimed it synchronously
            # (already in _seen) or a restart with the same daemon_id
            # is adopting its predecessor's unanswered claims
            return True
        if owner and self._daemon_alive(owner):
            return False            # a live peer's job
        # owner dead (or claim unreadable): take generation g+1.
        # Thieves are subject to liveness like anyone else, so a dead
        # thief's loot is re-stealable at g+2 — runtime/fleet.py's
        # steal-generation contract on jobs
        steal_path = os.path.join(self.dirs["claims"],
                                  f"{jid}.steal.{gen + 1}")
        if _fleet.excl_create(steal_path, self.daemon_id):
            _STOLEN.inc(daemon=self.daemon_id)
            _obs_events.emit("serve_job_stolen", job=jid,
                             daemon=self.daemon_id,
                             from_daemon=owner, generation=gen + 1)
            return True
        return False

    def _cleanup_claims(self, jid: str) -> None:
        if not self.claim_jobs:
            return
        try:
            names = os.listdir(self.dirs["claims"])
        except OSError:
            return
        for name in names:
            if name == f"{jid}.claim" \
                    or name.startswith(f"{jid}.steal."):
                try:
                    os.unlink(os.path.join(self.dirs["claims"], name))
                except OSError:
                    pass

    # -- one scan ----------------------------------------------------------

    def poll_once(self) -> int:
        """Pick up new job files, flush finished jobs' results.
        Returns how many jobs are still in flight (queued/running with
        no result written)."""
        claims = self._scan_claims() if self.claim_jobs else None
        # pull, don't hoard: a fleet daemon claims only what its
        # workers can soon run (workers x2 of prefetch) — claiming the
        # whole spool up front would serialize a burst onto whichever
        # daemon's scan ran first and starve its peers (the fleet
        # scheduler's "a slow host claims less" contract, on jobs)
        claim_budget = self.scheduler.workers * 2 - len(self._pending) \
            if claims is not None else 0
        for name in sorted(os.listdir(self.dirs["jobs"])):
            if not name.endswith(".json") or name in self._seen:
                continue
            jid = name[: -len(".json")]
            if claims is not None:
                if os.path.exists(os.path.join(self.dirs["results"],
                                               f"{jid}.json")):
                    # answered (possibly by a peer): consume the
                    # request so no daemon ever re-runs it
                    self._unlink_job(name)
                    self._cleanup_claims(jid)
                    continue
                if claim_budget <= 0:
                    continue
                if not self._try_own(jid, claims):
                    # a peer's job — NOT added to _seen: it is
                    # re-examined every poll so a stale owner's jobs
                    # become stealable
                    continue
                claim_budget -= 1
                _CLAIMED.set(float(len(self._pending) + 1),
                             daemon=self.daemon_id)
            self._seen.add(name)
            self._ingest_job_file(name)
        for jid, job in list(self._pending.items()):
            if job.state in TERMINAL:
                self._write_result(job)
                del self._pending[jid]
        if claims is not None:
            _CLAIMED.set(float(len(self._pending)),
                         daemon=self.daemon_id)
        return len(self._pending)

    def _ingest_job_file(self, name: str) -> None:
        path = os.path.join(self.dirs["jobs"], name)
        # crash-safe restart idempotence: a daemon killed between
        # writing the result and unlinking the request must not re-run
        # (and re-answer) the job on restart — exactly-once results
        jid = name[: -len(".json")]
        if os.path.exists(os.path.join(self.dirs["results"],
                                       f"{jid}.json")):
            self._unlink_job(name)
            self._cleanup_claims(jid)
            return
        try:
            with open(path) as fh:
                req = json.load(fh)
            if req.get("schema") != JOB_SCHEMA:
                raise ValueError(
                    f"job schema {req.get('schema')!r} is not "
                    f"{JOB_SCHEMA}")
            deadline_ms = req.get("deadline_unix_ms")
            job = Job(source=req["source"], output=req.get("output"),
                      tenant=req.get("tenant") or "default",
                      job_id=req.get("id") or name[: -len(".json")],
                      stats_json=req.get("stats_json"),
                      artifact=req.get("artifact"),
                      config_kwargs=req.get("config") or {},
                      deadline_unix=(int(deadline_ms) / 1000.0
                                     if deadline_ms is not None
                                     else None))
        except (OSError, ValueError, KeyError, TypeError) as exc:
            # a torn/garbage request file must answer, not rot silently
            # in the spool: synthesize a rejected result under the
            # filename's id so the submitter's wait() terminates
            jid = name[: -len(".json")]
            self._write_result_payload(jid, {
                "schema": RESULT_SCHEMA, "id": jid, "status": "rejected",
                "error": f"unreadable job file: {exc}"})
            self._unlink_job(name)
            self._cleanup_claims(jid)
            return
        job = self.scheduler.submit(job)
        if job.state in TERMINAL:       # rejected at admission
            self._write_result(job)
        else:
            self._pending[job.id] = job

    def _write_result(self, job: Job) -> None:
        payload = {"schema": RESULT_SCHEMA}
        payload.update(job.to_wire())
        if self.daemon_id:
            payload["daemon"] = self.daemon_id
        self._write_result_payload(job.id, payload)
        self._unlink_job(f"{job.id}.json")
        self._cleanup_claims(job.id)

    def _write_result_payload(self, jid: str,
                              payload: Dict[str, Any]) -> None:
        _atomic_write_json(
            self.dirs, os.path.join(self.dirs["results"], f"{jid}.json"),
            payload)

    def _unlink_job(self, name: str) -> None:
        try:
            os.unlink(os.path.join(self.dirs["jobs"], name))
        except OSError:
            pass
        self._seen.discard(name)

    # -- in-process admission ---------------------------------------------

    def submit_local(self, source: str, output: Optional[str] = None,
                     tenant: str = "default",
                     stats_json: Optional[str] = None,
                     artifact: Optional[str] = None,
                     config_kwargs: Optional[Dict[str, Any]] = None,
                     deadline_unix: Optional[float] = None
                     ) -> Job:
        """Admit one job through THIS daemon's scheduler, durably.

        The job file lands in the shared spool BEFORE admission and is
        claimed by this daemon, so an accepted job survives its accepting
        daemon: a SIGKILL mid-run leaves a spooled request whose claim
        goes stale, and any surviving fleet peer steals and answers it.
        Admission REJECTIONS answer synchronously and also spool a result
        record so a polling client sees the same terminal state either
        way."""
        jid = new_job_id()
        if self.claim_jobs:
            # claim BEFORE the job file lands: a peer's scan between
            # spool-write and claim would otherwise win the claim and
            # run the job a second time next to our local admission
            _fleet.excl_create(
                os.path.join(self.dirs["claims"], f"{jid}.claim"),
                self.daemon_id)
        # seen BEFORE the file lands: this daemon's own poll loop must
        # not ingest it a second time
        self._seen.add(f"{jid}.json")
        write_job(self.spool, source, output=output, tenant=tenant,
                  stats_json=stats_json, artifact=artifact,
                  config_kwargs=config_kwargs, job_id=jid,
                  deadline_unix_ms=(int(deadline_unix * 1000)
                                    if deadline_unix is not None
                                    else None))
        job = Job(source=os.path.abspath(source),
                  output=os.path.abspath(output) if output else None,
                  tenant=tenant, job_id=jid,
                  stats_json=os.path.abspath(stats_json)
                  if stats_json else None,
                  artifact=os.path.abspath(artifact)
                  if artifact else None,
                  config_kwargs=dict(config_kwargs or {}),
                  deadline_unix=deadline_unix)
        job = self.scheduler.submit(job)
        if job.state in TERMINAL:       # rejected at admission
            self._write_result(job)
        else:
            self._pending[job.id] = job
        return job

    # -- loop --------------------------------------------------------------

    def run(self, once: bool = False) -> None:
        """Serve until :attr:`stop_event` (or, with ``once``, until the
        spool's current jobs are all answered — the CI/test mode)."""
        while not self.stop_event.is_set():
            in_flight = self.poll_once()
            if once and not in_flight \
                    and not os.listdir(self.dirs["jobs"]):
                return
            self.stop_event.wait(self.poll_interval)

    def close(self, timeout: Optional[float] = None) -> None:
        """Graceful drain: finish what is RUNNING, hand back
        what is not.  Queued jobs this daemon claimed but never started
        are released — pulled from the local queue, their spool claims
        unlinked — so fleet peers steal and answer them immediately
        (the job files stay; no result is written here, so the peer's
        is the one result).  In-flight jobs get up to the drain budget
        to finish and flush; then the heartbeat departs.  ``timeout``
        overrides the daemon's ``drain_timeout_s`` when given."""
        t0 = time.monotonic()
        drain_budget = self.drain_timeout_s if timeout is None \
            else float(timeout)
        self.stop_event.set()
        released = []
        if self.claim_jobs:
            # release BEFORE the queue closes: peers must win these,
            # not this daemon's exiting workers.  Only spool-backed
            # jobs qualify — a job with no job file has no peer to
            # steal it, so it must drain here instead.
            released = self.scheduler.release_queued(
                select=lambda j: j.id in self._pending)
            for job in released:
                self._pending.pop(job.id, None)
                self._seen.discard(f"{job.id}.json")
                self._cleanup_claims(job.id)
        self.scheduler.shutdown(wait=True, timeout=drain_budget)
        # flush results of anything that finished during shutdown
        for jid, job in list(self._pending.items()):
            if job.state in TERMINAL:
                self._write_result(job)
                del self._pending[jid]
        if self.claim_jobs:
            # graceful depart: delete the heartbeat so fleet peers
            # steal any leftover claims immediately instead of waiting
            # out the liveness timeout (the fleet.depart idiom); a
            # SIGKILL skips this and the mtime goes stale instead
            try:
                os.unlink(self._hb_path)
            except OSError:
                pass
            if self._hb_thread is not None:
                self._hb_thread.join(timeout=5)
            _obs_events.emit("serve_fleet_depart",
                             daemon=self.daemon_id,
                             unanswered=len(self._pending))
        seconds = time.monotonic() - t0
        _DRAIN_SECONDS.observe(seconds)
        if _obs_metrics.enabled():
            _obs_events.emit("serve_drain", daemon=self.daemon_id,
                             seconds=round(seconds, 4),
                             released=len(released),
                             unanswered=len(self._pending))
