"""Deterministic chaos harness for the port's serve fleet.

Counterpart of ``tpuprof/testing/chaos.py``: :func:`build_storm` draws the
same plan from the same seed (``StormPlan.fingerprint`` equals the
reference's), and :func:`run_storm` throws it at a fleet of
``python -m tpuprof_torch serve SPOOL --http 0`` daemons.  Each rung of
the fault ladder proves ONE failure shape in isolation — a torn write, a
dead host, a corrupt generation; the storm proves they COMPOSE: several of
them hit a multi-daemon fleet at once, and the global invariants must
survive — every accepted job answered exactly once, identical requests
answered byte-identically no matter which daemon computed them, no
unhandled traceback in any daemon's stderr, and every failure that does
surface typed (a taxonomy exit code, not a stack dump).

Everything is a pure function of the seed: the whole schedule — which
faults hit which daemon at which call, which daemon is the SIGKILL victim,
which edge takes each submit — comes from ``random.Random(seed)`` and
nothing else, so a failing storm is re-runnable from its seed alone.
Faults ride the existing seams: the ``TPUPROF_FAULTS`` grammar
(testing/faults.py) injects torn disk writes (``*_write:truncate@M``),
accept-time EMFILE (``http_accept:N@M``), mid-response connection resets
(``http_write:N@M``) and wedged workers (``serve_job:sleep=S@M``) inside
each daemon process through its environment; the harness itself SIGKILLs
the victim and flips warehouse bytes from outside.

The daemons run on ``cuda:0`` unless ``run_storm(device="cpu")`` asks for
the kernels' plain versions (the tests do).
"""

from __future__ import annotations

import hashlib
import json
import os
import random
import signal
import subprocess
import sys
import time
from typing import Any, Dict, List, Optional

# the three request shapes a storm submits; same-index submits are the
# byte-identical group (any daemon must produce the same answer bytes)
CONFIG_VARIANTS = (
    {"batch_rows": 1024},
    {"batch_rows": 512},
    {"batch_rows": 2048},
)

# the fault menu: (site, mode-template) pairs the plan draws from.
# ``{m}`` is the 1-based call number the rng fills in — early calls, so
# short storms still land their faults.
_FAULT_MENU = (
    ("http_accept", "2@{m}"),           # EMFILE burst at accept
    ("http_write", "1@{m}"),            # connection reset mid-response
    ("serve_job", "sleep=0.4@{m}"),     # one slow job (watchdog food)
    ("warehouse_write", "truncate@{m}"),    # torn warehouse write
    ("checkpoint_write", "truncate@{m}"),   # torn checkpoint write
)


class DaemonScript:
    """One daemon's role in the storm: its id, its injected-fault env,
    and whether the harness SIGKILLs it mid-storm."""

    __slots__ = ("daemon_id", "faults_spec", "is_victim")

    def __init__(self, daemon_id: str, faults_spec: str,
                 is_victim: bool = False):
        self.daemon_id = daemon_id
        self.faults_spec = faults_spec
        self.is_victim = is_victim

    def to_doc(self) -> Dict[str, Any]:
        return {"daemon_id": self.daemon_id,
                "faults_spec": self.faults_spec,
                "is_victim": self.is_victim}


class StormPlan:
    """A fully-scripted storm: pure data, no clocks, no I/O."""

    def __init__(self, seed: int, daemons: List[DaemonScript],
                 submits: List[Dict[str, Any]],
                 kill_after_results: int,
                 flip_warehouse_byte: bool):
        self.seed = seed
        self.daemons = daemons
        self.submits = submits          # [{"edge": i, "tenant": str,
                                        #   "variant": k}, ...]
        self.kill_after_results = kill_after_results
        self.flip_warehouse_byte = flip_warehouse_byte

    def to_doc(self) -> Dict[str, Any]:
        return {
            "seed": self.seed,
            "daemons": [d.to_doc() for d in self.daemons],
            "submits": self.submits,
            "kill_after_results": self.kill_after_results,
            "flip_warehouse_byte": self.flip_warehouse_byte,
        }

    def fingerprint(self) -> str:
        """Stable content hash — the determinism proof handle: equal
        seeds MUST produce equal fingerprints on any host, thread
        count, or Python hash seed."""
        blob = json.dumps(self.to_doc(), sort_keys=True,
                          separators=(",", ":")).encode()
        return hashlib.sha256(blob).hexdigest()


def build_storm(seed: int, n_daemons: int = 3,
                n_jobs: int = 9) -> StormPlan:
    """Draw a whole storm from the seed — and nothing else."""
    if n_daemons < 1:
        raise ValueError(f"storm needs >=1 daemon, got {n_daemons}")
    rng = random.Random(int(seed))
    victim = rng.randrange(n_daemons) if n_daemons > 1 else -1
    daemons: List[DaemonScript] = []
    for i in range(n_daemons):
        # 1-2 faults per daemon, distinct sites, early call numbers
        picks = rng.sample(range(len(_FAULT_MENU)), rng.randint(1, 2))
        parts = []
        for p in sorted(picks):
            site, tmpl = _FAULT_MENU[p]
            parts.append(f"{site}:" + tmpl.format(m=rng.randint(1, 4)))
        daemons.append(DaemonScript(
            daemon_id=f"chaos-d{i}",
            faults_spec=",".join(parts),
            is_victim=(i == victim)))
    submits = []
    for k in range(n_jobs):
        submits.append({
            "edge": rng.randrange(n_daemons),
            "tenant": f"tenant{rng.randrange(3)}",
            "variant": k % len(CONFIG_VARIANTS),
        })
    # kill lands mid-backlog: after about a third of the answers exist
    kill_after = max(1, n_jobs // 3) if victim >= 0 else 0
    return StormPlan(seed=int(seed), daemons=daemons, submits=submits,
                     kill_after_results=kill_after,
                     flip_warehouse_byte=rng.random() < 0.5)


class StormReport:
    """What the harness observed — the invariant assertions' input."""

    def __init__(self) -> None:
        self.results: Dict[str, Dict[str, Any]] = {}   # jid -> result
        self.stats_bytes: Dict[str, bytes] = {}        # jid -> answer
        self.variant_of: Dict[str, int] = {}           # jid -> variant
        self.stderr: Dict[str, str] = {}               # daemon -> text
        self.exit_codes: Dict[str, Optional[int]] = {}
        self.spool_results: List[str] = []
        self.submit_fallbacks = 0       # edge dead -> spooled directly

    def tracebacks(self) -> Dict[str, str]:
        """Daemons whose stderr leaked an unhandled traceback."""
        return {d: text for d, text in self.stderr.items()
                if "Traceback (most recent call last)" in text}

    def byte_identity_violations(self) -> List[str]:
        """Jobs whose answer bytes differ from a same-variant peer's."""
        canon: Dict[int, bytes] = {}
        bad: List[str] = []
        for jid, blob in sorted(self.stats_bytes.items()):
            if not blob:
                continue    # no answer landed — the exactly-once /
                            # typed-failure invariants judge that one
            variant = self.variant_of[jid]
            if variant not in canon:
                canon[variant] = blob
            elif canon[variant] != blob:
                bad.append(jid)
        return bad


def run_storm(plan: StormPlan, workdir: str, source: str,
              timeout: float = 600.0,
              device: Optional[str] = None) -> StormReport:
    """Drive a real subprocess fleet through ``plan``.

    Spawns one ``python -m tpuprof_torch serve --http 0`` process per
    :class:`DaemonScript` (each with its scripted ``TPUPROF_FAULTS``
    env), submits every scripted job over the scripted daemon's edge
    (falling back to a direct spool write when chaos already took that
    edge down — an accepted job is an accepted job), SIGKILLs the
    victim once ``kill_after_results`` answers exist, optionally flips
    a byte in a warehouse generation, then waits every job out and
    SIGTERMs the survivors (the graceful-drain path)."""
    from tpuprof_torch.serve import (discover_edges, submit_job, wait_result,
                               write_job)
    from tpuprof_torch.errors import ServeUnavailableError

    spool = os.path.join(workdir, "spool")
    os.makedirs(spool, exist_ok=True)
    repo = os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    report = StormReport()
    deadline = time.monotonic() + timeout

    procs: Dict[str, subprocess.Popen] = {}
    stderr_paths: Dict[str, str] = {}
    victim_id: Optional[str] = None
    for script in plan.daemons:
        if script.is_victim:
            victim_id = script.daemon_id
        env = dict(os.environ,
                   TPUPROF_FAULTS=script.faults_spec,
                   TPUPROF_FAULTS_SEED=str(plan.seed))
        err_path = os.path.join(workdir, f"{script.daemon_id}.stderr")
        stderr_paths[script.daemon_id] = err_path
        procs[script.daemon_id] = subprocess.Popen(
            [sys.executable, "-m", "tpuprof_torch", "serve", spool,
             "--http", "0", "--daemon-id", script.daemon_id,
             "--serve-workers", "1", "--liveness-timeout", "2",
             # byte-identity needs every same-variant submit COMPUTED
             # (possibly by different daemons) — no cache collapsing
             "--read-cache", "off"]
            + (["--device", device] if device is not None else []),
            env=env, cwd=repo, stderr=open(err_path, "wb"))

    def _edges() -> Dict[str, str]:
        return discover_edges(spool)

    try:
        want = {s.daemon_id for s in plan.daemons}
        while set(_edges()) < want:
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"storm fleet never advertised: have "
                    f"{sorted(_edges())}, want {sorted(want)}")
            time.sleep(0.2)

        jids: List[str] = []
        for sub in plan.submits:
            script = plan.daemons[sub["edge"]]
            cfg = dict(CONFIG_VARIANTS[sub["variant"]])
            stats_json = os.path.join(
                workdir, f"answer-{len(jids)}.json")
            url = _edges().get(script.daemon_id)
            jid = None
            if url is not None:
                try:
                    code, doc = submit_job(
                        url, source, tenant=sub["tenant"],
                        stats_json=stats_json, config_kwargs=cfg)
                    if code == 202:
                        jid = doc["id"]
                except ServeUnavailableError:
                    pass        # chaos took the edge; spool instead
            if jid is None:
                report.submit_fallbacks += 1
                jid = write_job(spool, source, tenant=sub["tenant"],
                                stats_json=stats_json,
                                config_kwargs=cfg)
            report.variant_of[jid] = sub["variant"]
            report.stats_bytes[jid] = b""   # filled after the wait
            jids.append(jid)
            # remember where this job's answer lands
            report.results[jid] = {"stats_json": stats_json}

        if victim_id is not None and plan.kill_after_results > 0:
            results_dir = os.path.join(spool, "results")
            while not os.path.isdir(results_dir) \
                    or len(os.listdir(results_dir)) \
                    < plan.kill_after_results:
                if time.monotonic() > deadline:
                    raise TimeoutError("storm never produced the "
                                       "pre-kill result quorum")
                time.sleep(0.1)
            proc = procs[victim_id]
            if proc.poll() is None:
                os.kill(proc.pid, signal.SIGKILL)
            proc.wait(timeout=30)

        if plan.flip_warehouse_byte:
            _flip_one_warehouse_byte(spool)

        for jid in jids:
            res = wait_result(
                spool, jid,
                timeout=max(1.0, deadline - time.monotonic()))
            stats_json = report.results[jid]["stats_json"]
            report.results[jid] = res
            if res.get("status") == "done" \
                    and os.path.exists(stats_json):
                with open(stats_json, "rb") as fh:
                    report.stats_bytes[jid] = fh.read()
        report.spool_results = sorted(
            os.listdir(os.path.join(spool, "results")))
    finally:
        for daemon_id, proc in procs.items():
            if proc.poll() is None:
                proc.terminate()        # SIGTERM: the graceful drain
        for daemon_id, proc in procs.items():
            if proc.poll() is None:
                try:
                    proc.wait(timeout=60)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait(timeout=30)
            report.exit_codes[daemon_id] = proc.returncode
        for daemon_id, path in stderr_paths.items():
            try:
                with open(path, "r", errors="replace") as fh:
                    report.stderr[daemon_id] = fh.read()
            except OSError:
                report.stderr[daemon_id] = ""
    return report


def _flip_one_warehouse_byte(spool: str) -> None:
    """Driver-side warehouse rot: flip one byte in the first
    generation file found under the spool's warehouse dir (no-op when
    the storm produced none — the flip is opportunistic chaos, not a
    required leg)."""
    root = os.path.join(spool, "warehouse")
    for dirpath, _dirs, files in sorted(os.walk(root)):
        for name in sorted(files):
            if name.endswith(".parquet"):
                path = os.path.join(dirpath, name)
                with open(path, "r+b") as fh:
                    blob = fh.read()
                    if not blob:
                        continue
                    mid = len(blob) // 2
                    fh.seek(mid)
                    fh.write(bytes([blob[mid] ^ 0xFF]))
                return
