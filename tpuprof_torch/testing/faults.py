"""Deterministic fault injection at named sites.

Trimmed copy of ``tpuprof/testing/faults.py``: the spec grammar, the seeded
keyed draw and the ``TPUPROF_FAULTS`` / ``TPUPROF_FAULTS_SEED`` activation
are the reference's, so one plan and seed fire on the same batch keys in
both packages.  A site is a string the runtime passes to :func:`hit` at the
instant a failure would occur; the active :class:`FaultPlan` decides whether
the call raises, sleeps or passes.  With no plan installed every hook is one
``is None`` check.

Sites the port wires:

=================  ========================================================
``prep``           per-batch host prepare (retried; quarantinable)
``fold``           per-batch host fold of pass A (quarantinable, never
                   retried)
``device_wait``    the watched copy of the device state to the host, and
                   the wait a stream's drain makes on the card
``device_drain``   the watchdog site of a stream's drain (its fault hook
                   is ``device_wait``; a timeout names this site)
``checkpoint_write``  one checkpoint save (``runtime/checkpoint.py``):
                   raise at the write, or ``truncate@M`` to tear it
``artifact_write`` one artifact write (``artifact/store.py``): the same
``barrier``        the watched cross-process gather
                   (``runtime/distributed.allgather_with_watchdog``)
``resume_barrier`` the watchdog site of the multi-process resume barrier
``fleet_publish``  the watchdog site of ``publish_fleet``'s gather
``fleet_finish``   the watchdog site of an elastic member's finish barrier
``host_death``     per-batch kill switch of a rank or elastic member
                   (pass A's fold loop): ``host_death:@k``
``serve_job``      one served job's run (``serve/scheduler.py``, keyed by
                   the job id): fails that job, the daemon keeps serving;
                   ``sleep=S`` (or ``sleep=S@M``) here feeds the job
                   watchdog
``singlepass_rebin``  the start of a fused profile's targeted pass-B
                   re-bin (``backends/gpu.py``, the edge-miss fallback of
                   ``runtime/singlepass.py``): reached only when a lane
                   missed its provisional edges
``aot_load``       the start of a load from the store of built kernel
                   libraries (``runtime/aot.py``): a raising load demotes
                   loudly to an nvcc build, never fails the profile
``warehouse_write``  one columnar stats file write
                   (``warehouse/columnar.py``, keyed by the generation):
                   raise at the write, or ``truncate@M`` to tear it; a
                   watch cycle survives it
``watch_cycle``    the start of one drift-watch cycle
                   (``serve/watch.py``, keyed by the cycle number): the
                   cycle becomes a ``failed_cycle`` alert and the watch
                   goes on
``http_accept``    the HTTP edge's accept (``serve/http.py``): a raise
                   (EMFILE under fd pressure) skips that accept round and
                   the loop keeps serving
``http_write``     a response write of the edge: a raise (a connection
                   reset mid-response) drops that socket only
=================  ========================================================

Spec grammar, ``site:mode`` pairs separated by commas, e.g.
``TPUPROF_FAULTS="prep:0.05,fold:1@3"``:

* ``0.05`` — raise :class:`TransientError` with probability p per attempt;
  a keyed call (the runtime passes the batch's stream position) draws from
  ``hash(seed, site, key, attempt)``, so the injected set is a function of
  the seed alone, under any thread count or retry schedule;
* ``N@M`` — raise :class:`TransientError` on N consecutive first attempts
  from the M-th (1-based; under parallel prep arrival order decides which
  batches land in the window);
* ``fatal@M`` — like ``1@M`` but raises ``RuntimeError`` (never retried);
* ``transient`` — every batch's first attempt raises
  :class:`TransientError`, retries succeed;
* ``sleep=S`` — delay S seconds on every call; ``sleep=S@M`` only on the
  M-th;
* ``truncate@M`` — for the byte-writing sites: :func:`mangle` keeps the
  first half of the M-th write's bytes (a torn write that still renames);
* ``@M`` — host death: raise :class:`HostDeathError` on the M-th call
  (first attempts for keyed sites) and never again.  Each process carries
  its own ``TPUPROF_FAULTS``, so ``host_death:@k`` kills that one rank or
  member after k batches.
"""

from __future__ import annotations

import os
import random
import threading
import time
from typing import Any, Dict, Optional

from tpuprof_torch.errors import HostDeathError, TransientError

_ENV_SPEC = "TPUPROF_FAULTS"
_ENV_SEED = "TPUPROF_FAULTS_SEED"

#: every site the port hands to :func:`hit`/:func:`mangle` or names as a
#: watchdog ``site=`` (the table above): the reference's registry
SITES = frozenset({
    "prep", "fold",
    "checkpoint_write", "artifact_write", "warehouse_write",
    "device_wait", "device_drain", "resume_barrier", "barrier",
    "fleet_publish", "fleet_finish",
    "host_death", "serve_job", "watch_cycle",
    "singlepass_rebin",
    "aot_load",
    "http_accept", "http_write",
})


class _Rule:
    """One site's injection rule (parsed from a ``site:mode`` pair)."""

    def __init__(self, site: str, mode: str):
        self.site = site
        self.kind: str
        self.p = 0.0
        self.count = 0          # window width (N@M)
        self.start = 0          # window start, 1-based (N@M)
        self.sleep_s = 0.0
        mode = mode.strip()
        if mode == "transient":
            self.kind = "transient"
        elif mode.startswith("@"):
            self.kind, self.count = "death", 1
            self.start = int(mode[1:])
            if self.start < 1:
                raise ValueError(f"death call number must be >=1: {mode!r}")
        elif mode.startswith("sleep="):
            self.kind = "sleep"
            rest = mode[len("sleep="):]
            if "@" in rest:
                secs, at = rest.split("@", 1)
                self.sleep_s = float(secs)
                self.start, self.count = int(at), 1
                if self.start < 1:
                    raise ValueError(
                        f"sleep call number must be >=1: {mode!r}")
            else:
                self.sleep_s = float(rest)
        elif "@" in mode:
            left, at = mode.split("@", 1)
            self.start = int(at)
            if left == "fatal":
                self.kind, self.count = "fatal", 1
            elif left == "truncate":
                self.kind, self.count = "truncate", 1
            else:
                self.kind, self.count = "window", int(left)
            if self.start < 1 or self.count < 1:
                raise ValueError(f"fault window must be >=1: {mode!r}")
        else:
            self.kind = "p"
            self.p = float(mode)
            if not 0.0 < self.p <= 1.0:
                raise ValueError(f"fault probability out of (0,1]: {mode!r}")
        # mutable state (guarded by the plan lock)
        self.calls = 0              # every hit() at this site
        self.firsts = 0             # first attempts only (window counting)
        self.attempts: Dict[Any, int] = {}   # per-key attempt numbers
        self.rng = None             # lazily seeded sequential RNG (no key)


class FaultPlan:
    """Parsed, seeded injection plan.  Thread-safe."""

    def __init__(self, rules: Dict[str, _Rule], seed: int = 0):
        self.rules = rules
        self.seed = int(seed)
        self._lock = threading.Lock()
        self._injected: Dict[str, int] = {}

    @classmethod
    def from_spec(cls, spec: str, seed: int = 0) -> "FaultPlan":
        rules: Dict[str, _Rule] = {}
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            if ":" not in part:
                raise ValueError(
                    f"fault spec needs site:mode, got {part!r}")
            site, mode = part.split(":", 1)
            rules[site.strip()] = _Rule(site.strip(), mode)
        return cls(rules, seed=seed)

    def injected(self, site: Optional[str] = None):
        with self._lock:
            if site is not None:
                return self._injected.get(site, 0)
            return dict(self._injected)

    def _record(self, site: str) -> None:
        self._injected[site] = self._injected.get(site, 0) + 1

    def fire(self, site: str, key: Any = None) -> None:
        """Decide this call's fate: return (pass), sleep, or raise."""
        rule = self.rules.get(site)
        if rule is None or rule.kind == "truncate":
            return      # counted by mangle_bytes, where the bytes are
        with self._lock:
            rule.calls += 1
            call_no = rule.calls
            if key is not None:
                att = rule.attempts.get(key, 0)
                rule.attempts[key] = att + 1
            else:
                att = 0
            first = att == 0
            if first:
                rule.firsts += 1
            first_no = rule.firsts
            do_sleep = False
            n = first_no if key is not None else call_no
            in_window = rule.start <= n < rule.start + rule.count
            if rule.kind == "sleep":
                # start 0 = every call; start >= 1 = that one call only
                do_sleep = rule.start == 0 or (
                    (first or key is None) and in_window)
            elif rule.kind == "p":
                if key is not None:
                    # order-free determinism: one draw per (key, attempt)
                    draw = random.Random(
                        repr((self.seed, site, key, att))).random()
                else:
                    if rule.rng is None:
                        rule.rng = random.Random(repr((self.seed, site)))
                    draw = rule.rng.random()
                if draw < rule.p:
                    self._record(site)
                    raise TransientError(
                        f"injected transient fault at {site!r} "
                        f"(key={key!r}, attempt={att})")
            elif rule.kind == "transient":
                odd = call_no % 2 == 1
                if (first and key is not None) or (key is None and odd):
                    self._record(site)
                    raise TransientError(
                        f"injected transient fault at {site!r} "
                        f"(key={key!r}, first attempt)")
            elif rule.kind == "death":
                if (first or key is None) and n == rule.start:
                    self._record(site)
                    raise HostDeathError(site, n)
            elif (first or key is None) and in_window:   # window, fatal
                self._record(site)
                if rule.kind == "fatal":
                    raise RuntimeError(
                        f"injected fatal fault at {site!r} (call {n})")
                raise TransientError(
                    f"injected transient fault at {site!r} (call {n})")
        if do_sleep:
            time.sleep(rule.sleep_s)

    def mangle_bytes(self, site: str, data: bytes) -> bytes:
        """The M-th call of a ``truncate@M`` site keeps half its bytes."""
        rule = self.rules.get(site)
        if rule is None or rule.kind != "truncate":
            return data
        with self._lock:
            rule.calls += 1
            if rule.start <= rule.calls < rule.start + rule.count:
                self._record(site)
                return data[: len(data) // 2]
        return data


_plan: Optional[FaultPlan] = None


def configure(spec: Optional[str] = None,
              seed: Optional[int] = None) -> Optional[FaultPlan]:
    """Install a plan from ``spec`` (None reads ``TPUPROF_FAULTS``; an
    empty spec clears)."""
    global _plan
    if spec is None:
        spec = os.environ.get(_ENV_SPEC) or ""
    if seed is None:
        seed = int(os.environ.get(_ENV_SEED, "0") or 0)
    _plan = FaultPlan.from_spec(spec, seed=seed) if spec else None
    return _plan


def install(plan: Optional[FaultPlan]) -> None:
    global _plan
    _plan = plan


def reset() -> None:
    global _plan
    _plan = None


def injected(site: Optional[str] = None):
    """Raise counts by site (0 or {} with no plan)."""
    p = _plan
    if p is None:
        return 0 if site is not None else {}
    return p.injected(site)


def hit(site: str, key: Any = None) -> None:
    """The runtime hook: a no-op unless a plan targets ``site``."""
    p = _plan
    if p is None:
        return
    p.fire(site, key=key)


def mangle(site: str, data: bytes) -> bytes:
    """The byte hook of a writing site: ``data`` as a ``truncate@M`` rule
    leaves it (unchanged with no plan)."""
    p = _plan
    if p is None:
        return data
    return p.mangle_bytes(site, data)


# a process launched with TPUPROF_FAULTS set (a CLI run, a child in a test)
# injects without any code cooperation
if os.environ.get(_ENV_SPEC):
    configure()
