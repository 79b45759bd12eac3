"""Continuous drift watch inside the serve daemon.

Counterpart of ``tpuprof/serve/watch.py``: the same watch manifest
(``tpuprof-watch-manifest-v1``, CRC-sealed), the same directory layout and
:func:`source_key`, the same alert shapes and dedup, so a watch directory
one package wrote is resumed by the other.  ``python -m tpuprof_torch watch
SPOOL SOURCE ...`` turns the resident daemon from "profiles when asked"
into "watches its own data": per watched source, a :class:`DriftWatcher`
re-profiles on a cadence THROUGH the scheduler (one warm card, the same
quota and queue every ``submit`` job uses), persists each cycle as a
``tpuprof-stats-v1`` artifact, diffs consecutive cycles with the drift
engine, and raises alerts when PSI/KS/schema bands cross
:class:`~tpuprof_torch.artifact.DriftThresholds`.

Continuous operation is the robustness core — a watch loop that runs
for weeks meets every failure a one-shot profile meets, plus its own:

* **Per-job watchdog** — the scheduler wraps each job body in
  ``guard.watched(job_timeout_s)`` (serve/scheduler.py), so a hung
  profile raises :class:`WatchdogTimeout`, frees the worker, and fails
  THAT job with exit-code-4 semantics instead of wedging the daemon.
* **Crash-safe recovery** — watch state (cycle counter, baseline
  artifact path, alert dedup cursor) persists in a CRC-sealed,
  atomically-written *watch manifest* per source.  A torn/truncated
  manifest is the typed :class:`CorruptManifestError` — never a raw
  JSON error — and the restore path degrades to rebuilding state from
  the retained artifact chain on disk, recording an alert.  (Spool jobs
  with no result are re-run by the daemon itself — serve/server.py.)
* **Artifact retention** — ``artifact_keep`` cycle artifacts per source
  rotate on disk; the drift-baseline read walks past a corrupt head to
  the newest good generation, exactly as checkpoint restore does.
* **Degraded-cycle semantics** — a cycle whose profile fails (poison
  data, watchdog kill, torn artifact, injected fault) records a
  ``failed_cycle`` alert and the watch CONTINUES; the baseline stays at
  the last good cycle, so the next comparison is still meaningful.

What the operator sees: ``drift_alert`` JSONL events,
``tpuprof_drift_alerts_total{severity}`` /
``tpuprof_watch_cycles_total{status}`` metrics, and a pollable
``alerts.json`` per watched source.

Layout under the spool dir::

    watch/<key>/manifest.json              CRC-sealed watch state
    watch/<key>/cycle_<n>.artifact.json    retained cycle artifacts
    watch/<key>/alerts.json                the operator-pollable
                                           alert feed (newest last,
                                           capped at ALERTS_CAP)

where ``<key>`` is the source basename plus a short path hash — stable
across restarts, collision-free across sources with one name.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import threading
import time
import zlib
from typing import Any, Dict, List, Optional, Sequence

from tpuprof_torch.errors import (CorruptArtifactError, CorruptManifestError,
                            TYPED_ERRORS, WarehouseUnavailableError,
                            exit_code)
from tpuprof_torch.obs import blackbox
from tpuprof_torch.obs import events as _obs_events
from tpuprof_torch.obs import metrics as _obs_metrics
from tpuprof_torch.serve.jobs import DONE
from tpuprof_torch.testing import faults as _faults

WATCH_MANIFEST_SCHEMA = "tpuprof-watch-manifest-v1"

# the alert feed is an operator surface, not an archive: the JSONL
# event stream (and the metrics counters) keep the full history
ALERTS_CAP = 256

_CYCLES = _obs_metrics.counter(
    "tpuprof_watch_cycles_total",
    "drift-watch cycles by outcome (ok|warn|drift|failed)")
_ALERTS = _obs_metrics.counter(
    "tpuprof_drift_alerts_total",
    "drift-watch alerts raised, by severity (warn|drift|failed)")
_CYCLE_SECONDS = _obs_metrics.histogram(
    "tpuprof_watch_cycle_seconds",
    "wall seconds per watch cycle (submit -> alert decision)")
_FALLBACKS = _obs_metrics.counter(
    "tpuprof_watch_artifact_fallbacks_total",
    "baseline reads that walked past a corrupt retained artifact head")

# canonical serialization the manifest CRC covers — the artifact
# store's idiom: key-sorted, no whitespace, so any parsed-value change
# changes these bytes
_CANON = {"sort_keys": True, "separators": (",", ":")}

_CYCLE_RE = re.compile(r"cycle_(\d{8})\.artifact\.json$")

#: how many flagged column names ride one drift alert (and its episode
#: dedup key) — the feed is an operator surface, not a column dump
ALERT_COLUMNS_CAP = 16


def drift_alert_shape(drift: Dict[str, Any]):
    """One drift report -> ``(status, flagged_columns)``: the verdict
    plus the capped, sorted column list an alert (and its episode dedup
    key) carries.  The ONE definition the live watch loop and the
    warehouse backtester (warehouse/backtest.py) both speak —
    a replay that derived the shape its own way could never promise to
    reproduce the live alert set exactly."""
    status = drift["summary"]["verdict"]
    flagged = sorted(c for c, e in drift["columns"].items()
                     if e["status"] != "ok")
    return status, flagged[:ALERT_COLUMNS_CAP]


def drift_episode_key(severity: str, columns) -> List[Any]:
    """The episode dedup key: the SAME ongoing drift (same severity,
    same flagged set) alerts once, not every cycle."""
    return ["drift", severity, list(columns or [])]


def source_key(source: Any) -> str:
    """Stable per-source directory name: sanitized basename + a short
    hash of the absolute path (two sources named ``data.parquet`` in
    different directories must not share watch state)."""
    text = str(source)
    base = re.sub(r"[^A-Za-z0-9._-]+", "_",
                  os.path.basename(text.rstrip("/")) or "source")
    digest = hashlib.sha1(os.path.abspath(text).encode()).hexdigest()[:8]
    return f"{base}-{digest}"


def _atomic_write(path: str, data: bytes) -> None:
    # dot-prefixed temp: the watch dir is scanned (_CYCLE_RE chain walk, .part stray sweep) and a
    # suffix-named temp would share the scanned prefix
    tmp = os.path.join(os.path.dirname(path) or ".",
                       f".{os.path.basename(path)}.tmp.{os.getpid()}")
    try:
        with open(tmp, "wb") as fh:
            fh.write(data)
            fh.flush()
            os.fsync(fh.fileno())
    except BaseException:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise
    os.replace(tmp, path)


def write_manifest(path: str, state: Dict[str, Any]) -> None:
    """Atomically persist one source's watch state, CRC-sealed so a
    torn write can never be mistaken for a valid cursor."""
    core = {"schema": WATCH_MANIFEST_SCHEMA}
    core.update(state)
    doc = dict(core)
    doc["integrity"] = {
        "algorithm": "crc32/canonical-json",
        "crc32": zlib.crc32(json.dumps(core, **_CANON).encode())
        & 0xFFFFFFFF,
    }
    _atomic_write(path, json.dumps(doc, indent=1).encode())


def read_manifest(path: str) -> Dict[str, Any]:
    """Read + integrity-check a watch manifest.  A genuinely missing
    file raises ``FileNotFoundError`` ("first cycle ever"); EVERY other
    failure — truncation at any offset, bit rot, junk, a foreign
    schema — is the typed :class:`CorruptManifestError`."""
    try:
        with open(path, "rb") as fh:
            data = fh.read()
    except FileNotFoundError:
        raise
    except OSError as exc:
        raise CorruptManifestError(
            f"watch manifest {path!r} is unreadable "
            f"({type(exc).__name__}: {exc})") from exc
    try:
        doc = json.loads(data)
    except Exception as exc:
        raise CorruptManifestError(
            f"watch manifest {path!r} is not valid JSON — truncated or "
            f"corrupt ({type(exc).__name__}: {exc})") from exc
    if not isinstance(doc, dict) or doc.get("schema") != WATCH_MANIFEST_SCHEMA:
        raise CorruptManifestError(
            f"watch manifest {path!r} has schema "
            f"{doc.get('schema') if isinstance(doc, dict) else type(doc).__name__!r}; "
            f"this build reads {WATCH_MANIFEST_SCHEMA!r}")
    integrity = doc.pop("integrity", None)
    if not isinstance(integrity, dict) or "crc32" not in integrity:
        raise CorruptManifestError(
            f"watch manifest {path!r} lacks its integrity envelope — "
            "torn or hand-edited")
    canon = json.dumps(doc, **_CANON).encode()
    if zlib.crc32(canon) & 0xFFFFFFFF != integrity["crc32"]:
        raise CorruptManifestError(
            f"watch manifest {path!r} CRC mismatch — corrupt manifest")
    return doc


class SourceWatch:
    """One watched source's durable state: the cycle counter, the
    baseline artifact, the alert dedup cursor, and the retained
    artifact chain on disk."""

    def __init__(self, root: str, source: Any, keep: int):
        self.source = str(source)
        self.key = source_key(source)
        self.dir = os.path.join(root, self.key)
        os.makedirs(self.dir, exist_ok=True)
        self.keep = max(int(keep), 1)
        self.cycle = 0                      # completed (or failed) cycles
        self.last_artifact: Optional[str] = None
        self.alert_seq = 0
        self.last_alert_key: Optional[List[Any]] = None
        self.alerts: List[Dict[str, Any]] = []
        self.recovered: Optional[str] = None   # degraded-restore note

    @property
    def manifest_path(self) -> str:
        return os.path.join(self.dir, "manifest.json")

    @property
    def alerts_path(self) -> str:
        return os.path.join(self.dir, "alerts.json")

    def artifact_path(self, cycle: int) -> str:
        return os.path.join(self.dir, f"cycle_{cycle:08d}.artifact.json")

    def chain(self) -> List[tuple]:
        """Retained ``(cycle, path)`` artifacts, newest first."""
        out = []
        try:
            names = os.listdir(self.dir)
        except OSError:
            return []
        for name in names:
            m = _CYCLE_RE.match(name)
            if m:
                out.append((int(m.group(1)),
                            os.path.join(self.dir, name)))
        return sorted(out, reverse=True)

    # -- crash-safe restore -------------------------------------------------

    def restore(self) -> None:
        """Adopt the on-disk state: the manifest when it verifies, else
        (torn manifest — the typed path) a degraded rebuild from the
        retained artifact chain, noted on :attr:`recovered` so the
        watcher records it as an alert."""
        try:
            doc = read_manifest(self.manifest_path)
            self.cycle = int(doc.get("cycle") or 0)
            self.last_artifact = doc.get("last_artifact")
            self.alert_seq = int(doc.get("alert_seq") or 0)
            key = doc.get("last_alert_key")
            self.last_alert_key = list(key) if key is not None else None
        except FileNotFoundError:
            # fresh source — unless artifacts exist with no manifest (a
            # crash before the very first manifest write): adopt the
            # chain so cycle numbers never collide
            self._rebuild_from_chain(reason=None)
        except CorruptManifestError as exc:
            self._rebuild_from_chain(
                reason=f"{type(exc).__name__}: {exc}")
        # the alert feed is advisory: restore best-effort, never fatal
        try:
            with open(self.alerts_path) as fh:
                alerts = json.load(fh)
            if isinstance(alerts, list):
                self.alerts = alerts[-ALERTS_CAP:]
        except (OSError, ValueError):
            pass
        self.alert_seq = max(
            self.alert_seq,
            max((int(a.get("seq") or 0) for a in self.alerts
                 if isinstance(a, dict)), default=0))

    def _rebuild_from_chain(self, reason: Optional[str]) -> None:
        chain = self.chain()
        self.cycle = chain[0][0] if chain else 0
        self.last_artifact = None       # baseline() re-walks the chain
        self.alert_seq = 0              # re-derived from alerts.json
        self.last_alert_key = None
        if reason:
            self.recovered = reason

    def baseline(self, before: Optional[int] = None):
        """The newest READABLE retained artifact (the drift comparison
        base), walking past corrupt heads the way checkpoint restore
        walks its generations.  ``before`` excludes the cycle currently
        being produced.  Returns the Artifact or None (first cycle /
        fully-corrupt chain)."""
        from tpuprof_torch.artifact import read_artifact
        for cyc, path in self.chain():
            if before is not None and cyc >= before:
                continue
            try:
                art = read_artifact(path)
            except (CorruptArtifactError, OSError) as exc:
                _FALLBACKS.inc()
                blackbox.record("watch_artifact_fallback",
                                source=self.source, path=path,
                                error=f"{type(exc).__name__}: {exc}")
                continue
            self.last_artifact = path
            return art
        self.last_artifact = None
        return None

    def rotate(self) -> None:
        """Retention: keep the newest ``keep`` cycle artifacts, and
        sweep stray ``.part`` files left by failed/abandoned cycles
        (only the watcher renames a .part into the chain, so at rotate
        time — a cycle just succeeded — none is in flight)."""
        for _cyc, path in self.chain()[self.keep:]:
            try:
                os.unlink(path)
            except OSError:
                pass
        try:
            strays = [n for n in os.listdir(self.dir)
                      if n.endswith(".artifact.json.part")]
        except OSError:
            strays = []
        for name in strays:
            try:
                os.unlink(os.path.join(self.dir, name))
            except OSError:
                pass


class DriftWatcher:
    """The watch loop: per source, re-profile -> persist -> diff ->
    alert, on a cadence, forever (or ``cycles`` times in CI mode)."""

    def __init__(self, spool: str, sources: Sequence[Any], scheduler,
                 every_s: Optional[float] = None,
                 keep: Optional[int] = None,
                 thresholds=None,
                 job_timeout_s: Optional[float] = None,
                 config_kwargs: Optional[Dict[str, Any]] = None,
                 tenant: str = "watch",
                 warehouse_dir: Optional[str] = None,
                 warehouse_format: Optional[str] = None):
        from tpuprof_torch.artifact import DriftThresholds
        from tpuprof_torch.config import (resolve_artifact_keep,
                                    resolve_job_timeout,
                                    resolve_warehouse_dir,
                                    resolve_warehouse_format,
                                    resolve_watch_every)
        if not sources:
            raise ValueError("watch needs at least one source")
        self.spool = spool
        self.root = os.path.join(spool, "watch")
        os.makedirs(self.root, exist_ok=True)
        self.scheduler = scheduler
        self.every_s = resolve_watch_every(every_s)
        self.keep = resolve_artifact_keep(keep)
        self.thresholds = thresholds or DriftThresholds()
        self.job_timeout_s = resolve_job_timeout(job_timeout_s)
        self.config_kwargs = dict(config_kwargs or {})
        self.tenant = str(tenant)
        # the columnar warehouse (warehouse/): the watch loop is
        # its primary feeder, so — unlike the one-shot CLI — the dir
        # defaults ON, under the spool.  warehouse_format=off is the
        # opt-out (and the pyarrow-free mode); a missing pyarrow
        # degrades to off at first use, loudly, without failing cycles.
        if resolve_warehouse_format(warehouse_format) == "off":
            self.warehouse_dir: Optional[str] = None
        else:
            self.warehouse_dir = resolve_warehouse_dir(warehouse_dir) \
                or os.path.join(spool, "warehouse")
        self.stop_event = threading.Event()
        self.counts = {"ok": 0, "warn": 0, "drift": 0, "failed": 0}
        self.watches: List[SourceWatch] = []
        for src in sources:
            w = SourceWatch(self.root, src, self.keep)
            w.restore()
            self.watches.append(w)
            if w.recovered:
                # the manifest was torn: state was rebuilt from the
                # artifact chain — continuity is degraded (the alert
                # cursor restarted), and the operator must know
                self._alert(w, kind="corrupt_manifest",
                            severity="failed", cycle=w.cycle,
                            error=w.recovered)

    # -- one cycle ----------------------------------------------------------

    def run_cycle(self, w: SourceWatch) -> Dict[str, Any]:
        """Profile ``w.source`` once through the scheduler, persist the
        artifact, diff vs the baseline, alert, rotate, seal the
        manifest.  NEVER raises on a failing cycle — degraded-cycle
        semantics: the failure becomes a ``failed_cycle`` alert and the
        watch continues (the daemon's reason to exist is the NEXT
        cycle)."""
        t0 = time.perf_counter()
        cycle = w.cycle + 1
        art_path = w.artifact_path(cycle)
        # the job writes a job-PRIVATE .part file; the artifact enters
        # the retained chain only through the watcher's validate+rename
        # on confirmed success.  A watchdog-abandoned job body that
        # wakes up later and finishes its write can then never
        # resurrect a failed cycle's artifact into the chain (an
        # abandoned thread's late write that landed after the failure
        # path's unlink would become the newest "good" baseline).
        part_path = art_path + ".part"
        status = "ok"
        extra: Dict[str, Any] = {}
        try:
            _faults.hit("watch_cycle", key=cycle)
            kwargs = dict(self.config_kwargs)
            if self.job_timeout_s is not None:
                kwargs.setdefault("job_timeout_s", self.job_timeout_s)
            seed = self._seed_artifact(w)
            if seed is not None:
                # cycle N seeds its provisional bin edges from cycle
                # N−1's artifact (runtime/singlepass.py): with
                # profile_passes=fused an undrifted source's cycle is
                # ONE scan of K4 — the watch loop is the hit-rate-1.0
                # case by construction.  Harmless under two_pass
                # (ignored).
                kwargs.setdefault("seed_edges", seed)
            job = self.scheduler.submit(
                source=w.source, tenant=self.tenant, artifact=part_path,
                config_kwargs=kwargs)
            # the per-job watchdog is the hang protection; this wait
            # deadline only bounds the watcher when one is configured
            wait_s = None if self.job_timeout_s is None \
                else self.job_timeout_s + 600.0
            job = self.scheduler.wait(job, timeout=wait_s)
            if job.state != DONE:
                err = RuntimeError(
                    f"profile job {job.state}: {job.error}")
                err.exit_code = job.exit_code   # type: ignore[attr-defined]
                raise err
            from tpuprof_torch.artifact import compute_drift, read_artifact
            baseline = w.baseline(before=cycle)
            current = read_artifact(part_path)   # torn write -> typed
            os.replace(part_path, art_path)      # admit to the chain
            current.path = art_path
            if baseline is not None:
                drift = compute_drift(baseline, current, self.thresholds)
                s = drift["summary"]
                # the alert shape (verdict + capped flagged set) is the
                # shared definition the warehouse backtester replays
                status, flagged = drift_alert_shape(drift)
                extra = {"n_drift": s["n_drift"], "n_warn": s["n_warn"],
                         "row_delta": s["row_delta"]}
                if status == "ok":
                    # drift cleared: the next episode re-alerts
                    w.last_alert_key = None
                else:
                    self._alert(w, kind="drift", severity=status,
                                cycle=cycle, verdict=status,
                                n_drift=s["n_drift"],
                                n_warn=s["n_warn"],
                                columns=flagged,
                                baseline=baseline.path,
                                artifact=art_path)
            w.cycle = cycle
            w.last_artifact = art_path
            w.rotate()
            # append the columnar generation AFTER the JSON artifact is
            # admitted: the warehouse is derived truth — advisory to
            # the cycle (its failure can never fail a cycle), but the
            # JSON chain rotates at `keep` while this history only grows
            self._warehouse_append(w, current, cycle)
        except Exception as exc:        # noqa: BLE001 — a watch survives
            status = "failed"
            # the failed cycle's .part (absent, partial, or torn) is
            # worthless — drop it; a late write by an abandoned job
            # body leaves only a stray .part, which rotate() sweeps
            try:
                os.unlink(part_path)
            except OSError:
                pass
            code = getattr(exc, "exit_code", None)
            if code is None:
                code = exit_code(exc) if isinstance(exc, TYPED_ERRORS) \
                    else 1
            self._alert(w, kind="failed_cycle", severity="failed",
                        cycle=cycle,
                        error=f"{type(exc).__name__}: {exc}",
                        exit_code=code)
            w.cycle = cycle             # failed cycles count: artifact
                                        # names stay collision-free and
                                        # the cadence accounting honest
        seconds = time.perf_counter() - t0
        self.counts[status] = self.counts.get(status, 0) + 1
        if _obs_metrics.enabled():
            _CYCLES.inc(status=status)
            _CYCLE_SECONDS.observe(seconds)
        _obs_events.emit("watch_cycle", source=w.source, cycle=cycle,
                         status=status, seconds=round(seconds, 4),
                         artifact=w.last_artifact, **extra)
        self._save(w)
        return {"source": w.source, "cycle": cycle, "status": status,
                "seconds": seconds, **extra}

    def _seed_artifact(self, w: SourceWatch) -> Optional[str]:
        """The newest retained artifact path — the edge seed for the
        next cycle's fused profile.  Path-level only (no read here):
        the profile's seeder validates and degrades to the first-batch
        sketch if the file is torn, so a corrupt head can never fail a
        cycle through this seam."""
        if w.last_artifact and os.path.exists(w.last_artifact):
            return w.last_artifact
        chain = w.chain()
        return chain[0][1] if chain else None

    def _warehouse_append(self, w: SourceWatch, artifact,
                          cycle: int) -> None:
        """Feed the columnar warehouse (never raises — the cycle's
        truth is the JSON chain; the warehouse is the queryable twin)."""
        if self.warehouse_dir is None:
            return
        try:
            from tpuprof_torch.warehouse import append_artifact
            append_artifact(self.warehouse_dir, artifact,
                            source=w.source, generation=cycle)
        except WarehouseUnavailableError as exc:
            # no pyarrow on this box: degrade to warehouse_format=off
            # for the rest of the run — once, loudly, cycles unharmed
            blackbox.record("warehouse_unavailable", error=str(exc))
            self.warehouse_dir = None
        except Exception as exc:    # noqa: BLE001 — a watch survives
            blackbox.record("warehouse_write_failed", source=w.source,
                            cycle=cycle,
                            error=f"{type(exc).__name__}: {exc}")

    # -- alerts -------------------------------------------------------------

    def _alert(self, w: SourceWatch, *, kind: str, severity: str,
               cycle: int, **fields) -> Optional[Dict[str, Any]]:
        key = drift_episode_key(severity, fields.get("columns"))
        if kind == "drift" and w.last_alert_key == key:
            # dedup: the SAME ongoing drift episode (same severity, same
            # column set) does not re-alert every cycle — the cycle
            # record still carries the verdict, and any change in shape
            # (new column, warn->drift) is a new alert.  The dedup key
            # rides the manifest, so a restart does not re-fire it.
            return None
        w.alert_seq += 1
        alert = {"seq": w.alert_seq, "ts": round(time.time(), 3),
                 "source": w.source, "cycle": cycle, "kind": kind,
                 "severity": severity}
        alert.update(fields)
        w.alerts.append(alert)
        w.alerts = w.alerts[-ALERTS_CAP:]
        if kind == "drift":
            w.last_alert_key = key
        if _obs_metrics.enabled():
            _ALERTS.inc(severity=severity)
        # the JSONL twin ("kind" is the event discriminator, so the
        # alert's own kind rides as "alert")
        _obs_events.emit("drift_alert", alert=alert["kind"],
                         **{k: v for k, v in alert.items()
                            if k not in ("ts", "kind")})
        try:
            _atomic_write(w.alerts_path,
                          json.dumps(w.alerts, indent=1,
                                     default=str).encode())
        except OSError:
            pass        # the feed is best-effort; events/metrics rule
        return alert

    def _save(self, w: SourceWatch) -> None:
        write_manifest(w.manifest_path, {
            "source": w.source,
            "cycle": w.cycle,
            "last_artifact": w.last_artifact,
            "alert_seq": w.alert_seq,
            "last_alert_key": w.last_alert_key,
            "keep": w.keep,
            "updated_unix": round(time.time(), 3),
        })

    # -- the loop -----------------------------------------------------------

    def run(self, cycles: Optional[int] = None) -> None:
        """Watch until :attr:`stop_event` (or for ``cycles`` rounds over
        every source — the CI/bench mode)."""
        done = 0
        while not self.stop_event.is_set():
            for w in self.watches:
                if self.stop_event.is_set():
                    return
                self.run_cycle(w)
            done += 1
            if cycles is not None and done >= cycles:
                return
            self.stop_event.wait(self.every_s)

    def stats(self) -> Dict[str, Any]:
        return {
            "sources": len(self.watches),
            "cycles": dict(self.counts),
            "alerts": sum(len(w.alerts) for w in self.watches),
            "every_s": self.every_s,
            "keep": self.keep,
        }
