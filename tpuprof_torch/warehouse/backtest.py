"""Alert backtesting — replay a threshold change against a retained
artifact chain.

Counterpart of ``tpuprof/warehouse/backtest.py``, with its
``tpuprof-backtest-v1`` document.  ``backtest SOURCE --psi-threshold X``
answers *had the watch run with THESE bands, which cycles would have
alerted?* without re-profiling anything.  The replay walks the retained
JSON chain (``watch/<key>/cycle_*.artifact.json``) oldest-first and re-runs
the live loop's decision chain per cycle:

* the drift report from the SAME engine (``compute_drift``) against the
  SAME baseline semantics (the last readable artifact — a corrupt retained
  generation is walked past, like the live baseline walk);
* the alert shape from the SAME definition the live loop uses
  (serve/watch.drift_alert_shape — verdict + capped flagged set);
* the SAME episode dedup (serve/watch.drift_episode_key — an ongoing drift
  with an unchanged shape alerts once, an ``ok`` cycle re-arms).

Because every rule is imported from the watch module, a backtest at the
live thresholds reproduces the live alert set exactly, and a backtest at
changed thresholds is what the live watch WOULD have raised.  The replay
sees what retention kept: ``artifact_keep`` generations.
"""

from __future__ import annotations

import os
import re
import time
from typing import Any, Dict, List, Optional, Tuple

from tpuprof_torch.errors import CorruptArtifactError, InputError
from tpuprof_torch.obs import blackbox
from tpuprof_torch.obs import events as _obs_events
from tpuprof_torch.obs import metrics as _obs_metrics

BACKTEST_SCHEMA = "tpuprof-backtest-v1"

_CYCLE_RE = re.compile(r"cycle_(\d{8})\.artifact\.json$")

_BACKTESTS = _obs_metrics.counter(
    "tpuprof_backtests_total", "alert backtests replayed")
_BACKTEST_SECONDS = _obs_metrics.histogram(
    "tpuprof_backtest_seconds",
    "wall seconds per alert backtest (chain read + drift replays)")


def chain_dir(spool: Optional[str], source: Any) -> str:
    """Resolve the retained-chain directory for ``source``: a directory
    that itself holds ``cycle_*.artifact.json`` is used as-is, else the
    watch layout under the spool (``SPOOL/watch/<source-key>``)."""
    from tpuprof_torch.serve.watch import source_key
    text = str(source)
    if os.path.isdir(text) and _has_cycles(text):
        return text
    if not spool:
        raise InputError(
            f"{text!r} is not a retained-chain directory and no --spool "
            "was given — pass the watch daemon's spool so the chain "
            "resolves to SPOOL/watch/<source-key>/")
    return os.path.join(spool, "watch", source_key(source))


def _has_cycles(path: str) -> bool:
    try:
        names = os.listdir(path)
    except OSError:
        return False
    return any(_CYCLE_RE.match(n) for n in names)


def chain(dirpath: str) -> List[Tuple[int, str]]:
    """Retained ``(cycle, path)`` artifacts, OLDEST first (a replay is
    a time series)."""
    out = []
    try:
        names = os.listdir(dirpath)
    except OSError:
        return []
    for name in names:
        m = _CYCLE_RE.match(name)
        if m:
            out.append((int(m.group(1)), os.path.join(dirpath, name)))
    return sorted(out)


def backtest(dirpath: str, thresholds) -> Dict[str, Any]:
    """Replay ``thresholds`` over the retained chain at ``dirpath``.
    Returns the ``tpuprof-backtest-v1`` document: one record per
    retained cycle plus the alert set the live watch would have
    raised under these bands."""
    from tpuprof_torch.artifact import compute_drift, read_artifact
    from tpuprof_torch.serve.watch import drift_alert_shape, drift_episode_key

    t0 = time.perf_counter()
    retained = chain(dirpath)
    if not retained:
        raise InputError(
            f"no retained cycle artifacts under {dirpath!r} — the "
            "watch loop has not fed this chain (or retention rotated "
            "everything away; raise --keep)")
    cycles: List[Dict[str, Any]] = []
    alerts: List[Dict[str, Any]] = []
    baseline = None                 # the last READABLE artifact
    last_key: Optional[List[Any]] = None
    for cyc, path in retained:
        try:
            current = read_artifact(path)
        except (CorruptArtifactError, OSError) as exc:
            # the live loop would have walked past this generation at
            # baseline time; at replay time it is simply unknowable
            blackbox.record("backtest_skip", path=path,
                            error=f"{type(exc).__name__}: {exc}")
            cycles.append({"cycle": cyc, "status": "unreadable",
                           "alerted": False})
            continue
        if baseline is None:
            cycles.append({"cycle": cyc, "status": "baseline",
                           "alerted": False})
            baseline = current
            continue
        drift = compute_drift(baseline, current, thresholds)
        s = drift["summary"]
        status, flagged = drift_alert_shape(drift)
        record = {"cycle": cyc, "status": status,
                  "n_drift": s["n_drift"], "n_warn": s["n_warn"],
                  "alerted": False}
        if status == "ok":
            last_key = None
        else:
            key = drift_episode_key(status, flagged)
            if key != last_key:
                record["alerted"] = True
                alerts.append({"cycle": cyc, "severity": status,
                               "columns": flagged,
                               "n_drift": s["n_drift"],
                               "n_warn": s["n_warn"]})
                last_key = key
        cycles.append(record)
        baseline = current
    seconds = time.perf_counter() - t0
    doc = {
        "schema": BACKTEST_SCHEMA,
        "chain": dirpath,
        "thresholds": thresholds.as_dict(),
        "cycles": cycles,
        "alerts": alerts,
        "summary": {
            "cycles": len(cycles),
            "alerts": len(alerts),
            "drift_cycles": sum(1 for c in cycles
                                if c.get("status") == "drift"),
            "warn_cycles": sum(1 for c in cycles
                               if c.get("status") == "warn"),
            "unreadable": sum(1 for c in cycles
                              if c.get("status") == "unreadable"),
        },
    }
    if _obs_metrics.enabled():
        _BACKTESTS.inc()
        _BACKTEST_SECONDS.observe(seconds)
        _obs_events.emit("backtest", chain=dirpath,
                         cycles=len(cycles), alerts=len(alerts),
                         seconds=round(seconds, 4))
    return doc
