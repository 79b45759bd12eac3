"""Live progress / heartbeat layer (counterpart of
``tpuprof/obs/progress.py``).

Two consumers:

* ``StreamingProfiler.heartbeat()`` / ``.progress()`` — an in-process
  pull API: rows folded, batches, buffered rows, and a rows/s EMA that
  tracks the recent rate rather than the lifetime average (a stalled
  stream reads ~0, not its historical glory).
* the CLI ticker (``--progress`` / ``--metrics-interval``) — a daemon
  thread that periodically prints a one-line status to stderr and/or
  emits a metrics snapshot into the JSONL sink while a (possibly
  hour-long) profile runs, reading the process-wide registry the
  pipeline is already updating.
"""

from __future__ import annotations

import sys
import threading
import time
from typing import Callable, Dict, Optional

from tpuprof_torch.obs import events, metrics


class RateEMA:
    """Exponentially-decayed rate estimator (rows/s).

    ``update(n)`` adds n units at *now*; the rate halves its memory
    every ``halflife`` seconds of silence, so bursts decay and a stall
    converges to 0 instead of freezing the last burst's figure."""

    def __init__(self, halflife: float = 10.0,
                 clock: Callable[[], float] = time.monotonic):
        self.halflife = float(halflife)
        self._clock = clock
        self._lock = threading.Lock()
        self._rate = 0.0
        self._acc = 0.0                     # units since the last blend
        self._t_last: Optional[float] = None

    def update(self, n: float) -> None:
        now = self._clock()
        with self._lock:
            if self._t_last is None:        # first sample starts the clock
                self._t_last = now
                self._acc = float(n)
                return
            self._acc += float(n)
            dt = now - self._t_last
            if dt <= 0:                     # same-instant bursts coalesce
                return
            inst = self._acc / dt
            alpha = 1.0 - 0.5 ** (dt / self.halflife)
            self._rate += alpha * (inst - self._rate)
            self._acc = 0.0
            self._t_last = now

    def rate(self) -> float:
        now = self._clock()
        with self._lock:
            if self._t_last is None:
                return 0.0
            # silence decays the estimate toward 0 — read-only (the next
            # update blends from the undecayed state, which is fine: its
            # alpha covers the same silent window)
            dt = max(now - self._t_last, 0.0)
            return self._rate * 0.5 ** (dt / self.halflife)


def fmt_rate(rows_per_sec: float) -> str:
    if rows_per_sec >= 1e6:
        return f"{rows_per_sec / 1e6:.2f}M rows/s"
    if rows_per_sec >= 1e3:
        return f"{rows_per_sec / 1e3:.1f}k rows/s"
    return f"{rows_per_sec:,.0f} rows/s"


def registry_progress_line(reg: Optional[metrics.MetricsRegistry] = None
                           ) -> str:
    """One-line pipeline status assembled from the standard counters
    (OBSERVABILITY.md names) — what ``--progress`` prints."""
    r = reg if reg is not None else metrics.registry()
    rows = r.counter("tpuprof_ingest_rows_total").total()
    batches = r.counter("tpuprof_ingest_batches_total").total()
    # the <program>_batches series are batches-per-staged-dispatch
    # bookkeeping, not dispatches — same exclusion as the report footer
    disp = sum(v for k, v in
               r.counter("tpuprof_device_dispatch_total").items()
               if not any(lv.endswith("_batches") for _, lv in k))
    ckpt = r.counter("tpuprof_checkpoint_saves_total").total()
    parts = [f"{int(rows):,} rows", f"{int(batches)} batches",
             f"{int(disp)} dispatches"]
    if ckpt:
        parts.append(f"{int(ckpt)} checkpoints")
    return " · ".join(parts)


class Ticker:
    """Daemon thread driving the periodic jobs: a stderr progress line,
    a JSONL metrics snapshot, or both.  ``stop()`` is idempotent and
    joins the thread so tests never leak tickers."""

    def __init__(self, interval: float, progress: bool = False,
                 snapshots: bool = False, stream=None):
        self.interval = max(float(interval), 0.1)
        self.progress = progress
        self.snapshots = snapshots
        self.stream = stream if stream is not None else sys.stderr
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._t0 = time.monotonic()
        self._last_rows = 0.0
        self.stop_timed_out = False     # a stop() join that expired
        # with the tick thread still alive (e.g. a tick blocked on a
        # wedged stream) — flagged, and _tick's stop guard keeps the
        # orphan from ever printing/emitting into a closed profiler

    def _tick(self) -> None:
        if self._stop.is_set():
            # stop() may expire its join while a tick is queued behind
            # a slow write; the guard makes the orphan tick a no-op
            # instead of emitting into a finished (or closed) run
            return
        if self.snapshots:
            events.emit_snapshot(reason="interval")
        if self.progress:
            rows = metrics.registry().counter(
                "tpuprof_ingest_rows_total").total()
            dt = time.monotonic() - self._t0
            rate = (rows - self._last_rows) / self.interval
            self._last_rows = rows
            print(f"tpuprof_torch: [{dt:7.1f}s] "
                  f"{registry_progress_line()} · {fmt_rate(rate)}",
                  file=self.stream)

    def _run(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self._tick()
            except Exception:   # a broken pipe must not kill the ticker
                return

    def start(self) -> "Ticker":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run, daemon=True,
                name="tpuprof-torch-obs-ticker")
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        thread = self._thread
        if thread is not None:
            thread.join(timeout=2.0)
            if thread.is_alive():
                # the join can expire with the thread still inside a
                # blocked tick; before this flag existed the orphan
                # kept ticking into whatever came next.  The daemon
                # thread dies with the process; the _tick stop guard
                # silences it until then.
                self.stop_timed_out = True
                events.emit("ticker_stop_timeout",
                            interval=self.interval)
            self._thread = None

    def __enter__(self) -> "Ticker":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
