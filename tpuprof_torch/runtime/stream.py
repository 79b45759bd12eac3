"""A profile maintained over a stream of micro-batches.

Counterpart of ``tpuprof/runtime/stream.py``.  :class:`StreamingProfiler`
takes pandas frames, Arrow tables or record batches as they arrive,
coalesces them into device batches of ``batch_rows`` rows (or
``stream_flush_rows``), folds each into the pass-A state (kernel K1 through
``Runner.step_a``; with ``profile_passes="fused"`` K4 through
``Runner.step_ab``, which also folds the histograms on provisional edges),
and snapshots the stats dict at any moment: a snapshot folds the buffered
rows first, so it covers every row ever passed to :meth:`update`.

A stream has no second pass.  Its snapshot is the single-pass tier, as
the reference's: exact moments, min/max, zeros, infinities, bool and date
statistics; quantiles, histograms and MAD from the row sample; distinct
counts from HLL; Misra-Gries top-k; Spearman from the sample, flagged
approximate.  A fused stream adopts the exact histogram and MAD of every
lane whose provisional edges equal the exact bounds at the snapshot.

:meth:`checkpoint` / :meth:`restore` carry the whole fold state across
processes (``runtime/checkpoint.py``), :meth:`export_payload` /
:meth:`from_payload` hand it to fold-state artifacts
(``artifact/store.py``, ``artifact/incremental.py``).  The device is
explicit: ``cuda:0`` by default, the CPU only when asked for.

With ``exact_distinct`` the stream keeps exact distinct counts, spilling
past the tracker's budgets (``kernels/unique.py``).  A checkpoint or a
fold-state artifact references the spill runs by path, so from then on
they survive a crash; :meth:`close` (or leaving a ``with`` block without an
error) deletes them.  ``parity`` needs a second pass and is refused.

Telemetry: the constructor applies the config's metrics fields
(``obs.configure_from_config``); each drain is a ``drain`` span, counts
the batches and rows it folded (``tpuprof_stream_*``), its seconds and the
share of them not spent waiting on the prepare, and samples the memory
gauges; :meth:`heartbeat` emits a ``heartbeat`` event and leaves its
reading on the flight recorder's context card; a snapshot with metrics on
carries the registry's snapshot as ``stats["_obs"]``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Optional, Sequence

import pandas as pd
import pyarrow as pa

from tpuprof_torch import native, obs
from tpuprof_torch.config import (ProfilerConfig, resolve_checkpoint_keep,
                                  resolve_ingest_retries,
                                  resolve_max_quarantined,
                                  resolve_prepare_workers,
                                  resolve_profile_passes,
                                  resolve_quarantine_log,
                                  resolve_retry_backoff,
                                  resolve_watchdog_timeout)
from tpuprof_torch.errors import InputError
from tpuprof_torch.ingest import prep
from tpuprof_torch.ingest.arrow import (ColumnPlan, _DictionaryCache,
                                        prepare_batch, validate_projection)
from tpuprof_torch.ingest.sample import RowSampler
from tpuprof_torch.kernels import corr as kcorr
from tpuprof_torch.kernels import histogram as khistogram
from tpuprof_torch.kernels import hll as khll
from tpuprof_torch.kernels import moments as kmoments
from tpuprof_torch.obs import metrics as _obs_metrics
from tpuprof_torch.obs.progress import RateEMA, fmt_rate
from tpuprof_torch.runtime import checkpoint as ckpt
from tpuprof_torch.runtime import guard, singlepass
from tpuprof_torch.runtime.runner import state_from_numpy, state_to_numpy
from tpuprof_torch.serve.cache import acquire_runner
from tpuprof_torch.testing import faults

_BATCHES_FOLDED = _obs_metrics.counter(
    "tpuprof_stream_batches_folded_total",
    "device batches folded into the streaming state")
_STREAM_ROWS = _obs_metrics.counter(
    "tpuprof_stream_rows_total", "rows folded through the stream")
_DRAIN_SECONDS = _obs_metrics.histogram(
    "tpuprof_stream_drain_seconds",
    "wall seconds per buffer drain (prep + device folds)")
_OVERLAP_RATIO = _obs_metrics.gauge(
    "tpuprof_stream_prefetch_overlap_ratio",
    "share of the last multi-slice drain NOT spent waiting on prep "
    "(1.0 = prep fully hidden under device folds)")


def _to_record_batches(batch: Any, schema: Optional[pa.Schema]):
    if isinstance(batch, pd.DataFrame):
        got = list(batch.columns)
        expected = schema.names if schema is not None else got
        if got != list(expected):
            raise ValueError(
                f"micro-batch columns {got} do not match the stream schema "
                f"{list(expected)} — column sets must be stable over a "
                f"stream (sketch lanes are fixed shapes)")
        table = pa.Table.from_pandas(batch, preserve_index=False,
                                     schema=schema)
        return table.to_batches()
    if isinstance(batch, (pa.Table, pa.RecordBatch)):
        if schema is not None and (batch.schema.names != schema.names
                                   or batch.schema.types != schema.types):
            # names AND types up front: a cast failure halfway through a
            # drain would leave the state partly updated
            raise ValueError(
                f"micro-batch schema {batch.schema} does not match the "
                f"stream schema {schema}")
        return batch.to_batches() if isinstance(batch, pa.Table) \
            else [batch]
    raise TypeError(f"cannot stream {type(batch)!r}")


def _project_batch(batch: Any, cols: Sequence[str]) -> Any:
    """``batch`` without the columns outside the projection; a batch that
    lacks a projected column passes as it is, so the schema check names
    the problem."""
    if isinstance(batch, pd.DataFrame):
        by_str = {str(c): c for c in batch.columns}
        if all(c in by_str for c in cols):
            return batch[[by_str[c] for c in cols]]
        return batch
    if isinstance(batch, (pa.Table, pa.RecordBatch)):
        if all(c in batch.schema.names for c in cols):
            return batch.select(list(cols))
        return batch
    return batch


class StreamingProfiler:
    """A live, mergeable profile over an unbounded stream.

    >>> prof = StreamingProfiler.for_example(first_frame)
    >>> for frame in stream:
    ...     prof.update(frame)
    >>> stats = prof.stats()
    """

    def __init__(self, arrow_schema: pa.Schema,
                 config: Optional[ProfilerConfig] = None, device=None):
        from tpuprof_torch.backends.gpu import HostAgg
        config = config or ProfilerConfig()
        if config.parity:
            # before the replace below, whose validation would blame the
            # single-pass mode for an option the user never set
            raise InputError(
                "parity is not supported for streaming: an unbounded "
                "stream has no second exact pass (histograms/top-k stay "
                "sketch-derived).  For the stream's exact tier set "
                "exact_distinct=True (with unique_spill_dir) and "
                "spearman=True explicitly")
        # a stream has no second pass
        self.config = dataclasses.replace(config, exact_passes=False)
        if self.config.columns is not None:
            cols = validate_projection(self.config.columns,
                                       arrow_schema.names)
            arrow_schema = pa.schema([arrow_schema.field(c) for c in cols])
        self.arrow_schema = arrow_schema
        self.plan = ColumnPlan.from_schema(arrow_schema,
                                           nested=self.config.nested)
        # through the runner cache's acquire seam, as every profile
        self.runner = acquire_runner(self.config, self.plan.n_num,
                                     self.plan.n_hash, [device])
        self.hostagg = HostAgg(self.plan, self.config)
        self.sampler = RowSampler(self.config.quantile_sketch_size,
                                  self.plan.n_num, seed=self.config.seed)
        self.host_hll = khll.HostRegisters(
            self.plan.n_hash, self.config.hll_precision) \
            if self.plan.n_hash > 0 and native.available() else None
        # created at the first folded batch, so K1's shift comes from data
        self.state = None
        self.cursor = 0                      # device batches folded
        # fused streams bin every batch on provisional edges: the seed
        # artifact's, else the first batch's sketch
        self._fused = resolve_profile_passes(self.config.profile_passes) \
            == "fused" and self.plan.n_num > 0
        self._hist_state = None
        self._sp_edges = singlepass.resolve_seeds(self.config, self.plan) \
            if self._fused else None
        self._sp_eds_d = None
        self._sample: Optional[pd.DataFrame] = None
        # micro-batches coalesce to full device batches; a snapshot or a
        # checkpoint folds the remainder first
        self._flush_rows = self.config.stream_flush_rows \
            if self.config.stream_flush_rows is not None \
            else self.runner.rows
        self._buf: list = []                 # pending pa.RecordBatches
        self._buf_rows = 0
        self._dict_cache = _DictionaryCache()
        self._col_stats: Dict[str, int] = {}
        obs.configure_from_config(self.config)
        self._t_start = time.monotonic()
        self._rate_ema = RateEMA(halflife=10.0)
        self._quarantine = guard.Quarantine(
            resolve_max_quarantined(self.config.max_quarantined),
            log_path=resolve_quarantine_log(self.config.quarantine_log))
        self._batch_guard = guard.BatchGuard(
            resolve_ingest_retries(self.config.ingest_retries),
            resolve_retry_backoff(self.config.retry_backoff_s),
            capture=self._quarantine.enabled)
        self._drain_timeout = resolve_watchdog_timeout(
            self.config.drain_timeout_s, "TPUPROF_DRAIN_TIMEOUT_S")
        self._ckpt_keep = resolve_checkpoint_keep(self.config.checkpoint_keep)
        self._slice_seq = 0     # each slice's key (faults, the manifest)
        self._closed = False

    @classmethod
    def for_example(cls, example: Any, **kwargs) -> "StreamingProfiler":
        """A profiler whose Arrow schema is that of an example frame, table
        or record batch (the whole example: a leading run of nulls would
        type a column as Arrow null)."""
        if isinstance(example, pd.DataFrame):
            schema = pa.Table.from_pandas(example,
                                          preserve_index=False).schema
        elif isinstance(example, (pa.Table, pa.RecordBatch)):
            schema = example.schema
        else:
            raise TypeError(f"cannot infer schema from {type(example)!r}")
        return cls(schema, **kwargs)

    # -- ingestion ---------------------------------------------------------

    def update(self, batch: Any) -> None:
        """Buffer one micro-batch; fold whenever a full flush quantum has
        accumulated."""
        if self.config.columns is not None:
            batch = _project_batch(batch, self.config.columns)
        for rb in _to_record_batches(batch, self.arrow_schema):
            if self._sample is None \
                    or len(self._sample) < self.config.sample_rows:
                head = pa.Table.from_batches([rb]).to_pandas().head(
                    self.config.sample_rows)
                self._sample = head if self._sample is None else pd.concat(
                    [self._sample, head], ignore_index=True).head(
                        self.config.sample_rows)
            if rb.schema != self.arrow_schema:
                # names and types were checked: this normalizes nullability
                # and metadata, which Table.from_batches compares strictly
                rb = rb.cast(self.arrow_schema)
            self._buf.append(rb)
            self._buf_rows += rb.num_rows
        if self._buf_rows >= self._flush_rows:
            with obs.span("drain", rows=int(self._buf_rows)):
                self._drain(force=False)

    def _prepare_slice(self, tbl: pa.Table, workers: int):
        rbs = tbl.combine_chunks().to_batches()
        if not rbs:
            return None
        from tpuprof_torch.config import resolve_prep_workers
        return prepare_batch(
            rbs[0], self.plan, self.runner.rows, self.config.hll_precision,
            dict_cache=self._dict_cache, col_stats=self._col_stats,
            decode_threads=resolve_prep_workers(self.config.prep_workers,
                                                batch_workers=workers),
            full_hashes=self.config.exact_distinct)

    def _fold_prepared(self, hb) -> None:
        """Fold one prepared batch, in stream order: the device step, the
        sampler, the HLL registers and the host aggregators."""
        if hb is None:
            return
        from tpuprof_torch.backends.gpu import estimate_shift
        if self.state is None:
            self.state = self.runner.init_pass_a(estimate_shift(hb))
        db = self.runner.put_batch(hb, with_hll=self.host_hll is None)
        if self._fused:
            if self._hist_state is None:
                self._sp_edges = singlepass.sketch_edges(
                    hb.x, hb.nrows, into=self._sp_edges)
                self._hist_state = self.runner.init_pass_b()
            if self._sp_eds_d is None:
                self._sp_eds_d = tuple(
                    self.runner.put_replicated(a) for a in (
                        self._sp_edges.lo, self._sp_edges.hi,
                        self._sp_edges.mean))
            self.state, self._hist_state = self.runner.step_ab(
                self.state, self._hist_state, db, *self._sp_eds_d)
        else:
            self.state = self.runner.step_a(self.state, db)
        self.sampler.update(hb.x, hb.nrows)
        if self.host_hll is not None:
            self.host_hll.update(hb.hll, hb.nrows)
        self.hostagg.update(hb)
        self.cursor += 1
        self._rate_ema.update(hb.nrows)
        _BATCHES_FOLDED.inc()
        _STREAM_ROWS.inc(hb.nrows)

    def _drain(self, force: bool) -> None:
        """Fold the buffered rows: every full device batch, and the partial
        rest when forced (a snapshot, a checkpoint) or when the flush
        quantum is below the device batch.  Several slices prepare on the
        shared batch pool while earlier ones fold, delivered in order, so
        the cursor and the sample are the serial stream's."""
        if not self._buf_rows:
            return
        t0 = time.perf_counter()
        rows = self.runner.rows
        tbl = pa.Table.from_batches(self._buf)
        n, pos = tbl.num_rows, 0
        slices = []
        while n - pos >= rows:
            slices.append(tbl.slice(pos, rows))
            pos += rows
        if pos < n and (force or self._flush_rows < rows):
            slices.append(tbl.slice(pos))
            pos = n
        rem = tbl.slice(pos)
        self._buf = rem.to_batches() if rem.num_rows else []
        self._buf_rows = rem.num_rows
        w = resolve_prepare_workers(self.config.prepare_workers) \
            if len(slices) > 1 else 1
        seq0 = self._slice_seq
        self._slice_seq += len(slices)

        def _prepare(pair):
            idx, part = pair
            return self._batch_guard.run(
                lambda: self._prepare_slice(part, w), site="prep", key=idx,
                rows=part.num_rows)

        # the drain's wall splits into waiting on the prepare and folding:
        # their ratio is the prefetch-overlap gauge
        wait_s = 0.0
        done = object()     # ordered_map may yield None for an empty slice
        it = iter(prep.ordered_map(list(enumerate(slices, start=seq0)),
                                   _prepare, workers=w, depth=2))
        while True:
            tw = time.perf_counter()
            hb = next(it, done)
            wait_s += time.perf_counter() - tw
            if hb is done:
                break
            if isinstance(hb, guard.PoisonBatch):
                # failed past its retries: skipped, the stream goes on
                self._quarantine.admit(site=hb.site, error=hb.error,
                                       cursor=self.cursor, rows=hb.rows)
                continue
            try:
                faults.hit("fold", key=self.cursor)
                self._fold_prepared(hb)
            except Exception as exc:
                if not self._quarantine.enabled:
                    raise
                # a fold is not idempotent: never retried, skipped
                self._quarantine.admit(
                    site="fold", error=exc, cursor=self.cursor,
                    rows=hb.nrows if hb is not None else None)
        if self._drain_timeout and self.state is not None:
            # a wedged device raises WatchdogTimeout with a heartbeat
            self.runner.wait_ready(self.state, self._drain_timeout,
                                   heartbeat=self.heartbeat)
        if obs.enabled():
            dt = time.perf_counter() - t0
            _DRAIN_SECONDS.observe(dt)
            if len(slices) > 1 and dt > 0:
                _OVERLAP_RATIO.set(max(0.0, 1.0 - wait_s / dt))
            obs.memory.sample(self.runner.device)

    # -- liveness ----------------------------------------------------------

    def heartbeat(self) -> Dict[str, Any]:
        """A cheap liveness snapshot with no drain and no device wait: rows
        folded and buffered, batches folded, the recent rows/s (a 10 s
        half-life average) and the uptime.  Safe from another thread.
        Also a ``heartbeat`` event (the sink, if any, and the flight
        recorder), whose reading rides the postmortem context card."""
        hb = {
            "rows_folded": int(self.hostagg.n_rows),
            "rows_buffered": int(self._buf_rows),
            "batches_folded": int(self.cursor),
            "rows_per_sec_ema": round(self._rate_ema.rate(), 1),
            "uptime_s": round(time.monotonic() - self._t_start, 3),
            "columns": len(self.plan.specs),
        }
        obs.emit("heartbeat", **hb)
        obs.blackbox.set_context(last_heartbeat=hb)
        return hb

    def progress(self) -> str:
        """One human line from :meth:`heartbeat`."""
        hb = self.heartbeat()
        return (f"{hb['rows_folded']:,} rows folded "
                f"(+{hb['rows_buffered']:,} buffered) · "
                f"{hb['batches_folded']} batches · "
                f"{fmt_rate(hb['rows_per_sec_ema'])} · "
                f"up {hb['uptime_s']:.0f}s")

    # -- snapshots ---------------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        """The stats dict now (streaming goes on).  Buffered rows fold
        first, so a snapshot covers every row passed to :meth:`update`."""
        from tpuprof_torch.backends.gpu import _assemble, _empty_stats
        from tpuprof_torch.schema import VariablesView
        if not self.plan.specs:
            stats = _empty_stats(self.config)
            stats["variables"] = VariablesView(stats["variables"])
            return stats
        with obs.span("drain", rows=int(self._buf_rows), forced=True):
            self._drain(force=True)
        state = self.state if self.state is not None \
            else self.runner.init_pass_a()
        res = self.runner.finalize_a(state)
        momf = kmoments.finalize(res["mom"])
        probes = list(self.config.quantile_probes)
        sample_vals, sample_kept = self.sampler.columns()
        hll_regs = self.host_hll.regs if self.host_hll is not None \
            else res["hll"]
        rho_spear = None
        if self.config.spearman and self.plan.n_num > 1 \
                and self.hostagg.n_rows > 0:
            # single pass: from the K-row sample, flagged approximate
            rho_spear = self.sampler.spearman()
        # fused: the exact histogram and MAD of every lane whose edges
        # equal the exact bounds at this snapshot; the sample tier for the
        # rest, as a two-pass stream
        hists = mad = exact_lanes = None
        if self._fused and self._hist_state is not None \
                and self.hostagg.n_rows > 0:
            exact = singlepass.exact_triple(
                self.runner.bounds_b_device(state))
            hits = singlepass.hit_lanes(self._sp_edges, exact)
            if hits.any():
                hists, mad = khistogram.finalize(
                    self.runner.finalize_b(self._hist_state), momf["fmin"],
                    momf["fmax"], momf["n"], self.config.bins)
                exact_lanes = None if hits.all() else hits
        stats = _assemble(
            self.plan, self.config,
            self._sample if self._sample is not None else pd.DataFrame(),
            self.hostagg, momf, kcorr.finalize(res["corr"]),
            self.sampler.quantiles(probes), sample_vals, sample_kept,
            khll.finalize(hll_regs), hists, mad, None, probes,
            rho_spear=rho_spear, spear_approx=True,
            exact_lanes=exact_lanes)
        stats["variables"] = VariablesView(stats["variables"])
        if self._quarantine.entries:
            # degraded streams only: a clean snapshot is as before
            stats["_quarantine"] = list(self._quarantine.entries)
        snap = obs.snapshot_if_enabled()
        if snap is not None:
            stats["_obs"] = snap
        return stats

    def report_html(self) -> str:
        from tpuprof_torch.report.render import to_standalone_html
        return to_standalone_html(self.stats(), self.config)

    # -- durability --------------------------------------------------------

    def export_payload(self) -> Dict[str, Any]:
        """Fold the buffer, then the whole durable state as one dict
        ``{"state", "host_blob", "config", "cursor", "meta"}`` without
        writing anything: what :meth:`checkpoint` saves and what a
        fold-state artifact embeds.  The payload references the spill runs
        by path, so they are marked to survive a crash."""
        with obs.span("drain", rows=int(self._buf_rows), forced=True):
            self._drain(force=True)
        self.hostagg.unique.persistent = True
        host_blob = {
            "hostagg": self.hostagg,
            "sampler": self.sampler,
            "host_hll": self.host_hll,
            "sample": self._sample,
            "schema": self.arrow_schema.serialize().to_pybytes(),
        }
        if self._quarantine.entries:
            host_blob["quarantine"] = list(self._quarantine.entries)
        if self._fused:
            # the histogram fold and the edges it bins on: a resume that
            # binned the rest on other edges would mix bin layouts
            host_blob["singlepass"] = {
                "hist": state_to_numpy(self._hist_state)
                if self._hist_state is not None else None,
                "edges": self._sp_edges.as_blob()
                if self._sp_edges is not None else None,
            }
        return {
            "state": self.state,
            "host_blob": host_blob,
            "config": self.config,
            "cursor": self.cursor,
            "meta": {"n_num": self.plan.n_num, "n_hash": self.plan.n_hash,
                     "batch_rows": self.config.batch_rows,
                     "has_state": self.state is not None,
                     # HLL registers merge only with same-route hashes
                     "native_hash": native.available()},
        }

    def checkpoint(self, path: str) -> int:
        """Save the fold state atomically (the buffer folds first: the
        checkpoint covers every row passed to :meth:`update`).  Returns
        the file's size in bytes."""
        # queued spill writes land first: a checkpoint references durable
        # runs only (pickling drains too; this orders it explicitly)
        self.hostagg.unique.flush_spills()
        payload = self.export_payload()
        size = ckpt.save(path, payload["state"], payload["host_blob"],
                         payload["cursor"], meta=payload["meta"],
                         keep=self._ckpt_keep)
        # runs dropped since the previous save are referenced no more
        self.hostagg.unique.reap_retired()
        return size

    def close(self) -> None:
        """Release the stream's disk working space, the spill runs of
        ``exact_distinct``: once a checkpoint or an artifact references
        them they outlive the process by design, until this is called.
        Snapshots are invalid afterwards, so take the last ``stats()``
        first.  Idempotent."""
        if self._closed:
            return
        self._closed = True
        self.hostagg.unique.cleanup()

    def __enter__(self) -> "StreamingProfiler":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        # an error leaving the block is the crash a checkpoint promises to
        # survive: once a save references the runs, they stay for restore
        if exc_type is None or not self.hostagg.unique.persistent:
            self.close()

    @classmethod
    def restore(cls, path: str, config: Optional[ProfilerConfig] = None,
                device=None) -> "StreamingProfiler":
        """A profiler from the newest good generation of a checkpoint
        chain, ready to go on streaming."""
        payload, _used = ckpt.restore_payload(path)
        return cls.from_payload(payload, config=config, device=device)

    @classmethod
    def from_payload(cls, payload: Dict[str, Any],
                     config: Optional[ProfilerConfig] = None,
                     device=None) -> "StreamingProfiler":
        """The twin of :meth:`export_payload`: a profiler whose state is
        the payload's (its ``arrays_npz`` archive holds the device state).
        ``config`` defaults to the one the payload carries (an artifact's;
        a checkpoint carries none, and then the default applies)."""
        if config is None:
            config = payload.get("config")
        host_blob = payload["host_blob"]
        saved_native = payload["meta"].get("native_hash")
        if saved_native is not None and saved_native != native.available():
            raise ValueError(
                "checkpoint was written with "
                f"{'native' if saved_native else 'pandas'} hashing but this "
                "process has the other implementation — HLL registers would "
                "not merge consistently")
        arrow_schema = pa.ipc.read_schema(pa.py_buffer(host_blob["schema"]))
        prof = cls(arrow_schema, config=config, device=device)
        if payload["meta"].get("has_state", True):
            prof.state = ckpt.materialize(payload, prof.runner.init_pass_a(),
                                          prof.runner.device)
        prof.hostagg = host_blob["hostagg"]
        saved_sampler = host_blob["sampler"]
        if saved_sampler.k != prof.config.quantile_sketch_size:
            raise ValueError(
                f"checkpoint sampler has k={saved_sampler.k} but config "
                f"requests quantile_sketch_size="
                f"{prof.config.quantile_sketch_size} — the sample cannot "
                "be re-sized after the fact")
        prof.sampler = saved_sampler
        saved_hll = host_blob.get("host_hll")
        if saved_hll is not None:
            m = saved_hll.regs.shape[1]
            if m != 1 << prof.config.hll_precision:
                raise ValueError(
                    f"checkpoint HLL registers are {m} wide but config "
                    f"requests hll_precision={prof.config.hll_precision} "
                    f"(2^p={1 << prof.config.hll_precision}) — register "
                    "planes of different widths cannot merge")
        prof.host_hll = saved_hll
        prof._sample = host_blob["sample"]
        sp = host_blob.get("singlepass")
        cursor = int(payload.get("cursor") or 0)
        if sp is not None and not prof._fused and cursor > 0:
            raise ValueError(
                "checkpoint was written by a fused (single-pass) profiler "
                "but this config resolves profile_passes=two_pass — the "
                "fused histogram state cannot continue without its "
                "provisional edges")
        if sp is None and prof._fused and cursor > 0:
            raise ValueError(
                "profile_passes=fused cannot resume a two-pass checkpoint "
                "with rows already folded — the fused histogram would be "
                "missing the restored prefix")
        if sp is not None and prof._fused:
            if sp.get("edges") is not None:
                prof._sp_edges = singlepass.ProvisionalEdges.from_blob(
                    sp["edges"])
            if sp.get("hist") is not None:
                prof._hist_state = state_from_numpy(sp["hist"],
                                                    prof.runner.device)
        prof.cursor = cursor
        prof._quarantine.seed(host_blob.get("quarantine"))
        return prof

