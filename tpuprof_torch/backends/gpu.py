"""GPUStatsBackend — the profile scans on one device.

Counterpart of the single-process paths of ``tpuprof/backends/tpu.py``
(``TPUStatsBackend.collect``) and its helpers.  Batches stream once
through pass A (kernel K1, K3 past 512 numeric columns, the reference's
XLA twin past 2,048: moments, min/max, null/zero/inf counts, the pairwise
Pearson Gram; host: HLL registers, the row sample, Misra-Gries, dates, the
exact-unique tracker), then, for a rescannable source, once more through
pass B (kernel K2, any bin count: exact histograms and MAD on the pass-A
bounds; with ``spearman=True`` the Spearman Gram from the same shipped
batches: grid ranks by kernel K5, or K6 then K3 past 512 columns, and past
2,048 the reference's exact tier; host: the exact top-k recount).
``_assemble`` turns the merged results into the stats dict.  The tiers
are the runner's (``runtime/runner.py``).

With ``profile_passes="fused"`` pass A also folds the histograms, on
provisional edges (kernel K4, or pass A's route then K2 on the same shipped
batch past 512 columns or 8,192 bins; ``runtime/singlepass.py``). Lanes
whose edges held keep those counts; a second scan runs only to re-bin the
missed lanes (K2 on those columns), to recount the top-k or to rank for
Spearman — or not at all. The result equals the two-pass profile's exactly.

Division of labour: the device folds every numeric statistic; the host
decodes strings, hashes, keeps the frequent values, dates and first rows.
Numeric values are profiled in float32.

The ingest guard (``runtime/guard.py``) wraps both passes: a transient
prepare error retries, and with ``max_quarantined`` set a batch whose
prepare keeps failing or whose pass-A fold raises is skipped and reported
(``stats["_quarantine"]``), in pass B too, so it counts in neither pass.
Each copy of a device state to the host runs under ``drain_timeout_s``.

With ``checkpoint_path`` set, pass A saves its fold state every
``checkpoint_every_batches`` batches (:class:`CollectCheckpoint`), and a
rerun after a crash resumes from the newest good save.  Staged copies are
capped at :data:`STAGE_BYTES` of host planes.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import pandas as pd
import pyarrow as pa
import torch

from tpuprof_torch import native, schema
from tpuprof_torch.config import (MAX_SPEAR_GRID, ProfilerConfig,
                                  resolve_checkpoint_keep,
                                  resolve_ingest_retries,
                                  resolve_max_quarantined,
                                  resolve_prepare_workers,
                                  resolve_profile_passes,
                                  resolve_quarantine_log,
                                  resolve_retry_backoff,
                                  resolve_unique_budget,
                                  resolve_watchdog_timeout)
from tpuprof_torch.errors import InputError
from tpuprof_torch.ingest.arrow import (ArrowIngest, ColumnPlan, HostBatch,
                                        prefetch_prepared)
from tpuprof_torch.ingest.sample import RowSampler
from tpuprof_torch.kernels import corr as kcorr
from tpuprof_torch.kernels import histogram as khistogram
from tpuprof_torch.kernels import hll as khll
from tpuprof_torch.kernels import moments as kmoments
from tpuprof_torch.kernels import unique as kunique
from tpuprof_torch.kernels.fused import MAX_FUSED_COLS_WIDE
from tpuprof_torch.kernels.topk import MisraGries
from tpuprof_torch.kernels.unique import UniqueTracker
from tpuprof_torch.obs.spans import get_phase_report, span
from tpuprof_torch.runtime import checkpoint as ckpt
from tpuprof_torch.runtime import guard, singlepass
from tpuprof_torch.runtime.runner import Runner
from tpuprof_torch.testing import faults

logger = logging.getLogger("tpuprof_torch")


def estimate_shift(hb: HostBatch) -> np.ndarray:
    """Per-column centering from a prefix of the first batch (K1's shift
    input): any value near the data's scale conditions the float32 sums;
    all-missing columns center at 0."""
    prefix = hb.x[: min(hb.nrows, 4096)]
    if prefix.shape[0] == 0:
        return np.zeros(prefix.shape[1], dtype=np.float32)
    finite = np.isfinite(prefix)
    cnt = finite.sum(axis=0)
    sums = np.where(finite, prefix, 0.0).sum(axis=0)
    return (sums / np.maximum(cnt, 1)).astype(np.float32)


def spearman_grid(sampler: RowSampler, n_grid: int) -> np.ndarray:
    """The (n_num, G) CDF grid of the Spearman rank pass, G clamped to
    ``MAX_SPEAR_GRID`` with a warning.  Raises ``ValueError`` unless every
    row is nondecreasing and free of NaN: the kernels rank by binary search,
    which equals the reference's dense compare only on such a grid."""
    g = min(n_grid, MAX_SPEAR_GRID)
    if g < n_grid:
        logger.warning("spearman_grid=%d clamped to %d: the rank kernels "
                       "hold each column's grid in shared memory",
                       n_grid, g)
    grid = sampler.cdf_grid(g)
    if np.isnan(grid).any() or (grid[:, 1:] < grid[:, :-1]).any():
        raise ValueError("the Spearman CDF grid is not sorted or holds NaN")
    return grid


class HostAgg:
    """Host-side accumulators folded during pass A."""

    def __init__(self, plan: ColumnPlan, config: ProfilerConfig):
        self.config = config
        self.n_rows = 0
        self.col_nbytes: Dict[str, int] = {}
        self.col_dict_nbytes: Dict[str, int] = {}
        self.mg: Dict[str, MisraGries] = {
            s.name: MisraGries(config.topk_capacity)
            for s in plan.by_role("cat")}
        # exact "duplicate seen" flags keep the reference's exact UNIQUE
        # classification for columns whose Misra-Gries summary overflows
        # opaque nested columns have no hash stream: nothing to track
        self.unique = UniqueTracker(
            (s.name for s in plan.by_role("cat") if not s.opaque),
            config.unique_track_rows,
            resolve_unique_budget(config.unique_track_total_rows))
        self.cat_null: Dict[str, int] = {s.name: 0
                                         for s in plan.by_role("cat")}
        self.date_min: Dict[str, int] = {}
        self.date_max: Dict[str, int] = {}
        self.date_null: Dict[str, int] = {s.name: 0
                                          for s in plan.by_role("date")}
        self.first_values: Dict[str, list] = {}

    def update(self, hb: HostBatch) -> None:
        first = self.n_rows == 0
        self.n_rows += hb.nrows
        for name, nb in (hb.col_nbytes or {}).items():
            self.col_nbytes[name] = self.col_nbytes.get(name, 0) + nb
        for name, nb in (hb.col_dict_nbytes or {}).items():
            self.col_dict_nbytes[name] = max(
                self.col_dict_nbytes.get(name, 0), nb)
        for name, (codes, dvals) in hb.cat_codes.items():
            codes = codes[: hb.nrows]
            valid = codes >= 0
            self.cat_null[name] += int((~valid).sum())
            if valid.any() and len(dvals):
                cnt = np.bincount(codes[valid], minlength=len(dvals))
                nz = np.nonzero(cnt)[0]
                dh = (hb.cat_hashes or {}).get(name)
                self.mg[name].update_batch(
                    dvals[nz], cnt[nz],
                    hashes=dh[nz] if dh is not None else None)
                if self.unique.active(name):
                    if dh is None:
                        # no hashes: coverage broken, the exact claim goes
                        self.unique.deactivate(name)
                    else:
                        kind = (hb.cat_hash_kind or {}).get(name, "")
                        self.unique.update(name, dh[codes[valid]],
                                           hash_kind=kind)
            if first:
                self.first_values[name] = [
                    dvals[c] if c >= 0 else None for c in codes[:5]]
        for name, payload in (hb.cat_hashed or {}).items():
            # the row-hash path: values materialize only for Misra-Gries
            # survivors and the first report rows
            uniq, cnts, first_row, row_hashes, valid, arr = payload
            self.cat_null[name] += 0 if valid is None \
                else int(hb.nrows - valid.sum())
            if uniq.size:
                def resolver(src, arr=arr, first_row=first_row):
                    taken = arr.take(pa.array(first_row[src]))
                    return np.asarray(taken.to_pandas(), dtype=object)
                self.mg[name].update_hashed(uniq, cnts, resolver)
                if self.unique.active(name):
                    # the dictionary path's native value hashes: a column's
                    # stream may mix the two paths
                    self.unique.update(
                        name,
                        row_hashes if valid is None else row_hashes[valid],
                        hash_kind="native")
            if first:
                self.first_values[name] = arr[:5].to_pylist()
        for name, nulls in (hb.opaque_nulls or {}).items():
            self.cat_null[name] += int(nulls)
        for name, (ints, valid) in hb.date_ints.items():
            ints, valid = ints[: hb.nrows], valid[: hb.nrows]
            self.date_null[name] += int((~valid).sum())
            if valid.any():
                lo, hi = int(ints[valid].min()), int(ints[valid].max())
                self.date_min[name] = min(self.date_min.get(name, lo), lo)
                self.date_max[name] = max(self.date_max.get(name, hi), hi)

    def memorysize(self, name: str) -> float:
        """Arrow buffer bytes for one column (NaN if never observed)."""
        if name not in self.col_nbytes:
            return float("nan")
        return float(self.col_nbytes[name]
                     + self.col_dict_nbytes.get(name, 0))


class Recounter:
    """Pass-B exact recount of the Misra-Gries candidates (the
    reference's exact ``groupBy().count()`` for the reported top-k)."""

    def __init__(self, hostagg: HostAgg):
        self.indexes: Dict[str, pd.Index] = {}
        self.counts: Dict[str, np.ndarray] = {}
        # dictionary -> candidate indexers, memoized on the values object
        self._dv_cache: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
        for name, mg in hostagg.mg.items():
            cands = pd.Index(list(mg.candidates()))
            self.indexes[name] = cands
            self.counts[name] = np.zeros(len(cands), dtype=np.int64)

    def update(self, hb: HostBatch) -> None:
        for name, (codes, dvals) in hb.cat_codes.items():
            codes = codes[: hb.nrows]
            valid = codes >= 0
            if not valid.any() or not len(dvals):
                continue
            cnt = np.bincount(codes[valid], minlength=len(dvals))
            ent = self._dv_cache.get(name)
            if ent is None or ent[0] is not dvals:
                ent = (dvals, self.indexes[name].get_indexer(dvals))
                self._dv_cache[name] = ent
            cand_idx = ent[1]
            hit = cand_idx >= 0
            np.add.at(self.counts[name], cand_idx[hit], cnt[hit])

    def value_counts(self, name: str) -> pd.Series:
        return pd.Series(self.counts[name], index=self.indexes[name]
                         ).sort_values(ascending=False)


# the most host bytes one staged group ships in one copy; the prefetch
# queue holds about as many prepared batches.  A batch of a wide table is
# large (1.07 GB at 4,096 float32 columns x 65,536 rows), so wide tables
# stage fewer batches a copy, down to one, and pin no more than that
STAGE_BYTES = 1 << 30


def stage_group(scan_batches: int, rows: int, n_num: int, n_hash: int,
                with_hll: bool) -> int:
    """How many batches one staged copy holds: ``scan_batches``, cut so
    their shipped planes stay within :data:`STAGE_BYTES` (at least 1)."""
    per = rows * (4 * n_num + (2 * n_hash if with_hll else 0) + 1)
    return max(1, min(int(scan_batches), STAGE_BYTES // max(per, 1)))


class CollectCheckpoint:
    """Batch-granular resume of the pass-A scan (the reference's
    ``_CollectCheckpoint``, one process).  Every ``checkpoint_every_batches``
    delivered batches the device state, the host sketches, the cursor, the
    (fragment, batch) position of the last consumed batch, the quarantine
    manifest and the stream positions pass A skipped are saved
    (``runtime/checkpoint.py``), after a flush of the device, so the cursor
    is the number of folded batches.  A single-pass scan also saves its
    histogram state and the provisional edges it bins on.  A rerun with the
    same path loads the newest good generation and skips the folded prefix
    without decoding it: whole fragments of a Parquet source, zero-copy
    slices of a table.  A run that completes removes the chain."""

    def __init__(self, config: ProfilerConfig, plan, runner,
                 source_fp: str, table_source: bool, fused: bool):
        self.path = config.checkpoint_path
        self.every = max(int(config.checkpoint_every_batches), 1)
        self.keep = resolve_checkpoint_keep(config.checkpoint_keep)
        self.config = config
        self.plan = plan
        self.runner = runner
        self.source_fp = source_fp
        self.table_source = table_source
        self.fused = fused
        self.last_saved = -1            # cursor of the newest save

    def exists(self) -> bool:
        return any(os.path.exists(p)
                   for p in ckpt.candidate_paths(self.path))

    def due(self, cursor: int) -> bool:
        return cursor % self.every == 0

    def _meta(self) -> Dict[str, Any]:
        """What a resume must share with the saved prefix: the reference's
        meta keys, without the fleet's."""
        c = self.config
        return {"n_num": self.plan.n_num, "n_hash": self.plan.n_hash,
                "batch_rows": c.batch_rows,
                "hll_precision": c.hll_precision,
                "native_hash": native.available(),
                "source_fp": self.source_fp,
                "quantile_sketch_size": c.quantile_sketch_size,
                "topk_capacity": c.topk_capacity, "seed": c.seed,
                # a table is enumerated in fixed combined windows
                "batch_enum": "window-v2" if self.table_source else None,
                "exact_distinct": False, "nested": c.nested,
                "profile_passes": "fused" if self.fused else "two_pass"}

    def save(self, state, sampler, hostagg, host_hll, cursor, frag_pos,
             quarantine, skipped, hist_state=None, edges=None) -> None:
        blob = {"sampler": sampler, "hostagg": hostagg,
                "host_hll": host_hll,
                "frag_pos": tuple(frag_pos) if frag_pos else None,
                "quarantine": list(quarantine.entries),
                "skipped": sorted(skipped)}
        meta = self._meta()
        meta["has_state"] = state is not None
        if hist_state is not None:
            # the histogram fold rides the same archive; a resume bins the
            # rest of the stream on the same edges
            state = {"a": state, "hist": hist_state}
            blob["singlepass_edges"] = edges.as_blob()
        with span("checkpoint"):
            ckpt.save(self.path, state, blob, cursor, meta=meta,
                      keep=self.keep)
        self.last_saved = cursor

    def load(self):
        """(state, sampler, hostagg, host_hll, cursor, frag_pos,
        quarantine entries, skipped positions, histogram state, edges) of
        the newest good generation, after refusing a run whose batch
        stream or sketch shapes differ from the saved prefix's."""
        with span("resume"):
            payload, _used = ckpt.restore_payload(self.path)
            meta, mine = payload["meta"], self._meta()
            for key in mine:
                if meta.get(key) != mine[key]:
                    raise InputError(
                        f"checkpoint {key}={meta.get(key)!r} does not match "
                        f"this run's {mine[key]!r} — the batch stream or "
                        "sketch shapes would diverge from the saved prefix")
            blob = payload["host_blob"]
            dev = self.runner.device
            state = hist_state = edges = None
            if meta.get("has_state"):
                if "singlepass_edges" in blob:
                    both = ckpt.materialize(
                        payload, {"a": self.runner.init_pass_a(),
                                  "hist": self.runner.init_pass_b()}, dev)
                    state, hist_state = both["a"], both["hist"]
                    edges = singlepass.ProvisionalEdges.from_blob(
                        blob["singlepass_edges"])
                else:
                    state = ckpt.materialize(
                        payload, self.runner.init_pass_a(), dev)
        self.last_saved = payload["cursor"]
        return (state, blob["sampler"], blob["hostagg"], blob["host_hll"],
                payload["cursor"], blob["frag_pos"], blob["quarantine"],
                set(blob["skipped"]), hist_state, edges)

    def clear(self) -> None:
        ckpt.clear(self.path)


class GPUStatsBackend:
    """Profile an in-memory table on one device, in two passes or, with
    ``profile_passes="fused"``, in one."""

    name = "gpu"

    def __init__(self, device=None):
        self._device = device

    def collect(self, source: Any, config: ProfilerConfig) -> Dict[str, Any]:
        # this profile's phase seconds ride its own stats dict: drop what
        # an earlier profile left
        get_phase_report(reset=True)
        ingest = ArrowIngest(source, config.batch_rows,
                             columns=config.columns, nested=config.nested)
        plan = ingest.plan
        if not plan.specs:
            return _empty_stats(config)
        runner = Runner(config, plan.n_num, plan.n_hash, self._device)
        pad = runner.rows
        workers = resolve_prepare_workers(config.prepare_workers)
        # single-pass profiles (runtime/singlepass.py): pass A folds the
        # histograms too, on provisional edges from an artifact or the
        # first batch
        fused_scan = resolve_profile_passes(config.profile_passes) \
            == "fused" and plan.n_num > 0
        sp_seeds = singlepass.resolve_seeds(config, plan) \
            if fused_scan else None

        # the ingest guard: transient prepare errors retry; with a budget,
        # a batch that keeps failing (or whose fold raises) is skipped and
        # reported; the device drain runs under a deadline when one is set.
        # The defaults fail fast, as before
        quarantine = guard.Quarantine(
            resolve_max_quarantined(config.max_quarantined),
            log_path=resolve_quarantine_log(config.quarantine_log))
        batch_guard = guard.BatchGuard(
            resolve_ingest_retries(config.ingest_retries),
            resolve_retry_backoff(config.retry_backoff_s),
            capture=quarantine.enabled)
        drain_timeout = resolve_watchdog_timeout(config.drain_timeout_s,
                                                 "TPUPROF_DRAIN_TIMEOUT_S")
        skipped = set()         # stream positions pass A quarantined

        hostagg = HostAgg(plan, config)

        def drained(finalize, st):
            """``finalize(st)``, the copy of a device state to the host,
            which waits on the card, under the drain watchdog."""
            def wait():
                faults.hit("device_wait")
                return finalize(st)
            return guard.watched(wait, drain_timeout, site="device_wait",
                                 heartbeat=lambda: {
                                     "rows": int(hostagg.n_rows),
                                     "skipped": len(skipped)})

        sampler = RowSampler(config.quantile_sketch_size, plan.n_num,
                             seed=config.seed)
        # HLL registers fold on the host when the native library builds;
        # otherwise the packed plane ships to the device scatter-max
        host_hll = khll.HostRegisters(plan.n_hash, config.hll_precision) \
            if plan.n_hash > 0 and native.available() else None

        # ---- checkpoint / resume of pass A --------------------------------
        state = None
        state_h = None          # the fused scan's histogram state
        sp_edges = None         # ... and the provisional edges it bins on
        edges_d = None
        cursor = 0              # batches consumed from the stream
        last_frag = None        # (fragment, batch) of the last of them
        resume = CollectCheckpoint(
            config, plan, runner, ingest.fingerprint(),
            table_source=ingest._table is not None, fused=fused_scan) \
            if config.checkpoint_path else None
        if resume is not None and resume.exists():
            (state, sampler, hostagg, host_hll, cursor, last_frag,
             prior_q, prior_skip, state_h, sp_edges) = resume.load()
            # a degraded prefix stays degraded, and its skipped batches
            # stay out of pass B
            quarantine.seed(prior_q)
            skipped.update(prior_skip)
            if sp_edges is not None:
                edges_d = tuple(runner.put_replicated(a) for a in (
                    sp_edges.lo, sp_edges.hi, sp_edges.mean))
        with_hll = host_hll is None
        # staged groups and the prefetch queue, capped in bytes
        scan_s = stage_group(config.scan_batches, pad, plan.n_num,
                             plan.n_hash, with_hll)
        depth = max(2, min(scan_s, 8))
        if resume is not None and scan_s > 1 and resume.every % scan_s:
            logger.warning(
                "checkpoint_every_batches=%d is not a multiple of the "
                "staged group of %d batches: each checkpoint flushes a "
                "partial group, which folds batch by batch", resume.every,
                scan_s)

        def flush_group(pending, fold_staged, fold_one):
            """The staged-vs-tail flush policy of both passes: a FULL group
            ships as one stacked copy folded by one scan; a partial group
            (the tail, a checkpoint) folds batch by batch.  Both run the
            same per-batch kernel calls in the same order."""
            if len(pending) == scan_s and scan_s > 1:
                fold_staged(pending)
            else:
                for p in pending:
                    fold_one(p)
            pending.clear()

        # ---- pass A (with the provisional histograms when fused) ---------
        # a checkpointed scan streams by (fragment, batch) positions, so a
        # resume opens no fragment the saved prefix covers
        batches = prefetch_prepared(
            ingest, pad, config.hll_precision, depth=depth, workers=workers,
            prep_workers=config.prep_workers, batch_guard=batch_guard,
            positions=resume is not None,
            resume_pos=(last_frag[0], last_frag[1] + 1)
            if last_frag is not None else None)
        pending: List[HostBatch] = []

        def staged_a(group):
            nonlocal state, state_h
            sb = runner.stage_batches(group, with_hll=with_hll)
            if state_h is not None:
                state, state_h = runner.scan_ab(state, state_h, sb,
                                                *edges_d)
            else:
                state = runner.scan_a(state, sb)

        def one_a(hb):
            nonlocal state, state_h
            db = runner.put_batch(hb, with_hll=with_hll)
            if state_h is not None:
                state, state_h = runner.step_ab(state, state_h, db,
                                                *edges_d)
            else:
                state = runner.step_a(state, db)

        def save():
            """A checkpoint after the device folded every pending batch:
            the saved cursor is the folded count."""
            flush_group(pending, staged_a, one_a)
            resume.save(state, sampler, hostagg, host_hll, cursor,
                        last_frag, quarantine, skipped, state_h, sp_edges)

        with span("scan_a"):
            for hb in batches:
                key = cursor        # the batch's position in the stream
                cursor += 1
                if isinstance(hb, guard.PoisonBatch):
                    # failed past its retries: skipped in both passes
                    skipped.add(key)
                    last_frag = hb.frag_pos or last_frag
                    quarantine.admit(site=hb.site, error=hb.error,
                                     cursor=cursor, rows=hb.rows,
                                     frag_pos=hb.frag_pos)
                    if resume is not None and resume.due(cursor):
                        save()
                    continue
                if state is None:
                    state = runner.init_pass_a(estimate_shift(hb))
                    if fused_scan:
                        sp_edges = singlepass.sketch_edges(hb.x, hb.nrows,
                                                           into=sp_seeds)
                        state_h = runner.init_pass_b()
                        edges_d = tuple(runner.put_replicated(a) for a in (
                            sp_edges.lo, sp_edges.hi, sp_edges.mean))
                # host folds run while the device works on earlier groups
                try:
                    faults.hit("fold", key=key)
                    sampler.update(hb.x, hb.nrows)
                    if host_hll is not None:
                        host_hll.update(hb.hll, hb.nrows)
                    hostagg.update(hb)
                except Exception as exc:
                    if not quarantine.enabled:
                        raise
                    # a fold is not idempotent: never retried, skipped
                    skipped.add(key)
                    last_frag = hb.frag_pos or last_frag
                    quarantine.admit(site="fold", error=exc,
                                     cursor=cursor, rows=hb.nrows,
                                     frag_pos=hb.frag_pos)
                    continue
                pending.append(hb)
                last_frag = hb.frag_pos or last_frag
                if resume is not None and resume.due(cursor):
                    save()
                elif len(pending) >= scan_s:
                    flush_group(pending, staged_a, one_a)
            flush_group(pending, staged_a, one_a)
            if state is None:
                state = runner.init_pass_a()
        if resume is not None and resume.last_saved != cursor:
            # pass A complete: a crash in pass B resumes with the whole
            # stream skipped; cleared once the stats are assembled
            save()

        run_pass_b = config.exact_passes and ingest.rescannable \
            and plan.n_num > 0 and hostagg.n_rows > 0
        # the exact pass-B inputs, computed on the device (no host round
        # trip before pass B): what K2 bins with, what a fused profile's
        # provisional edges are held to, and what the artifact seeds carry
        with span("merge"):
            bounds_d = runner.bounds_b_device(state) \
                if plan.n_num > 0 else None
            exact = singlepass.exact_triple(bounds_d) \
                if bounds_d is not None else None
            res_a = drained(runner.finalize_a, state)
        momf = kmoments.finalize(res_a["mom"])
        rho_all = kcorr.finalize(res_a["corr"])
        probes = list(config.quantile_probes)
        quants = sampler.quantiles(probes)
        sample_vals, sample_kept = sampler.columns()
        hll_est = khll.finalize(host_hll.regs if host_hll is not None
                                else res_a["hll"])

        # ---- fused: which lanes the provisional edges got right ----------
        res_h = None            # the fused histograms, finalized
        rebin = None            # lanes a second scan re-bins (fused)
        adopted = None          # fused histograms taken as they are
        exact_lanes = None      # lanes whose histogram/MAD are exact
        if state_h is not None and hostagg.n_rows > 0:
            res_h = drained(runner.finalize_b, state_h)
            hits = singlepass.hit_lanes(sp_edges, exact)
            if run_pass_b:
                if hits.all() and not hostagg.mg and not config.spearman:
                    # every edge held and nothing else needs a second
                    # read: the profile is complete after one scan
                    run_pass_b = False
                    adopted = res_h
                else:
                    rebin = np.nonzero(~hits)[0]
            else:
                # no second scan (exact_passes=False): the exact histogram
                # and MAD where the edges held, the sample tier elsewhere
                adopted = res_h
                exact_lanes = None if hits.all() else hits

        # ---- pass B: exact histograms + MAD + top-k recount ----------------
        def pass_b_batches():
            """Pass B's batches without those pass A skipped; a batch that
            fails here only is quarantined under the same budget."""
            for hb in prefetch_prepared(
                    ingest, pad, config.hll_precision, depth=depth,
                    hashes=False, workers=workers,
                    prep_workers=config.prep_workers,
                    batch_guard=batch_guard, skip_keys=frozenset(skipped)):
                if isinstance(hb, guard.PoisonBatch):
                    quarantine.admit(site=hb.site + "_pass_b",
                                     error=hb.error, rows=hb.rows,
                                     frag_pos=hb.frag_pos)
                    continue
                yield hb

        hists: Optional[List] = None
        mad: Optional[np.ndarray] = None
        recounter: Optional[Recounter] = None
        rho_spear: Optional[np.ndarray] = None
        spear_approx = False
        if run_pass_b:
            recounter = Recounter(hostagg)
            lanes_d = None
            if rebin is None:
                state_b = runner.init_pass_b()
                lo_d, hi_d, mean_d = bounds_d
            elif len(rebin):
                # the missed lanes only, on the exact triple the hit check
                # held them to
                state_b = runner.init_pass_b(len(rebin))
                lo_d, hi_d, mean_d = (runner.put_replicated(a[rebin])
                                      for a in exact)
                lanes_d = torch.as_tensor(rebin, device=runner.device)
            else:
                state_b = None  # all hit: the second scan is for others
            spear_state = None
            if config.spearman:
                spear_state = runner.init_spearman()
                if runner.spear_grid:
                    # the grid tier: ranks on the sample's CDF grid (K5,
                    # or K6 then K3)
                    spear_in = (runner.put_replicated(
                        spearman_grid(sampler, config.spearman_grid)),)
                    spear_one = runner.step_spearman_grid
                    spear_staged = runner.scan_spearman_grid
                else:
                    # past the rank kernels' columns, the reference's
                    # exact tier: each value's rank in its column's
                    # sorted sample (+inf pads the unkept slots).  The
                    # reference warns past 1,000,000 rows; the card's
                    # time is chip_smoke.py phase 7's (PERF.md)
                    if hostagg.n_rows > 1_000_000:
                        logger.warning(
                            "spearman: %d numeric columns exceed the rank "
                            "kernels' %d, so %d rows rank on the exact "
                            "tier (searchsorted, then a float32 Gram): "
                            "198 ms a 65,536-row batch of 4,096 columns "
                            "on an NVIDIA H100 80GB HBM3 at 700 W",
                            plan.n_num, MAX_FUSED_COLS_WIDE,
                            hostagg.n_rows)
                    srt, kept = sampler.sorted_padded()
                    spear_in = (runner.put_replicated(srt),
                                runner.put_replicated(kept, np.int32))
                    spear_one = runner.step_spearman
                    spear_staged = runner.scan_spearman
            # ship only the missed columns when nothing else reads the
            # batch; with Spearman on the whole plane ships for the rank
            # kernels and the re-bin takes its columns from it on the
            # device (lanes_d)
            subset = rebin is not None and spear_state is None

            def view(hb):
                return dataclasses.replace(hb, x=hb.x[:, rebin]) \
                    if subset else hb

            # the Spearman state folds from the batches pass B ships: one
            # transfer feeds K2 and the rank kernels
            def staged_b(group):
                nonlocal state_b, spear_state
                if state_b is None and spear_state is None:
                    return
                sb = runner.stage_batches([view(hb) for hb in group],
                                          with_hll=False)
                if state_b is not None:
                    state_b = runner.scan_b(state_b, sb, lo_d, hi_d, mean_d,
                                            None if subset else lanes_d)
                if spear_state is not None:
                    spear_state = spear_staged(spear_state, sb, *spear_in)

            def one_b(hb):
                nonlocal state_b, spear_state
                if state_b is None and spear_state is None:
                    return
                db = runner.put_batch(view(hb), with_hll=False)
                if state_b is not None:
                    state_b = runner.step_b(state_b, db, lo_d, hi_d, mean_d,
                                            None if subset else lanes_d)
                if spear_state is not None:
                    spear_state = spear_one(spear_state, db, *spear_in)

            pending_b: List[HostBatch] = []
            with span("scan_b"):
                for hb in pass_b_batches():
                    recounter.update(hb)
                    pending_b.append(hb)
                    if len(pending_b) >= scan_s:
                        flush_group(pending_b, staged_b, one_b)
                flush_group(pending_b, staged_b, one_b)
                res_b = drained(runner.finalize_b, state_b) \
                    if state_b is not None else None
            if rebin is not None:
                # hit lanes keep their fused counts, missed lanes take the
                # re-bin: two-pass's result, lane for lane
                if res_b is not None:
                    res_b = singlepass.merge_rebinned(res_h, res_b, rebin)
                    singlepass.record_rebin(len(rebin))
                else:
                    res_b = res_h
            hists, mad = khistogram.finalize(
                res_b, momf["fmin"], momf["fmax"], momf["n"], config.bins)
            if spear_state is not None:
                rho_spear = kcorr.finalize(
                    drained(runner.finalize_spearman, spear_state))
        elif adopted is not None:
            hists, mad = khistogram.finalize(
                adopted, momf["fmin"], momf["fmax"], momf["n"], config.bins)
        elif config.exact_passes and ingest.rescannable \
                and hostagg.n_rows > 0:
            # no numeric columns: only the top-k recount needs a rescan
            recounter = Recounter(hostagg)
            with span("scan_b"):
                for hb in pass_b_batches():
                    recounter.update(hb)
        if config.spearman and not run_pass_b and hostagg.n_rows > 0 \
                and plan.n_num > 1:
            # no rank pass (exact_passes=False): estimate from the K-row
            # uniform sample, ~1/sqrt(K) rank error, and say so
            spear_approx = True
            rho_spear = sampler.spearman()

        stats = _assemble(plan, config, ingest.sample(config.sample_rows),
                          hostagg, momf, rho_all, quants, sample_vals,
                          sample_kept, hll_est, hists, mad, recounter,
                          probes, rho_spear, spear_approx, exact_lanes)
        if exact is not None:
            # the pass-B bounds a later fused profile of this source seeds
            # its edges from (artifacts seal them); private, never exported
            stats["_bin_seeds"] = singlepass.bin_seeds(plan, exact)
        if quarantine.entries:
            # degraded runs only: a clean run's stats and HTML are as
            # before the guard existed
            stats["_quarantine"] = list(quarantine.entries)
        if resume is not None:
            resume.clear()          # the profile completed
        # private, never exported; the report footer reads it
        stats["_phases"] = get_phase_report(reset=True)
        return stats


# ---------------------------------------------------------------------------
# Assembly: merged device/host results -> the stats dict contract
# ---------------------------------------------------------------------------

def _sample_mode(values: np.ndarray, kept: np.ndarray) -> float:
    """Mode estimated from the uniform sample (exact when the sample holds
    the whole column)."""
    v = values[kept]
    if not v.size:
        return np.nan
    uniq, cnt = np.unique(v, return_counts=True)
    return float(uniq[np.argmax(cnt)])


def _assemble(plan, config, sample_df, hostagg, momf, rho_all, quants,
              sample_vals, sample_kept, hll_est, hists, mad, recounter,
              probes, rho_spear=None, spear_approx=False,
              exact_lanes=None) -> Dict[str, Any]:
    n = hostagg.n_rows
    variables: Dict[str, Dict[str, Any]] = {}
    freq: Dict[str, pd.Series] = {}

    # ---- first sweep: per-column counts/distincts + provisional kinds ----
    unique_status = hostagg.unique.resolve()
    kinds: Dict[str, str] = {}
    commons: Dict[str, Dict[str, Any]] = {}
    for spec in plan.specs:
        distinct_approx = False
        if spec.role == "num":
            lane = spec.num_lane
            n_missing = int(momf["n_missing"][lane])
            count = n - n_missing
            if count > 0 and momf["min"][lane] == momf["max"][lane]:
                distinct = 1
            elif spec.base_kind == schema.BOOL:
                distinct = 2 if count else 0
            else:
                distinct = int(round(hll_est[spec.hash_lane]))
                distinct = max(min(distinct, count), 1 if count else 0)
                distinct_approx = count > 0
        elif spec.role == "date":
            n_missing = hostagg.date_null[spec.name]
            count = n - n_missing
            distinct = int(round(hll_est[spec.hash_lane]))
            distinct = max(min(distinct, count), 1 if count else 0)
            distinct_approx = count > 0
        elif spec.opaque:
            # nested="opaque": count, missing and memory only; with no
            # value stream the cardinality is unknown (None), not estimated
            n_missing = hostagg.cat_null[spec.name]
            count = n - n_missing
            commons[spec.name] = {
                "count": count,
                "n_missing": n_missing,
                "p_missing": n_missing / n if n else 0.0,
                "distinct_count": None,
                "p_unique": None,
                "is_unique": False,
                "distinct_approx": True,
                "memorysize": hostagg.memorysize(spec.name),
            }
            kinds[spec.name] = schema.CAT
            continue
        else:
            n_missing = hostagg.cat_null[spec.name]
            count = n - n_missing
            exact_distinct = hostagg.mg[spec.name].distinct_count()
            if exact_distinct is not None:
                distinct = exact_distinct
            else:
                # Misra-Gries overflowed; the duplicate tracker keeps the
                # exact `distinct == count -> UNIQUE` rule, and only the
                # OVERFLOW tier is an estimate (and says so)
                est = max(min(int(round(hll_est[spec.hash_lane])), count),
                          1 if count else 0)
                status = unique_status.get(spec.name)
                if status == kunique.UNIQUE:
                    distinct = count
                elif status == kunique.DUP:
                    distinct = min(est, count - 1)
                    distinct_approx = True
                else:
                    distinct = est
                    distinct_approx = True
        commons[spec.name] = {
            "count": count,
            "n_missing": n_missing,
            "p_missing": n_missing / n if n else 0.0,
            "distinct_count": distinct,
            "p_unique": distinct / count if count else 0.0,
            # UNIQUE/is_unique are exact claims; an estimate that happens
            # to clamp to `count` must not make them
            "is_unique": count > 0 and distinct == count
            and not distinct_approx,
            "distinct_approx": distinct_approx,
            "memorysize": hostagg.memorysize(spec.name),
        }
        kind = schema.classify(spec.base_kind, distinct, count)
        if kind == schema.UNIQUE and distinct_approx:
            kind = schema.CAT
        kinds[spec.name] = kind

    # ---- correlation rejection over refined-NUM columns ------------------
    num_specs = [s for s in plan.specs
                 if s.role == "num" and kinds[s.name] == schema.NUM]
    num_names = [s.name for s in num_specs]
    lanes = [s.num_lane for s in num_specs]
    corr_df = pd.DataFrame(rho_all[np.ix_(lanes, lanes)],
                           index=num_names, columns=num_names) \
        if len(lanes) >= 2 else pd.DataFrame()
    rejected = schema.reject_by_correlation(corr_df, num_names, config) \
        if len(lanes) >= 2 else {}
    for name in rejected:
        kinds[name] = schema.CORR

    # ---- per-column stats -------------------------------------------------
    for spec in plan.specs:
        name, kind, common = spec.name, kinds[spec.name], commons[spec.name]
        stats = dict(common)
        if kind == schema.NUM:
            stats.update(_numeric_stats(spec.num_lane, momf, quants,
                                        sample_vals, sample_kept, hists,
                                        mad, probes, config, exact_lanes))
        elif kind == schema.BOOL:
            lane = spec.num_lane
            n_true = int(round(momf["sum"][lane])) if common["count"] else 0
            vc = pd.Series({True: n_true,
                            False: common["count"] - n_true}
                           ).sort_values(ascending=False)
            freq[name] = vc
            stats["mean"] = float(momf["mean"][lane])
            stats["mode"] = bool(vc.index[0]) if common["count"] else np.nan
            stats["mode_approx"] = False    # from exact true/false counts
            stats["top"] = stats["mode"]
            stats["freq"] = int(vc.iloc[0]) if common["count"] else 0
        elif kind == schema.CAT and spec.opaque:
            # the contract's fields, carrying "unknown"; no freq table
            stats["mode"] = None
            stats["top"] = None
            stats["freq"] = 0
        elif kind == schema.CAT:
            vc = (recounter.value_counts(name)
                  if recounter is not None
                  else pd.Series({v: c for v, c in
                                  hostagg.mg[name].top(
                                      config.topk_capacity)}))
            vc = vc.sort_values(ascending=False)
            stats["mode"] = vc.index[0] if len(vc) else np.nan
            stats["top"] = stats["mode"]
            stats["freq"] = int(vc.iloc[0]) if len(vc) else 0
            freq[name] = vc.head(config.top_freq)
        elif kind == schema.DATE:
            lo = hostagg.date_min.get(name)
            hi = hostagg.date_max.get(name)
            stats["min"] = pd.Timestamp(lo) if lo is not None else pd.NaT
            stats["max"] = pd.Timestamp(hi) if hi is not None else pd.NaT
            stats["range"] = (stats["max"] - stats["min"]) \
                if lo is not None else pd.NaT
        elif kind == schema.CONST:
            stats["mode"] = _const_mode(spec, momf, hostagg)
        elif kind == schema.UNIQUE:
            stats["first_rows"] = [
                v for v in hostagg.first_values.get(name, []) if v is not None
            ][:5]
        elif kind == schema.CORR:
            other, rho = rejected[name]
            stats.update({"correlation_var": other, "correlation": rho})
        stats["type"] = kind
        variables[name] = stats

    table = schema.make_table_stats(
        n, variables,
        memorysize=float(sum(hostagg.memorysize(c)
                             for c in hostagg.col_nbytes))
        if hostagg.col_nbytes else np.nan)
    correlations = {"pearson": corr_df}
    if rho_spear is not None and len(lanes) >= 2:
        # over the same refined-NUM lanes as Pearson; rejection stays
        # Pearson-only.  A sample-estimated matrix says so in its attrs
        spear_df = pd.DataFrame(rho_spear[np.ix_(lanes, lanes)],
                                index=num_names, columns=num_names)
        spear_df.attrs["approx"] = bool(spear_approx)
        correlations["spearman"] = spear_df
    return {
        "table": table,
        "variables": variables,
        "freq": freq,
        "correlations": correlations,
        "messages": schema.derive_messages(variables, config),
        "sample": sample_df,
    }


def _numeric_stats(lane, momf, quants, sample_vals, sample_kept, hists, mad,
                   probes, config, exact_lanes=None) -> Dict[str, Any]:
    out = {
        "mean": float(momf["mean"][lane]),
        "std": float(momf["std"][lane]),
        "variance": float(momf["variance"][lane]),
        "cv": float(momf["cv"][lane]),
        "skewness": float(momf["skewness"][lane]),
        "kurtosis": float(momf["kurtosis"][lane]),
        "sum": float(momf["sum"][lane]),
        "min": float(momf["min"][lane]),
        "max": float(momf["max"][lane]),
        "n_zeros": int(momf["n_zeros"][lane]),
        "n_infinite": int(momf["n_inf"][lane]),
    }
    out["range"] = out["max"] - out["min"]
    n_valid = int(momf["n"][lane]) + int(momf["n_inf"][lane])
    out["p_zeros"] = out["n_zeros"] / n_valid if n_valid else 0.0
    out["p_infinite"] = out["n_infinite"] / n_valid if n_valid else 0.0
    for idx, p in enumerate(probes):
        out[schema.QUANTILE_FIELDS[p]] = float(quants[idx, lane])
    out["iqr"] = out["p75"] - out["p25"]
    # a fused profile without a second scan has the exact histogram and MAD
    # only where its provisional edges held (exact_lanes); None = every lane
    lane_exact = exact_lanes is None or bool(exact_lanes[lane])
    if mad is not None and lane_exact:
        out["mad"] = float(mad[lane])
    else:  # single-pass mode: MAD from the uniform sample
        v = sample_vals[lane][sample_kept[lane]]
        out["mad"] = float(np.abs(v - v.mean()).mean()) if v.size else np.nan
    if hists is not None and lane_exact:
        out["histogram"] = hists[lane]
    else:  # single-pass mode: sample-scaled histogram
        v = sample_vals[lane][sample_kept[lane]]
        if v.size and np.isfinite(momf["fmin"][lane]) \
                and momf["fmax"][lane] > momf["fmin"][lane]:
            counts, edges = np.histogram(
                v, bins=config.bins,
                range=(momf["fmin"][lane], momf["fmax"][lane]))
            scale = momf["n"][lane] / max(v.size, 1)
            out["histogram"] = ((counts * scale).astype(np.int64), edges)
        else:
            out["histogram"] = None
    out["mini_histogram"] = out["histogram"]
    out["mode"] = _sample_mode(sample_vals[lane], sample_kept[lane])
    # exact iff the sample holds every value of the column and the column
    # has no infinities (the sample keeps finite values only)
    out["mode_approx"] = \
        int(sample_kept[lane].sum()) < int(momf["n"][lane]) \
        or int(momf["n_inf"][lane]) > 0
    return out


def _const_mode(spec, momf, hostagg):
    if spec.role == "num":
        v = momf["min"][spec.num_lane]
        if not np.isfinite(v):        # empty column: min is the +inf identity
            return np.nan
        if spec.base_kind == schema.BOOL:
            return bool(v)
        return float(v)
    if spec.role == "date":
        lo = hostagg.date_min.get(spec.name)
        return pd.Timestamp(lo) if lo is not None else pd.NaT
    top = hostagg.mg[spec.name].top(1)
    return top[0][0] if top else np.nan


def _empty_stats(config) -> Dict[str, Any]:
    return {
        "table": schema.make_table_stats(0, {}),
        "variables": {},
        "freq": {},
        "correlations": {"pearson": pd.DataFrame()},
        "messages": [],
        "sample": pd.DataFrame(),
    }
