"""GPUStatsBackend — the profile scans.

Counterpart of ``tpuprof/backends/tpu.py`` (``TPUStatsBackend.collect``) and
its helpers.  Batches stream once
through pass A (kernel K1, K3 past 512 numeric columns, the reference's
XLA twin past 2,048: moments, min/max, null/zero/inf counts, the pairwise
Pearson Gram; host: HLL registers, the row sample, Misra-Gries, dates, the
exact-unique tracker, which with ``exact_distinct`` counts every column's
distinct values exactly and spills past its budgets), then, for a
rescannable source, once more through pass B (kernel K2, any bin count:
exact histograms and MAD on the pass-A bounds; with ``spearman=True`` the
Spearman Gram from the same shipped batches: grid ranks by kernel K5, or K6
then K3 past 512 columns, and past 2,048 the reference's exact tier; host:
the exact top-k recount).
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
Pass A's HyperLogLog observations of float32 lanes are made on the device
instead (``fused.hll_regs``, from the batch K1 reads), lane by lane, when
the runner is one CUDA device (``Runner.hashes_on_device``), ``exact_distinct``
is off and the native hash library builds in every process
(:func:`device_hash_lanes`); the registers are the host's bit for bit, so
the two routes' registers combine by max wherever they meet.
Numeric values are profiled in float32.

The ingest guard (``runtime/guard.py``) wraps both passes: a transient
prepare error retries, and with ``max_quarantined`` set a batch whose
prepare keeps failing or whose pass-A fold raises is skipped and reported
(``stats["_quarantine"]``), in pass B too, so it counts in neither pass.
Each copy of a device state to the host runs under ``drain_timeout_s``.

Spans (``obs/spans.py``): ``ingest_open``, ``scan_a``, ``merge``,
``scan_b`` and ``assemble`` on the thread that runs the profile; inside
the scans, quiet spans a batch or a staged group: ``wait_*`` (the next
prepared batch), ``sampler_a``, ``hll_host_a``, ``hostagg_a`` and
``recount_b`` (the host folds), ``stage_*`` (stacking, pinning, the
copy's enqueue), ``launch_*`` (the kernels' launches, and pass A's state
set-up) and ``drain_b``; after ``merge`` and inside ``assemble``, the
quiet span ``corr_host`` (the Pearson matrix's host work, which grows with
the square of the numeric columns: ``kcorr.finalize`` of pass A's Gram,
the (C, C) frame and ``schema.reject_by_correlation``).  No name but the
scans' starts with ``scan``: the report footer's rows/s sums those.

With ``checkpoint_path`` set, pass A saves its fold state every
``checkpoint_every_batches`` batches (:class:`CollectCheckpoint`), and a
rerun after a crash resumes from the newest good save.  Staged copies are
capped at :data:`STAGE_BYTES` of host planes.

Devices and processes: several devices row-shard every batch
(``runtime/mesh.py``); a process group (``runtime/distributed.py``) stripes
a dataset's fragments over its ranks, agrees one centering shift, and
merges the finalized states and host sketches over gloo after each pass,
so every rank returns the whole table's stats; an elastic member
(``runtime/fleet.py``) pulls fragments off a shared manifest and merges
the members' contribution parts, stealing a dead member's fragments.  Both
keep two passes (a fused profile is demoted, with a warning) and take the
pass-B bounds from the merged state.
"""

from __future__ import annotations

import dataclasses
import itertools
import logging
import os
import time
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import pandas as pd
import pyarrow as pa
import torch

from tpuprof_torch import _build, native, obs, schema
from tpuprof_torch.config import (ProfilerConfig, resolve_checkpoint_keep,
                                  resolve_elastic,
                                  resolve_fleet_dir, resolve_fleet_host_id,
                                  resolve_ingest_retries,
                                  resolve_liveness_timeout,
                                  resolve_max_quarantined,
                                  resolve_prepare_workers,
                                  resolve_profile_passes,
                                  resolve_quarantine_log,
                                  resolve_retry_backoff,
                                  resolve_spill_workers,
                                  resolve_unique_budget,
                                  resolve_unique_partitions,
                                  resolve_watchdog_timeout)
from tpuprof_torch.errors import HostDeathError, InputError
from tpuprof_torch.ingest.arrow import (ArrowIngest, ColumnPlan, HostBatch,
                                        float32_hash_lanes,
                                        prefetch_prepared)
from tpuprof_torch.ingest.sample import RowSampler
from tpuprof_torch.kernels import corr as kcorr
from tpuprof_torch.kernels import histogram as khistogram
from tpuprof_torch.kernels import hll as khll
from tpuprof_torch.kernels import moments as kmoments
from tpuprof_torch.kernels import unique as kunique
from tpuprof_torch.kernels.topk import MisraGries
from tpuprof_torch.kernels.unique import UniqueTracker
from tpuprof_torch.obs.spans import get_phase_report, span
from tpuprof_torch.runtime import checkpoint as ckpt
from tpuprof_torch.runtime import distributed
from tpuprof_torch.runtime import fleet as fleetrt
from tpuprof_torch.runtime import guard, singlepass
from tpuprof_torch.runtime.mesh import local_devices
from tpuprof_torch.serve.cache import acquire_runner
from tpuprof_torch.testing import faults

logger = logging.getLogger("tpuprof_torch")


_END = object()


def _waited(stream, name: str):
    """``stream``'s items, each wait for one under quiet span ``name``;
    closing this closes ``stream``."""
    try:
        while True:
            with span(name, quiet=True):
                item = next(stream, _END)
            if item is _END:
                return
            yield item
    finally:
        stream.close()


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
        # classification for columns whose Misra-Gries summary overflows;
        # exact_distinct counts every column, numeric and date lanes from
        # their full 64-bit hashes (HostBatch.num_hashes).  Opaque nested
        # columns have no hash stream: nothing to track
        self.unique = UniqueTracker(
            (s.name for s in (plan.specs if config.exact_distinct
                              else plan.by_role("cat"))
             if not s.opaque),
            config.unique_track_rows,
            resolve_unique_budget(config.unique_track_total_rows),
            spill_dir=config.unique_spill_dir,
            count_exact=config.exact_distinct,
            own_spill_dir=config.spill_dir_auto,
            partitions=resolve_unique_partitions(config.unique_partitions),
            spill_workers=resolve_spill_workers(config.unique_spill_workers))
        # numeric and date columns whose count needs full hashes on every
        # batch (a batch without them breaks coverage)
        self._numdate_tracked = [s.name for s in plan.specs
                                 if s.role != "cat"] \
            if config.exact_distinct else []
        self._numkind = "native" if native.available() else "pandas"
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
        nh = hb.num_hashes or {}
        # getattr: a HostAgg pickled before exact distinct has no such list
        for name in getattr(self, "_numdate_tracked", ()):
            if not self.unique.active(name):
                continue
            h = nh.get(name)
            if h is None:
                # a batch prepared without full hashes: the count is no
                # longer sound
                self.unique.deactivate(name)
                continue
            self.unique.update(name, h, hash_kind=self._numkind)

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


def device_hash_lanes(plan: ColumnPlan, config: ProfilerConfig, runner,
                      use_host_hll: bool) -> List[Tuple[int, int]]:
    """The (numeric lane, hash lane) pairs whose pass-A HyperLogLog
    observations the device makes (``fused.hll_regs``): every float32 lane
    when the runner hashes on its device (one CUDA device), the host's
    hashes are the native library's splitmix64 in every process
    (``use_host_hll``; the pandas fallback is another hash family) and
    ``exact_distinct`` is off (its tracker needs each full 64-bit hash on
    the host).  Otherwise none."""
    if not (use_host_hll and getattr(runner, "hashes_on_device", False)
            and not config.exact_distinct):
        return []
    return [(s.num_lane, s.hash_lane) for s in float32_hash_lanes(plan)]


class HllRoute(NamedTuple):
    """Where one profile's pass-A lanes hash: ``lanes`` (a hash-lane
    set) on the device through the map ``lanes_d``, the ``host_runs`` of
    the rest on the host (``kernels.hll.lane_runs``)."""
    lanes: frozenset
    lanes_d: Optional[torch.Tensor]
    host_runs: List[Tuple[int, int]]


def hll_route(plan: ColumnPlan, config: ProfilerConfig, runner,
              use_host_hll: bool) -> HllRoute:
    pairs = device_hash_lanes(plan, config, runner, use_host_hll)
    lanes = frozenset(h for _, h in pairs)
    return HllRoute(lanes, runner.put_hll_lanes(pairs) if pairs else None,
                    khll.lane_runs(plan.n_hash, lanes))


class CollectCheckpoint:
    """Batch-granular resume of the pass-A scan (the reference's
    ``_CollectCheckpoint``).  Every ``checkpoint_every_batches``
    delivered batches the device state, the host sketches, the cursor, the
    (fragment, batch) position of the last consumed batch, the quarantine
    manifest and the stream positions pass A skipped are saved
    (``runtime/checkpoint.py``), after a flush of the device, so the cursor
    is the number of folded batches.  A single-pass scan also saves its
    histogram state and the provisional edges it bins on.  A rerun with the
    same path loads the newest good generation and skips the folded prefix
    without decoding it: whole fragments of a Parquet source, zero-copy
    slices of a table.  A run that completes removes the chain.

    Across processes each saves its own stripe's scan to ``PATH.h<i>of<N>``
    (``pshard=(i, N)``; their cursors are independent), the meta pins
    ``process_id`` and ``process_count``, and the collect holds a resume
    barrier so every process knows who restored.  An elastic member's save
    carries the fragments it finished (``fleet_done``)."""

    def __init__(self, config: ProfilerConfig, plan, runner,
                 source_fp: str, table_source: bool, fused: bool,
                 pshard: Tuple[int, int] = (0, 1)):
        self.pshard = pshard
        self.path = config.checkpoint_path
        if pshard[1] > 1:
            self.path = f"{self.path}.h{pshard[0]}of{pshard[1]}"
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

    # meta keys an older checkpoint lacks, and the value it ran with
    _ABSENT = {"process_id": 0, "process_count": 1}

    def _meta(self) -> Dict[str, Any]:
        """What a resume must share with the saved prefix: the reference's
        meta keys."""
        c = self.config
        return {"n_num": self.plan.n_num, "n_hash": self.plan.n_hash,
                "batch_rows": c.batch_rows,
                "hll_precision": c.hll_precision,
                "native_hash": native.available(),
                "source_fp": self.source_fp,
                "quantile_sketch_size": c.quantile_sketch_size,
                "topk_capacity": c.topk_capacity, "seed": c.seed,
                "process_id": self.pshard[0],
                "process_count": self.pshard[1],
                # a table is enumerated in fixed combined windows
                "batch_enum": "window-v2" if self.table_source else None,
                # the tracker's columns and hash coverage differ by mode
                "exact_distinct": c.exact_distinct, "nested": c.nested,
                "profile_passes": "fused" if self.fused else "two_pass"}

    def save(self, state, sampler, hostagg, host_hll, cursor, frag_pos,
             quarantine, skipped, hist_state=None, edges=None,
             fleet_done=None) -> None:
        # the save references the tracker's spill runs by path: from now on
        # a crash must leave them on disk (the flag pickles with it)
        hostagg.unique.persistent = True
        blob = {"sampler": sampler, "hostagg": hostagg,
                "host_hll": host_hll,
                "frag_pos": tuple(frag_pos) if frag_pos else None,
                "quarantine": list(quarantine.entries),
                "skipped": sorted(skipped)}
        if fleet_done is not None:
            # an elastic member's finished fragments, durable with the
            # fold state that covers them
            blob["fleet_done"] = sorted(int(k) for k in fleet_done)
        meta = self._meta()
        meta["has_state"] = state is not None
        if state is not None:
            state = self.runner.finalize(state)
        if hist_state is not None:
            # the histogram fold rides the same archive; a resume bins the
            # rest of the stream on the same edges
            state = {"a": state, "hist": self.runner.finalize(hist_state)}
            blob["singlepass_edges"] = edges.as_blob()
        with span("checkpoint"):
            ckpt.save(self.path, state, blob, cursor, meta=meta,
                      keep=self.keep)
        # runs dropped since the previous save are referenced no more
        hostagg.unique.reap_retired()
        self.last_saved = cursor

    def load(self):
        """(state, sampler, hostagg, host_hll, cursor, frag_pos,
        quarantine entries, skipped positions, histogram state, edges,
        the elastic member's finished fragments or None) of the newest good
        generation, after refusing a run whose batch stream or sketch
        shapes differ from the saved prefix's."""
        with span("resume"):
            payload, _used = ckpt.restore_payload(self.path)
            meta, mine = payload["meta"], self._meta()
            for key in mine:
                if meta.get(key, self._ABSENT.get(key)) != mine[key]:
                    raise InputError(
                        f"checkpoint {key}={meta.get(key)!r} does not match "
                        f"this run's {mine[key]!r} — the batch stream or "
                        "sketch shapes would diverge from the saved prefix")
            blob = payload["host_blob"]
            # a mesh restores through one device's runner, then spreads
            unit = getattr(self.runner, "runners", [self.runner])[0]
            state = hist_state = edges = None
            if meta.get("has_state"):
                if "singlepass_edges" in blob:
                    both = ckpt.materialize(
                        payload, {"a": unit.init_pass_a(),
                                  "hist": unit.init_pass_b()}, unit.device)
                    state, hist_state = both["a"], both["hist"]
                    edges = singlepass.ProvisionalEdges.from_blob(
                        blob["singlepass_edges"])
                else:
                    state = ckpt.materialize(
                        payload, unit.init_pass_a(), unit.device)
            if unit is not self.runner:
                state, hist_state = (None if st is None
                                     else self.runner.place_state(st)
                                     for st in (state, hist_state))
        self.last_saved = payload["cursor"]
        return (state, blob["sampler"], blob["hostagg"], blob["host_hll"],
                payload["cursor"], blob["frag_pos"], blob["quarantine"],
                set(blob["skipped"]), hist_state, edges,
                blob.get("fleet_done"))

    def clear(self) -> None:
        ckpt.clear(self.path)


# ---------------------------------------------------------------------------
# The elastic fleet (runtime/fleet.py): claimed fragments, stolen re-scans,
# the merges of contribution parts
# ---------------------------------------------------------------------------

def _fleet_stream(member, phase, ingest, resume_frag=None, replay=()):
    """The batches a member scans: the adopted checkpoint's partial
    fragment from its saved batch on, then the adopted claims whose fold
    state died with the predecessor (from scratch), then fresh claims off
    the manifest until it is exhausted.  One fragment at a time, so a slow
    member claims less."""
    if resume_frag is not None:
        fi, bi = resume_frag
        yield from ingest.read_fragment(fi, skip_batches=bi + 1)
    for fi in replay:
        yield from ingest.read_fragment(fi)
    while True:
        fi = member.claim_next(phase)
        if fi is None:
            return
        yield from ingest.read_fragment(fi)


def _read_fragments(ingest, frags):
    for fi in frags:
        yield from ingest.read_fragment(fi)


def _scan_fragments_pass_a(frags, ingest, plan, pad, config, runner,
                           batch_guard, use_host_hll, route: HllRoute):
    """A fresh finalized pass-A part of ``frags`` scanned from scratch (a
    stolen or fenced fragment set: the owner's partial folds died with it).
    Returns the contribution payload."""
    hostagg = HostAgg(plan, config)
    sampler = RowSampler(config.quantile_sketch_size, plan.n_num,
                         seed=config.seed)
    host_hll = khll.HostRegisters(plan.n_hash, config.hll_precision) \
        if use_host_hll else None
    state = None
    q_entries = []
    for hb in prefetch_prepared(
            ingest, pad, config.hll_precision,
            workers=resolve_prepare_workers(config.prepare_workers),
            prep_workers=config.prep_workers, batch_guard=batch_guard,
            full_hashes=config.exact_distinct,
            raw_stream=_read_fragments(ingest, frags),
            device_lanes=route.lanes):
        if isinstance(hb, guard.PoisonBatch):
            # the skip rides the part to every member's report
            q_entries.append({"site": hb.site + "_stolen", "cursor": None,
                              "rows": hb.rows,
                              "frag_pos": list(hb.frag_pos)
                              if hb.frag_pos else None,
                              "error": hb.error})
            continue
        if state is None:
            state = runner.init_pass_a(estimate_shift(hb))
        state = runner.fold_a(state, runner.ship(
            [hb], with_hll=host_hll is None, hll_lanes=route.lanes_d))
        sampler.update(hb.x, hb.nrows)
        if host_hll is not None and route.host_runs:
            host_hll.update(hb.hll, hb.nrows, route.host_runs)
        hostagg.update(hb)
    if state is None:
        state = runner.init_pass_a()
    hostagg.unique.persistent = True     # the part references the runs
    return {"kind": "pass_a", "res_a": runner.finalize(state),
            "hostagg": hostagg, "sampler": sampler, "host_hll": host_hll,
            "quarantine": q_entries, "rows": int(hostagg.n_rows)}


def _part_regs(part):
    """A part's HLL registers: its device registers (the lanes hashed
    there, or every lane where the packed plane shipped), raised by its
    host registers where the member folded lanes on the host (the same
    format, bit for bit the same per lane)."""
    regs = part["res_a"]["hll"]
    hh = part.get("host_hll")
    return regs if hh is None else np.maximum(regs, hh.regs)


def _elastic_merge_a(member, res_a, hostagg, sampler, host_hll, quarantine,
                     steal_scan, timeout_s):
    """Contribute this member's finalized pass-A part (fenced), hold the
    finish barrier (stealing dead members' fragments) and fold every part
    with the laws the gathers use.  Returns ``(res_a, hostagg, sampler,
    hll registers, quarantine entries, index of this member's first
    post-contribution entry)``."""
    hostagg.unique.persistent = True     # the part references the runs
    q_mark = len(quarantine.entries)
    mine = {"kind": "pass_a", "res_a": res_a, "hostagg": hostagg,
            "sampler": sampler, "host_hll": host_hll,
            "quarantine": list(quarantine.entries),
            "rows": int(hostagg.n_rows)}
    parts = member.finish("a", mine, sorted(member.claimed("a")),
                          steal_scan, timeout_s=timeout_s)
    regs = _part_regs(parts[0]).copy()
    for part in parts[1:]:
        regs = np.maximum(regs, _part_regs(part))
    q_entries = [e for p in parts for e in (p.get("quarantine") or [])]
    res_a = distributed.merge_pass_a_parts([p["res_a"] for p in parts])
    hostagg = distributed.merge_host_agg_parts(
        [p["hostagg"] for p in parts])
    sampler = distributed.merge_sampler_parts([p["sampler"] for p in parts])
    logger.debug("fleet_merge_a: %d parts, %d rows", len(parts),
                 int(hostagg.n_rows))
    return res_a, hostagg, sampler, regs, q_entries, q_mark


def _elastic_merge_b(member, my_part, steal_scan, timeout_s):
    """Pass B's twin: contribute, barrier, fold.  Returns ``(res_b, recount
    vectors, Spearman rho)``, ``res_b`` and rho None for recount-only
    parts."""
    parts = member.finish("b", my_part, sorted(member.claimed("b")),
                          steal_scan, timeout_s=timeout_s)
    res_bs = [p["res_b"] for p in parts if p.get("res_b") is not None]
    res_b = distributed.merge_pass_b_parts(res_bs) if res_bs else None
    counts = distributed.merge_recount_parts([p["counts"] for p in parts])
    spears = [p["spear"] for p in parts if p.get("spear") is not None]
    rho_spear = kcorr.finalize(distributed.merge_corr_parts(spears)) \
        if spears else None
    logger.debug("fleet_merge_b: %d parts", len(parts))
    return res_b, counts, rho_spear


class GPUStatsBackend:
    """Profile a table in two passes or, with ``profile_passes="fused"``,
    in one: on ``device``, or row-sharded over ``devices``
    (``runtime/mesh.py``; by default every CUDA device the process sees,
    cut to ``mesh_devices``), as one rank of a process group
    (``runtime/distributed.py``) or one member of an elastic fleet
    (``runtime/fleet.py``)."""

    name = "gpu"

    def __init__(self, device=None, devices=None):
        self._device = device
        self._devices = devices

    def _runner(self, config: ProfilerConfig, plan):
        """One device's :class:`Runner`, or a :class:`MeshRunner` when the
        devices are several, through the runner cache's acquire seam
        (``serve/cache.py``: a repeat shape reuses its runner, and a miss
        consults the store of built kernel libraries)."""
        devices = self._devices
        if devices is None:
            if self._device is not None:
                devices = [self._device]
            else:
                devices = local_devices(config.mesh_devices)
                if len(devices) < 2:
                    # one card, or none: resolve_device says which
                    devices = None
        return acquire_runner(config, plan.n_num, plan.n_hash, devices)

    def collect(self, source: Any, config: ProfilerConfig) -> Dict[str, Any]:
        # this profile's phase seconds ride its own stats dict: drop what
        # an earlier profile left
        get_phase_report(reset=True)
        obs.configure_from_config(config)   # metrics and the JSONL sink
        if config.compile_cache_dir:
            # the process's nvcc build directory (as the reference's
            # field points jax's compilation cache, process-wide)
            _build.set_build_dir(config.compile_cache_dir)
        pshard = distributed.process_info()
        # a postmortem from this process names its rank
        obs.blackbox.set_context(process_index=pshard[0],
                                 process_count=pshard[1])
        # an elastic member pulls fragments off a shared manifest and
        # merges contribution parts instead of joining gathers
        elastic = resolve_elastic(config.elastic)
        if elastic:
            if pshard[1] > 1:
                raise InputError(
                    "elastic fleet mode replaces the process group (its "
                    "gathers cannot survive a lost member) — launch "
                    "independent processes sharing --fleet-dir instead of "
                    "--coordinator/--num-processes")
            if not resolve_fleet_dir(config.fleet_dir):
                raise InputError(
                    "elastic mode needs fleet_dir (--fleet-dir / "
                    "TPUPROF_FLEET_DIR) on storage shared by every member")
        multi = pshard[1] > 1
        with span("ingest_open"):
            ingest = ArrowIngest(source, config.batch_rows,
                                 columns=config.columns,
                                 nested=config.nested, process_shard=pshard)
        plan = ingest.plan
        if not plan.specs:
            return _empty_stats(config)
        runner = self._runner(config, plan)
        pad = runner.rows
        workers = resolve_prepare_workers(config.prepare_workers)
        # single-pass profiles (runtime/singlepass.py): pass A folds the
        # histograms too, on provisional edges from an artifact or the
        # first batch.  Processes and members would bin on edges nobody
        # agreed on, so they keep two passes, as the reference does
        fused_scan = resolve_profile_passes(config.profile_passes) \
            == "fused" and plan.n_num > 0
        if fused_scan and (multi or elastic):
            logger.warning(
                "profile_passes=fused is single-process only (merges "
                "across processes need agreed bin edges) — running the "
                "two-pass structure; results are identical")
            fused_scan = False
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
        barrier_timeout = resolve_watchdog_timeout(
            config.barrier_timeout_s, "TPUPROF_BARRIER_TIMEOUT_S")
        skipped = set()         # stream positions pass A quarantined

        hostagg = HostAgg(plan, config)

        def drained(st):
            """``runner.finalize(st)``, the copy of a device state to the
            host, which waits on the card, under the drain watchdog."""
            def wait():
                faults.hit("device_wait")
                return runner.finalize(st)
            return guard.watched(wait, drain_timeout, site="device_wait",
                                 heartbeat=lambda: {
                                     "rows": int(hostagg.n_rows),
                                     "skipped": len(skipped)})

        sampler = RowSampler(config.quantile_sketch_size, plan.n_num,
                             seed=config.seed, process_index=pshard[0])
        # HLL registers fold on the host when the native library builds in
        # every process (merges must mix like with like); otherwise the
        # packed plane ships to the device scatter-max
        use_host_hll = plan.n_hash > 0 and all(
            distributed.allgather_objects(native.available()))
        host_hll = khll.HostRegisters(plan.n_hash, config.hll_precision) \
            if use_host_hll else None
        route = hll_route(plan, config, runner, use_host_hll)
        khll.record_routes(len(route.lanes), plan.n_hash - len(route.lanes))

        fleet_member = None
        if elastic:
            # the manifest's fingerprint pins the source and the knobs that
            # change how it splits into batches
            fleet_member = fleetrt.FleetMember(
                resolve_fleet_dir(config.fleet_dir),
                resolve_fleet_host_id(config.fleet_host_id),
                ingest.fragment_count(),
                f"{ingest.fingerprint()}:{config.batch_rows}"
                f":{config.nested}",
                liveness_timeout_s=resolve_liveness_timeout(
                    config.liveness_timeout_s))

        # ---- checkpoint / resume of pass A --------------------------------
        state = None
        state_h = None          # the fused scan's histogram state
        sp_edges = None         # ... and the provisional edges it bins on
        edges_d = None
        cursor = 0              # batches consumed from the stream
        last_frag = None        # (fragment, batch) of the last of them
        fleet_ck_done = None    # an elastic member's saved finished set
        resume = CollectCheckpoint(
            config, plan, runner, ingest.fingerprint(),
            table_source=ingest._table is not None, fused=fused_scan,
            pshard=pshard) if config.checkpoint_path else None
        restored = resume is not None and resume.exists()

        def fresh():
            nonlocal state, state_h, sp_edges, cursor, last_frag, hostagg
            nonlocal sampler, host_hll, fleet_ck_done, restored
            restored = False
            state = state_h = sp_edges = last_frag = fleet_ck_done = None
            cursor = 0
            quarantine.seed([])
            skipped.clear()
            hostagg = HostAgg(plan, config)
            sampler = RowSampler(config.quantile_sketch_size, plan.n_num,
                                 seed=config.seed, process_index=pshard[0])
            host_hll = khll.HostRegisters(plan.n_hash,
                                          config.hll_precision) \
                if use_host_hll else None

        if restored:
            try:
                (state, sampler, hostagg, host_hll, cursor, last_frag,
                 prior_q, prior_skip, state_h, sp_edges,
                 fleet_ck_done) = resume.load()
            except Exception as exc:
                if not multi:
                    raise
                # one process's unreadable chain must not end it while its
                # peers wait in the resume barrier: it rescans its stripe,
                # every restored accumulator reset
                logger.warning(
                    "process %d: checkpoint %r failed to load (%s); "
                    "rescanning this process's stripe from zero",
                    pshard[0], resume.path, exc)
                fresh()
            else:
                # the checkpoint references the restored tracker's runs
                hostagg.unique.persistent = True
                # a degraded prefix stays degraded, and its skipped
                # batches stay out of pass B
                quarantine.seed(prior_q)
                skipped.update(prior_skip)
        if resume is not None and multi:
            # the resume barrier: every process says whether it restored
            # before any scanning starts.  A mixed group is correct (a
            # fresh process rescans its own stripe), and said out loud
            with span("resume_barrier", rank=pshard[0], restored=restored):
                peers = distributed.allgather_with_watchdog(
                    (pshard[0], restored, cursor), barrier_timeout,
                    site="resume_barrier",
                    heartbeat=lambda: {"rank": pshard[0],
                                       "restored": restored,
                                       "cursor": int(cursor)})
            logger.debug("multihost_resume_barrier: %s", peers)
            distributed.publish_fleet(
                "resume_barrier",
                metrics_path=obs.resolve_metrics_path(config),
                quarantined=len(quarantine.entries))
            if {r for _, r, _ in peers} == {True, False}:
                logger.warning(
                    "multi-process resume: processes %s restored a "
                    "checkpoint but processes %s start from zero (their "
                    "checkpoints are missing or were cleared) — results "
                    "are unaffected; the fresh processes rescan their "
                    "stripes", sorted(p for p, r, _ in peers if r),
                    sorted(p for p, r, _ in peers if not r))
        fleet_replay: List[int] = []
        resume_frag = last_frag if restored else None
        if fleet_member is not None:
            # the join barrier: claims the adopted checkpoint covers are
            # final; claims marked done after its last save, and claims
            # with no checkpoint at all, are replayed from scratch
            ck_done = set(fleet_ck_done or []) if restored else set()
            in_progress = {resume_frag[0]} if resume_frag else set()
            stolen_cover = sorted((ck_done | in_progress)
                                  - fleet_member.claimed("a"))
            if restored and stolen_cover:
                # fragments of the restored fold were stolen while this
                # member was down: the fold cannot subtract them, so it
                # goes, and the still-owned claims are scanned again
                logger.warning(
                    "fleet member %s: fragments %s of the adopted "
                    "checkpoint were stolen by survivors while this member "
                    "was down — discarding the restored fold and "
                    "rescanning the still-owned claims from zero",
                    fleet_member.host_id, stolen_cover)
                fresh()
                resume_frag = None
                ck_done, in_progress = set(), set()
                resume.last_saved = -1
            for k in sorted(ck_done):
                fleet_member.mark_done("a", k)
            fleet_replay = sorted(fleet_member.claimed("a") - ck_done
                                  - in_progress)
            fleet_member.undo_done("a", fleet_replay)
            if restored:
                logger.debug("fleet_adopt: %s at cursor %d, done %s, "
                             "replay %s", fleet_member.host_id, cursor,
                             sorted(ck_done), fleet_replay)
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

        def flush_group(pending, fold):
            """The staged-vs-tail flush policy of both passes: a FULL group
            ships as one stacked copy and folds as one group; a partial
            group (the tail, a checkpoint) ships and folds batch by batch,
            as groups of one.  Both run the same per-batch kernel calls in
            the same order."""
            if len(pending) == scan_s:
                fold(pending)
            else:
                for p in pending:
                    fold([p])
            pending.clear()

        # ---- pass A (with the provisional histograms when fused) ---------
        # a checkpointed scan streams by (fragment, batch) positions, so a
        # resume opens no fragment the saved prefix covers; an elastic
        # member streams its claims
        batches = _waited(prefetch_prepared(
            ingest, pad, config.hll_precision, depth=depth, workers=workers,
            prep_workers=config.prep_workers, batch_guard=batch_guard,
            positions=resume is not None,
            resume_pos=(last_frag[0], last_frag[1] + 1)
            if last_frag is not None else None,
            full_hashes=config.exact_distinct, device_lanes=route.lanes,
            raw_stream=_fleet_stream(fleet_member, "a", ingest,
                                     resume_frag=resume_frag,
                                     replay=fleet_replay)
            if fleet_member is not None else None), "wait_a")
        pending: List[HostBatch] = []

        def fold_group_a(group):
            nonlocal state, state_h
            with span("stage_a", quiet=True):
                g = runner.ship(group, with_hll=with_hll,
                                hll_lanes=route.lanes_d)
            with span("launch_a", quiet=True):
                if state_h is not None:
                    state, state_h = runner.fold_ab(state, state_h, g,
                                                    *edges_d)
                else:
                    state = runner.fold_a(state, g)

        def save():
            """A checkpoint after the device folded every pending batch:
            the saved cursor is the folded count."""
            flush_group(pending, fold_group_a)
            resume.save(state, sampler, hostagg, host_hll, cursor,
                        last_frag, quarantine, skipped, state_h, sp_edges,
                        fleet_done=fleet_member.done("a")
                        if fleet_member is not None else None)

        # elastic done-marking: fragment k is done once a batch of a later
        # fragment arrives (delivery is in order); the last at the end
        cur_frag = [resume_frag[0] if resume_frag else None]

        def note_frag(fp):
            if fleet_member is None or fp is None:
                return
            if cur_frag[0] is not None and fp[0] != cur_frag[0]:
                fleet_member.mark_done("a", cur_frag[0])
            cur_frag[0] = fp[0]

        def host_death(key):
            # the kill switch of a rank or member: neither retried nor
            # quarantined; a member leaves loudly (its heartbeat goes) so
            # survivors steal at once
            try:
                faults.hit("host_death", key=key)
            except HostDeathError:
                if fleet_member is not None:
                    fleet_member.depart()
                raise

        with span("scan_a", cols=len(plan.specs), n_num=plan.n_num,
                  n_hash=plan.n_hash):
            # the centering shift comes from the first real batch; across
            # processes it is agreed (every process takes part, one with an
            # empty stripe too), so the merge's rebase is the identity
            head: List[Any] = []
            first_hb = next(batches, None)
            while isinstance(first_hb, guard.PoisonBatch):
                head.append(first_hb)
                first_hb = next(batches, None)
            shift = estimate_shift(first_hb) if first_hb is not None \
                else None
            if multi:
                # a restored process takes part too; its state keeps the
                # shift it was built with (the merge rebases exactly)
                shift = distributed.merge_shift_estimates(shift)
            if first_hb is not None:
                head.append(first_hb)
            if state is None and shift is not None:
                # the state's allocation and fills: launches too
                with span("launch_a", quiet=True):
                    state = runner.init_pass_a(shift)
            if fused_scan and first_hb is not None and state_h is None:
                sp_edges = singlepass.sketch_edges(first_hb.x,
                                                   first_hb.nrows,
                                                   into=sp_seeds)
                state_h = runner.init_pass_b()
                edges_d = tuple(runner.put_replicated(a) for a in (
                    sp_edges.lo, sp_edges.hi, sp_edges.mean))
            for hb in itertools.chain(head, batches):
                key = cursor        # the batch's position in the stream
                cursor += 1
                note_frag(hb.frag_pos)
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
                host_death(key)
                # host folds run while the device works on earlier groups
                try:
                    faults.hit("fold", key=key)
                    with span("sampler_a", quiet=True):
                        sampler.update(hb.x, hb.nrows)
                    if host_hll is not None and route.host_runs:
                        with span("hll_host_a", quiet=True):
                            host_hll.update(hb.hll, hb.nrows,
                                            route.host_runs)
                    with span("hostagg_a", quiet=True):
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
                    flush_group(pending, fold_group_a)
            flush_group(pending, fold_group_a)
            if fleet_member is not None and cur_frag[0] is not None:
                # the stream drained: the last fragment read is folded
                fleet_member.mark_done("a", cur_frag[0])
            if state is None:
                state = runner.init_pass_a()
            # the end of pass A: device and host memory headroom
            obs.memory.sample(runner.device)
        if resume is not None and resume.last_saved != cursor:
            # pass A complete: a crash in pass B resumes with the whole
            # stream skipped; cleared once the stats are assembled
            save()

        # the exact pass-B inputs, computed on the device (no host round
        # trip before pass B in one process): what K2 bins with, what a
        # fused profile's provisional edges are held to, and what the
        # artifact seeds carry.  Across processes and members they come
        # from the merged state, so every one bins alike
        fleet_regs = fleet_q = None
        fleet_q_mark = 0
        bounds_d = exact = None
        with span("merge", hosts=pshard[1]):
            if not (multi or elastic):
                bounds_d = runner.bounds_b_device(state) \
                    if plan.n_num > 0 else None
                res_a = drained(state)
            else:
                res_a = drained(state)
                if fleet_member is not None:
                    def steal_scan_a(frags):
                        return _scan_fragments_pass_a(
                            frags, ingest, plan, pad, config, runner,
                            batch_guard, use_host_hll, route)
                    (res_a, hostagg, sampler, fleet_regs, fleet_q,
                     fleet_q_mark) = _elastic_merge_a(
                        fleet_member, res_a, hostagg, sampler, host_hll,
                        quarantine, steal_scan_a, barrier_timeout)
                else:
                    res_a = distributed.merge_pass_a_states(res_a)
                    hostagg = distributed.merge_host_aggs(hostagg)
                    # one k-way spill resolve (rank 0), adopted by all
                    distributed.resolve_unique_distributed(hostagg.unique)
                    sampler = distributed.merge_samplers(sampler)
                if plan.n_num > 0:
                    bounds_d = runner.bounds_b_device(
                        runner.place_state(res_a))
            if bounds_d is not None:
                exact = singlepass.exact_triple(bounds_d)
        momf = kmoments.finalize(res_a["mom"])
        with span("corr_host", quiet=True):
            rho_all = kcorr.finalize(res_a["corr"])
        probes = list(config.quantile_probes)
        quants = sampler.quantiles(probes)
        sample_vals, sample_kept = sampler.columns()
        # the device registers (device-hashed lanes, or every lane where
        # the packed plane shipped) raised by the host's: each lane's
        # registers are the same bits whichever route made them
        if fleet_regs is not None:
            hll_est = khll.finalize(fleet_regs)
        elif host_hll is not None:
            hll_est = khll.finalize(np.maximum(
                res_a["hll"], distributed.merge_hll_registers(host_hll).regs))
        else:
            hll_est = khll.finalize(res_a["hll"])
        # with no numeric lane the second scan is the top-k recount alone
        run_pass_b = config.exact_passes and ingest.rescannable \
            and hostagg.n_rows > 0

        # ---- fused: which lanes the provisional edges got right ----------
        res_h = None            # the fused histograms, finalized
        rebin = None            # lanes a second scan re-bins (fused)
        adopted = None          # fused histograms taken as they are
        exact_lanes = None      # lanes whose histogram/MAD are exact
        if state_h is not None and hostagg.n_rows > 0:
            res_h = drained(state_h)
            hits = singlepass.hit_lanes(sp_edges, exact)
            singlepass.record_outcome(hits)
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
        def pass_b_batches(raw_stream=None):
            """Pass B's batches without those pass A skipped; a batch that
            fails here only is quarantined under the same budget.  An
            elastic member reads its phase-b claims (``raw_stream``)."""
            if raw_stream is None and fleet_member is not None:
                raw_stream = _fleet_stream(
                    fleet_member, "b", ingest,
                    replay=sorted(fleet_member.claimed("b")))
            for hb in prefetch_prepared(
                    ingest, pad, config.hll_precision, depth=depth,
                    hashes=False, workers=workers,
                    prep_workers=config.prep_workers,
                    batch_guard=batch_guard, skip_keys=frozenset(skipped),
                    raw_stream=raw_stream):
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
            state_b = spear_state = spear_in = None
            lo_d = hi_d = mean_d = lanes_d = None
            if rebin is None:
                if bounds_d is not None:    # else no numeric lane
                    state_b = runner.init_pass_b()
                    lo_d, hi_d, mean_d = bounds_d
            elif len(rebin):
                # the missed lanes only, on the exact triple the hit check
                # held them to
                faults.hit("singlepass_rebin")
                state_b = runner.init_pass_b(len(rebin))
                lo_d, hi_d, mean_d = (runner.put_replicated(a[rebin])
                                      for a in exact)
                lanes_d = torch.as_tensor(rebin, device=runner.device)
            # else all hit: the second scan is for others
            if config.spearman and plan.n_num > 0:
                # ranks on the runner's tier: the sample's CDF grid, or
                # past the rank kernels' columns the sorted sample
                spear_state = runner.init_spearman()
                spear_in = runner.spearman_inputs(
                    sampler, config.spearman_grid, hostagg.n_rows)
            # ship only the missed columns when nothing else reads the
            # batch; with Spearman on the whole plane ships for the rank
            # kernels and the re-bin takes its columns from it on the
            # device (lanes_d)
            subset = rebin is not None and spear_state is None

            def fold_b(group, st_b, sp_st):
                """Ship ``group`` and fold it into the histogram and
                Spearman states, either of which may be None; nothing
                ships when neither exists.  One transfer feeds K2 and the
                rank kernels."""
                if st_b is None and sp_st is None:
                    return st_b, sp_st
                with span("stage_b", quiet=True):
                    g = runner.ship([dataclasses.replace(hb, x=hb.x[:, rebin])
                                     if subset else hb for hb in group],
                                    with_hll=False)
                with span("launch_b", quiet=True):
                    if st_b is not None:
                        st_b = runner.fold_b(st_b, g, lo_d, hi_d, mean_d,
                                             None if subset else lanes_d)
                    if sp_st is not None:
                        sp_st = runner.fold_spearman(sp_st, g, spear_in)
                return st_b, sp_st

            def fold_group_b(group):
                nonlocal state_b, spear_state
                state_b, spear_state = fold_b(group, state_b, spear_state)

            def steal_scan_b(frags):
                """A fresh finalized pass-B part of stolen fragments (the
                bounds and candidates are the fleet's, so any member can
                recount any fragment), folded batch by batch."""
                st_b = runner.init_pass_b() if state_b is not None else None
                sp_st = runner.init_spearman() \
                    if spear_state is not None else None
                rec = Recounter(hostagg)
                for shb in pass_b_batches(_read_fragments(ingest, frags)):
                    rec.update(shb)
                    st_b, sp_st = fold_b([shb], st_b, sp_st)
                return {"kind": "pass_b", "counts": rec.counts,
                        "res_b": None if st_b is None
                        else runner.finalize(st_b),
                        "spear": None if sp_st is None
                        else runner.finalize(sp_st)}

            pending_b: List[HostBatch] = []
            t0_b = time.perf_counter()
            with span("scan_b", **({"spearman": config.spearman}
                                   if plan.n_num else {"recount_only": True})):
                for hb in _waited(pass_b_batches(), "wait_b"):
                    with span("recount_b", quiet=True):
                        recounter.update(hb)
                    pending_b.append(hb)
                    if len(pending_b) >= scan_s:
                        flush_group(pending_b, fold_group_b)
                flush_group(pending_b, fold_group_b)
                with span("drain_b", quiet=True):
                    res_b = drained(state_b) if state_b is not None else None
                if fleet_member is not None:
                    res_b, recounter.counts, rho_spear = _elastic_merge_b(
                        fleet_member,
                        {"kind": "pass_b", "res_b": res_b,
                         "counts": recounter.counts,
                         "spear": drained(spear_state)
                         if spear_state is not None else None},
                        steal_scan_b, barrier_timeout)
                    spear_state = None  # finalized and merged above
                elif multi:
                    if res_b is not None:
                        res_b = distributed.merge_pass_b_states(res_b)
                    # each process recounted its own stripe
                    recounter.counts = distributed.merge_recount_arrays(
                        recounter.counts)
            if rebin is not None:
                # hit lanes keep their fused counts, missed lanes take the
                # re-bin: two-pass's result, lane for lane
                if res_b is not None:
                    res_b = singlepass.merge_rebinned(res_h, res_b, rebin)
                    lane_names = {s.num_lane: s.name for s in plan.specs
                                  if s.role == "num"}
                    singlepass.record_rebin(
                        time.perf_counter() - t0_b,
                        [str(lane_names[i]) for i in rebin.tolist()],
                        sp_edges.origin)
                else:
                    res_b = res_h
            if res_b is not None:
                hists, mad = khistogram.finalize(
                    res_b, momf["fmin"], momf["fmax"], momf["n"],
                    config.bins)
            if spear_state is not None:
                rho_spear = kcorr.finalize(distributed.merge_corr_states(
                    drained(spear_state)))
        elif adopted is not None:
            hists, mad = khistogram.finalize(
                adopted, momf["fmin"], momf["fmax"], momf["n"], config.bins)
        if config.spearman and not run_pass_b and hostagg.n_rows > 0 \
                and plan.n_num > 1:
            # no rank pass (exact_passes=False): estimate from the K-row
            # uniform sample, ~1/sqrt(K) rank error, and say so
            spear_approx = True
            rho_spear = sampler.spearman()

        with span("assemble"):
            stats = _assemble(plan, config, ingest.sample(config.sample_rows),
                              hostagg, momf, rho_all, quants, sample_vals,
                              sample_kept, hll_est, hists, mad, recounter,
                              probes, rho_spear, spear_approx, exact_lanes)
            if exact is not None:
                # the pass-B bounds a later fused profile of this source seeds
                # its edges from (artifacts seal them); private, never exported
                stats["_bin_seeds"] = singlepass.bin_seeds(plan, exact)
            q_entries = list(quarantine.entries)
            if fleet_member is not None:
                # the fleet's pass-A skips rode the parts, in part order; this
                # member's later (pass-B) entries follow
                q_entries = list(fleet_q or []) + q_entries[fleet_q_mark:]
            elif multi:
                # every process gathers every stripe's skips (symmetric)
                q_entries = [e for part in
                             distributed.allgather_objects(q_entries)
                             for e in part]
            if q_entries:
                # degraded runs only: a clean run's stats and HTML are as
                # before the guard existed
                stats["_quarantine"] = q_entries
            if multi and config.unique_spill_dir:
                # a shared spill dir: no process deletes runs another one may
                # still be reading
                distributed.allgather_objects("unique-cleanup-barrier")
            # the spill runs go before the checkpoint: a crash between the two
            # leaves a checkpoint whose missing runs demote on resume, never
            # runs that no checkpoint references
            hostagg.unique.cleanup()
            if resume is not None:
                resume.clear()          # the profile completed
        # private, never exported; the report footer reads it
        stats["_phases"] = get_phase_report(reset=True)
        # likewise the metrics snapshot for the footer's pipeline line,
        # after a last headroom reading; then the JSONL sink's final
        # snapshot and the fleet-of-one exposition
        obs.memory.sample(runner.device)
        snap = obs.snapshot_if_enabled()
        if snap is not None:
            stats["_obs"] = snap
        obs.finalize(reason="collect")
        if fleet_member is not None:
            # the members' wires ride the fleet dir; the live leader
            # writes the dump labelled by member id (no gather a dead
            # member could stall)
            fleet_member.publish(obs.resolve_metrics_path(config),
                                 reason="collect")
            fleet_member.close()
        elif multi or obs.enabled():
            # symmetric: every process reaches this line
            distributed.publish_fleet(
                "collect", metrics_path=obs.resolve_metrics_path(config),
                quarantined=len(quarantine.entries))
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
    # spilled columns are decided here (the merge over the disk runs);
    # exact_distinct columns also carry their exact counts
    unique_status = hostagg.unique.resolve()
    unique_counts = hostagg.unique.distinct_counts()
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
            elif spec.name in unique_counts:
                # exact_distinct: the full-hash stream counted exactly
                distinct = min(unique_counts[spec.name], count)
            else:
                distinct = int(round(hll_est[spec.hash_lane]))
                distinct = max(min(distinct, count), 1 if count else 0)
                distinct_approx = count > 0
        elif spec.role == "date":
            n_missing = hostagg.date_null[spec.name]
            count = n - n_missing
            if spec.name in unique_counts:
                distinct = min(unique_counts[spec.name], count)
            else:
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
            elif spec.name in unique_counts:
                # exact_distinct: the union count over the spill runs
                distinct = min(unique_counts[spec.name], count)
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
    with span("corr_host", quiet=True):
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
