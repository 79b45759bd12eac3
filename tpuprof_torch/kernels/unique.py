"""Exact per-column duplicate detection and distinct counting from the host
hash stream.

Counterpart of ``tpuprof/kernels/unique.py``'s ``UniqueTracker``.  The
reference's ``distinct == count -> UNIQUE`` classification is exact, and an
HLL estimate essentially never equals ``count``; this tracker answers the
one question classification needs — was any value seen twice? — exactly,
and in counting mode (``config.exact_distinct``) the distinct count itself.

Per column it keeps every seen 64-bit hash in sorted chunks; each batch is
sorted (exposing in-batch duplicates) and probed against the chunks.  The
first duplicate demotes the column to ``DUP`` and frees its storage.  Past
the in-memory budgets there are two tiers:

* ``spill_dir`` set — the column's consolidated sorted dup-free chunk
  spills to a disk run and tracking goes on; ``resolve()`` merges every run
  and the live chunks at the end, partition by partition, through memmap'd
  windows of the hash space, so RAM stays bounded however large the column.
* no ``spill_dir`` — the column demotes to ``OVERFLOW`` and its distinct
  count falls back to the HLL estimate, with the approximation warning.

Every hash goes to one of P partitions by its top bits, so each sort,
dedup, spill and resolve works on a cache-sized partition and partitions
never cross-merge.  Spill runs are the reference's ``TPUQRUN2`` files, the
same bytes for the same stream, and their writes overlap the scan on the io
tier (``ingest/prep.py``).  Distinct counts, UNIQUE/DUP claims and the
demotion on a failed write are the same at every partition and worker
count.  A 64-bit collision can mask a unique column as DUP with
probability about n²/2⁶⁵, the contract the HLL plane already carries.

Checkpoints pickle the tracker with its run paths: a restore on the same
host adopts the runs, one whose runs are missing or torn demotes those
columns (``__setstate__``).  ``persistent`` keeps the runs a saved
checkpoint references through a crash.

Each run written counts its bytes and seconds
(``tpuprof_unique_spill_bytes_total``, ``tpuprof_unique_spill_seconds``)
and emits a ``unique_spill`` event; the ``tpuprof_unique_partitions`` and
``tpuprof_unique_spill_pending`` gauges show the partition count and the
writes queued on the io tier.

Across processes (``runtime/distributed.py``, ``runtime/fleet.py``) the
reference's laws apply: ``merge`` adopts a peer's runs (present here only
when the spill dir is shared storage) and folds its live chunks,
``disown_runs``/``claim_runs`` move the run files' ownership to the merged
copy, and ``seed_resolution`` lets every process adopt rank 0's verdicts
instead of re-reading the shared runs.
"""

from __future__ import annotations

import glob
import logging
import os
import struct
import time
import uuid
import zlib
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from tpuprof_torch.ingest.prep import submit_io
from tpuprof_torch.obs import events as _events
from tpuprof_torch.obs import metrics as _metrics

logger = logging.getLogger("tpuprof_torch")

UNIQUE = "unique"       # no duplicate among all rows seen so far (exact)
DUP = "dup"             # at least one duplicate seen (exact)
OVERFLOW = "overflow"   # gave up within budget — distinct is approximate

# resolve() merges spilled runs in hash-range slices of at most this many
# rows (128 MB of uint64): RAM stays bounded at any total n
RESOLVE_SLICE_ROWS = 1 << 24

# The partitioned spill-run format: an 8-byte magic, the writer's partition
# count P and a CRC32 of the partition index (uint32 each), then P uint64
# per-partition row counts, then each partition's sorted dup-free uint64
# values in ascending partition order.  The partition is the hash's top
# bits, so the payload is also one globally sorted array: a reader with
# another partition count (or a headerless run, recognized by its exact
# rows * 8 size) slices it by searchsorted instead of the index.  Any
# truncation or bit flip fails the size/CRC checks as CorruptRunError.
RUN_MAGIC = b"TPUQRUN2"
_RUN_HEAD = len(RUN_MAGIC) + 8          # magic + <II (P, crc32(index))

_SPILL_BYTES = _metrics.counter(
    "tpuprof_unique_spill_bytes_total",
    "bytes of sorted hash runs written by the exact-unique tracker")
_SPILL_SECONDS = _metrics.histogram(
    "tpuprof_unique_spill_seconds",
    "wall time per spill-run write (header + tofile), wherever it ran")
_PARTITIONS_G = _metrics.gauge(
    "tpuprof_unique_partitions",
    "hash partitions the exact-unique tracker scatters into")
_SPILL_PENDING_G = _metrics.gauge(
    "tpuprof_unique_spill_pending",
    "spill writes queued on the io tier, not yet durable")

# cleanup() removes OTHER tokens' spill files only past this age: a crashed
# chain's orphans are swept eventually, a live concurrent writer's runs
# (which cleanup cannot tell apart by name) never while young
ORPHAN_SWEEP_AGE_S = 24 * 3600
# referenced runs' mtimes are refreshed at most this often (touch_runs)
TOUCH_INTERVAL_S = ORPHAN_SWEEP_AGE_S // 4


class CorruptRunError(ValueError):
    """A spill-run file failed validation: a truncated header or payload, a
    partition-index CRC mismatch, or a row count that disagrees with the
    tracker's record.  Never escapes the tracker: every read path treats it
    as a vanished run, and the column demotes to ``OVERFLOW`` (a DUP in
    evidence survives)."""


def _remove(path: str) -> None:
    try:
        os.remove(path)
    except OSError:
        pass


class UniqueTracker:
    """Per column: has any value hash occurred twice — and, in
    ``count_exact`` mode, the exact distinct count at any n.

    Counting mode (``config.exact_distinct``; needs a spill dir) keeps
    folding past duplicates, lazily: batches append raw (unsorted,
    duplicates included) to the live buffer; a compaction dedups it in
    memory, a spill writes the deduped buffer as a sorted run; and
    ``distinct_counts()`` merges runs and buffers by hash range to count
    the union.  The UNIQUE/DUP claim is settled at resolve by comparing
    that count with the rows fed (``_fed``)."""

    def __init__(self, names: Iterable[str], budget_rows: int,
                 total_budget_rows: int,
                 spill_dir: Optional[str] = None,
                 count_exact: bool = False,
                 own_spill_dir: bool = False,
                 partitions: int = 1,
                 spill_workers: int = 0):
        self.budget = int(budget_rows)
        self.total_budget = int(total_budget_rows)
        self.spill_dir = spill_dir
        p = int(partitions)
        if p < 1 or (p & (p - 1)):
            raise ValueError(
                f"partitions must be a power of two >= 1, got {partitions}")
        # each sort/dedup/spill/resolve runs per partition (the hash's top
        # log2(P) bits): a value's partition is a function of the value, so
        # the results are the same at every count
        self._partitions = p
        _PARTITIONS_G.set(p)
        # spill writes in flight on the io tier; 0 writes on the caller's
        # thread.  Queued runs publish into _runs at submit time (the same
        # order at any width); every read or persist path drains first
        self._spill_workers = max(int(spill_workers), 0)
        self._spill_pending: List[Tuple] = []   # (future, name, path,
        self._draining = False                  #  rows, parts)
        # True when parity derived the directory: cleanup may remove it,
        # not just the run files; a user's directory is never removed
        self.own_spill_dir = bool(own_spill_dir)
        names = list(names)
        self.status: Dict[str, str] = {}
        self._chunks: Dict[str, List[np.ndarray]] = {}
        self._rows: Dict[str, int] = {}
        self._kind: Dict[str, str] = {}   # hash implementation per column
        self._live = 0          # rows held across all tracked columns
        # disk runs per column: [(path, rows)], each a sorted dup-free
        # uint64 array (one spilled epoch).  The filename token is unique
        # per tracker, so trackers sharing a directory never collide
        self._runs: Dict[str, List[Tuple[str, int]]] = {}
        self._spill_token = uuid.uuid4().hex[:12]
        self._spill_seq = 0
        # run files THIS instance wrote: __del__ removes only these, so the
        # GC of an unpickled copy never deletes runs a checkpoint references
        self._owned: List[str] = []
        # runs dropped while persistent: the last saved checkpoint still
        # references them, so deletion waits for the next save
        # (reap_retired) or cleanup()
        self._retired: List[str] = []
        # True while a checkpoint references the runs: a crash must leave
        # them on disk, so only an explicit cleanup() deletes them
        self.persistent = False
        # name -> (state key, status, count or None)
        self._resolve_memo: Dict[str, Tuple] = {}
        self._last_touch = 0.0          # see touch_runs

        disabled = self.budget <= 0 or self.total_budget <= 0
        # counting needs storage past the budget, so a spill dir
        counting = bool(count_exact) and spill_dir is not None \
            and not disabled
        self._counting: Dict[str, bool] = {}
        # raw valid rows fed per counting column (duplicates included):
        # the lazy tier's UNIQUE claim is count == fed
        self._fed: Dict[str, int] = {}
        # per column, the raw-row size of the next in-memory compaction
        # (_compact_or_spill); absent: the per-column budget
        self._next_compact: Dict[str, int] = {}
        # counting columns whose live buffer is one canonical compacted
        # form (sorted dup-free partition parts): resolve skips the dedup
        self._clean: set = set()
        for n in names:
            self.status[n] = OVERFLOW if disabled else UNIQUE
            self._chunks[n] = []
            self._rows[n] = 0
            self._kind[n] = ""
            self._runs[n] = []
            self._counting[n] = counting
            self._fed[n] = 0

    def active(self, name: str) -> bool:
        """True while the column's hashes must keep flowing in: the exact
        no-duplicate claim is open, or counting goes on."""
        return self.status.get(name) == UNIQUE \
            or self._counting.get(name, False)

    def deactivate(self, name: str, status: str = OVERFLOW) -> None:
        """Give up exact tracking for a column (coverage is broken: a batch
        came without hashes); counting stops too."""
        self._demote(name, status)

    def _demote(self, name: str, status: str) -> None:
        """Stop tracking a column and free its storage.  Counting stops
        here, and a DUP already in evidence survives an abort: a counting
        column demoted to OVERFLOW first walks what is buffered and spilled,
        and a duplicate found there is final."""
        self._drain_spills()    # settle queued runs before walking them
        if status == OVERFLOW and self._counting.get(name, False) \
                and self.status.get(name) == UNIQUE \
                and (self._chunks.get(name) or self._runs.get(name)):
            try:
                _st, cnt = self._resolve_spilled(name, count=True)
                if cnt is not None and cnt < self._fed.get(name, cnt):
                    status = DUP
            except Exception:   # noqa: BLE001 — best effort: OVERFLOW holds
                pass
        self._counting[name] = False
        if status == OVERFLOW and self.status.get(name) == DUP:
            status = DUP
        self._live -= self._rows[name]
        self._rows[name] = 0
        self._chunks[name] = []
        self.status[name] = status
        self._drop_runs(name)

    def _drop_runs(self, name: str) -> None:
        paths = [p for p, _rows in self._runs.get(name, ())]
        self._runs[name] = []
        if self.persistent:
            # the last saved checkpoint may still reference these files: a
            # crash before the next save must find them on disk
            self._retired.extend(paths)
            return
        for path in paths:
            _remove(path)

    def reap_retired(self) -> None:
        """Delete the runs dropped since the previous checkpoint save.  Call
        only once a new checkpoint, which no longer references them, is
        durably on disk."""
        for path in self._retired:
            _remove(path)
        self._retired = []

    def touch_runs(self, force: bool = False) -> None:
        """Refresh the mtime of every run this tracker still references
        (retired ones too: the last checkpoint references them until the
        next save), so no other profile's age-gated sweep takes them.
        ``update``, ``resolve`` and ``distinct_counts`` call it, at most
        once every ``TOUCH_INTERVAL_S``; a restore forces a pass.  A
        tracker that gets no call for more than ``ORPHAN_SWEEP_AGE_S -
        TOUCH_INTERVAL_S`` cannot defend its files, and a column whose run
        is swept degrades to OVERFLOW at its next read."""
        now = time.time()
        if not force and now - self._last_touch < TOUCH_INTERVAL_S:
            return
        self._last_touch = now
        paths = list(self._retired)
        for runs in self._runs.values():
            paths.extend(p for p, _rows in runs)
        for path in paths:
            try:
                os.utime(path, None)
            except OSError:
                pass

    def _compact_or_spill(self, name: str) -> bool:
        """Budget relief for the lazy tier: dedup the raw buffer in memory
        first, and spill only when the column's distinct rows exceed the
        per-column budget (or the global budget is exceeded), so low- and
        mid-cardinality columns write nothing.  A kept buffer compacts again
        only after growing ``budget // 2`` raw rows past its distinct size
        (``_next_compact``)."""
        u = self._compact_buffer(name)
        if self._rows[name] <= self.budget \
                and self._live <= self.total_budget:
            return True
        self._next_compact[name] = self.budget
        return bool(self.spill_dir and self._spill(name, merged=u))

    def _pshift(self) -> np.uint64:
        """The right shift that maps a hash to its partition (top bits)."""
        return np.uint64(64 - (self._partitions.bit_length() - 1))

    def _partition_unique(self, h: np.ndarray) -> List[np.ndarray]:
        """Sort ``h`` in place, drop duplicates and split it by partition:
        the canonical compacted form, sorted dup-free arrays in ascending
        partition order whose concatenation is globally sorted.  Sorting
        IS the radix scatter (the partition is the top bits), so the parts
        are views of one sorted buffer."""
        if h.size == 0:
            return [h]
        # h is the caller's freshly concatenated private buffer
        h.sort()
        keep = np.empty(h.size, dtype=bool)
        keep[0] = True
        np.not_equal(h[1:], h[:-1], out=keep[1:])
        u = h if bool(keep.all()) else h[keep]
        return self._split_sorted(u)

    def _split_sorted(self, u: np.ndarray) -> List[np.ndarray]:
        """Partition views of a globally sorted dup-free array."""
        P = self._partitions
        if P == 1 or u.size == 0:
            return [u]
        step = (1 << 64) // P
        cuts = np.searchsorted(
            u, np.arange(1, P, dtype=np.uint64) * np.uint64(step))
        return [part for part in np.split(u, cuts) if part.size]

    def _compact_buffer(self, name: str) -> Optional[List[np.ndarray]]:
        """Dedup the live buffer into the canonical partitioned form
        (``_partition_unique``), keeping the _rows/_live/_clean/
        _next_compact bookkeeping in one place."""
        chunks = self._chunks.get(name) or []
        if not chunks:
            return None
        if name in self._clean:
            return chunks
        parts = self._partition_unique(np.concatenate(chunks))
        size = sum(int(p.size) for p in parts)
        self._live -= self._rows[name] - size
        self._rows[name] = size
        self._chunks[name] = parts
        self._next_compact[name] = size + max(self.budget // 2, 1)
        self._clean.add(name)
        return parts

    def _spill(self, name: str,
               merged: Optional[Sequence[np.ndarray]] = None) -> bool:
        """Write the column's consolidated chunks as a disk run and free the
        memory; tracking goes on in a fresh epoch.  ``merged`` is the
        canonical parts when the caller has them.  With ``spill_workers >
        0`` the write is queued on the io tier and the scan folds on; the
        run publishes into ``_runs`` at submit time and every read or
        persist path drains the queue first.  A failed queued write settles
        as a synchronous failure does (the unwritten values return to the
        buffer, then the column demotes)."""
        if merged is None:
            merged = self._partition_unique(
                np.concatenate(self._chunks[name]))
        elif isinstance(merged, np.ndarray):
            merged = self._split_sorted(merged)
        rows = sum(int(p.size) for p in merged)
        path = os.path.join(
            self.spill_dir,
            f"tpuprof-uniq-{self._spill_token}-{self._spill_seq}.u64")
        self._spill_seq += 1
        if self._spill_workers > 0:
            # in-order completion: settle the oldest write once the window
            # is full, so RAM holds at most spill_workers unwritten buffers
            while len(self._spill_pending) >= self._spill_workers:
                self._settle_spill(self._spill_pending.pop(0))
                _SPILL_PENDING_G.set(len(self._spill_pending))
            if not self.active(name):
                # a settled failure just demoted THIS column
                return True
            parts = list(merged)
            fut = submit_io(lambda: self._write_run(path, parts, name),
                            self._spill_workers)
            self._spill_pending.append((fut, name, path, rows, parts))
            _SPILL_PENDING_G.set(len(self._spill_pending))
        else:
            try:
                self._write_run(path, merged, name)
            except OSError as exc:
                self._spill_write_failed(name, path, exc)
                return False
        self._runs[name].append((path, rows))
        self._owned.append(path)
        self._live -= self._rows[name]
        self._rows[name] = 0
        self._chunks[name] = []
        self._clean.discard(name)
        return True

    def _write_run(self, path: str, parts: Sequence[np.ndarray],
                   name: str) -> None:
        """Write one partitioned run of column ``name``: the header (magic,
        P, index CRC), the per-partition row counts, then each partition's
        sorted values; count its bytes and seconds and emit its
        ``unique_spill`` event.  An ``OSError`` propagates to the caller or
        settler, which demotes."""
        t0 = time.perf_counter()
        shift = self._pshift()
        counts = np.zeros(self._partitions, dtype="<u8")
        for part in parts:
            if part.size:
                counts[int(part[0] >> shift)
                       if self._partitions > 1 else 0] = part.size
        index = counts.tobytes()
        header = RUN_MAGIC + struct.pack(
            "<II", self._partitions, zlib.crc32(index)) + index
        # two attempts: a concurrent profile sharing the directory (the
        # fixed parity dir) may remove it between makedirs and the write
        for attempt in (0, 1):
            os.makedirs(self.spill_dir, exist_ok=True)
            try:
                with open(path, "wb") as fh:
                    fh.write(header)
                    for part in parts:
                        np.ascontiguousarray(part).tofile(fh)
                break
            except OSError:
                _remove(path)
                if attempt:
                    raise
        rows = int(counts.sum())
        nbytes = len(header) + rows * 8
        seconds = time.perf_counter() - t0
        _SPILL_BYTES.inc(nbytes)
        _SPILL_SECONDS.observe(seconds)
        _events.emit("unique_spill", column=name, rows=rows,
                     bytes=nbytes, seconds=round(seconds, 6),
                     queued=self._spill_workers > 0)

    def _spill_write_failed(self, name: str, path: str,
                            exc: BaseException) -> None:
        """The failure report of a synchronous or queued spill write: the
        user asked for exactness, so a full or unwritable disk warns; the
        partial file goes."""
        logger.warning(
            "unique spill to %s failed (%s): column %r falls back to the "
            "HLL distinct estimate", path, exc, name)
        _remove(path)

    def _settle_spill(self, entry: Tuple) -> None:
        """Wait for one queued spill write.  A failure puts the unwritten
        values back into the live buffer and demotes through the path a
        synchronous failure takes, so the outcome is the same at any
        worker count."""
        fut, name, path, rows, parts = entry
        try:
            fut.result()
            return
        except OSError as exc:
            self._spill_write_failed(name, path, exc)
        self._runs[name] = [r for r in self._runs[name] if r[0] != path]
        if path in self._owned:
            self._owned.remove(path)
        self._retired = [p for p in self._retired if p != path]
        if self.active(name):
            # what the synchronous path would hold when it demotes
            self._chunks[name].extend(np.asarray(p) for p in parts)
            self._clean.discard(name)
            self._rows[name] += rows
            self._live += rows
            self._overflow_warn(name)
            self._demote(name, OVERFLOW)

    def _drain_spills(self) -> None:
        """Block until every queued spill write settled, oldest first.  A
        settle's demotion re-enters here through _resolve_spilled and must
        not reorder the queue."""
        if self._draining or not self._spill_pending:
            return
        self._draining = True
        try:
            while self._spill_pending:
                self._settle_spill(self._spill_pending.pop(0))
        finally:
            self._draining = False
            _SPILL_PENDING_G.set(0)

    def flush_spills(self) -> None:
        """Block until every queued run is on disk (failed writes demote
        their columns).  Checkpoint writers call it, so a save never
        references an unwritten run; pickling drains too."""
        self._drain_spills()

    def update(self, name: str, hashes: np.ndarray,
               hash_kind: str = "") -> None:
        """Fold one batch's valid-row hashes (duplicates included) in.  A
        column whose hash implementation ("native" | "pandas") changes
        mid-stream can no longer be compared exactly and demotes to
        OVERFLOW."""
        self.touch_runs()       # keeps the runs safe from sweeps
        counting = self._counting.get(name, False)
        if self.status.get(name) != UNIQUE and not counting:
            return
        h = np.asarray(hashes, dtype=np.uint64)
        if not h.size:
            return
        if hash_kind:
            if self._kind[name] and self._kind[name] != hash_kind:
                self._demote(name, OVERFLOW)
                return
            self._kind[name] = hash_kind
        if counting:
            # the lazy tier: append raw, defer every sort and dedup to the
            # compaction, the spill and the resolve walk
            if h.base is not None:
                h = h.copy()    # own the memory: a view pins its parent
            self._fed[name] += h.size
            self._chunks[name].append(h)
            self._clean.discard(name)
            self._rows[name] += h.size      # raw rows buffered
            self._live += h.size
            if self._rows[name] > self._next_compact.get(name,
                                                         self.budget) \
                    or self._live > self.total_budget:
                if not self._compact_or_spill(name):
                    self._overflow_warn(name)
                    self._demote(name, OVERFLOW)
            return
        sh = np.sort(h)
        # in-batch dedup: chunks hold distinct values, so memory follows
        # the cardinality
        dup = False
        if sh.size > 1:
            keep = np.empty(sh.size, dtype=bool)
            keep[0] = True
            np.not_equal(sh[1:], sh[:-1], out=keep[1:])
            if not keep.all():
                dup = True
                sh = sh[keep]
        # the probe keeps the chunks mutually dup-free, so the live rows are
        # the epoch's distinct count
        for c in self._chunks[name]:
            pos = np.searchsorted(c, sh)
            inb = pos < c.size
            hit = np.zeros(sh.size, dtype=bool)
            hit[inb] = c[pos[inb]] == sh[inb]
            if hit.any():
                dup = True
                sh = sh[~hit]
        if dup:
            self._demote(name, DUP)
            return
        if not sh.size:
            return
        self._chunks[name].append(sh)
        self._clean.discard(name)
        self._rows[name] += sh.size
        self._live += sh.size
        if self._rows[name] > self.budget or self._live > self.total_budget:
            if not (self.spill_dir and self._spill(name)):
                self._overflow_warn(name)
                self._demote(name, OVERFLOW)
            return
        if len(self._chunks[name]) > 8:
            # keep the probe loop short: fold the chunks into one array
            self._chunks[name] = [np.sort(np.concatenate(
                self._chunks[name]))]

    def _overflow_warn(self, name: str) -> None:
        if not self.spill_dir:
            logger.warning(
                "column %r exceeded the exact-UNIQUE tracking budget "
                "(unique_track_rows=%d): its distinct count falls back to "
                "the HLL estimate.  Set unique_spill_dir (CLI: "
                "--unique-spill-dir) to keep the classification exact at "
                "any size (disk cost: 8 bytes/row)", name, self.budget)

    def resolve(self) -> Dict[str, str]:
        """Final per-column statuses, spilled columns decided exactly: each
        run and the live chunk set are dup-free, so only cross-epoch
        duplicates remain, found by merging runs and chunks.  Repeatable
        (a stream's snapshots) and memoized on each column's state."""
        self._drain_spills()
        self.touch_runs()
        out = {}
        for name, st in self.status.items():
            if self._counting.get(name, False) and st != OVERFLOW:
                # the lazy tier: no duplicate was folded iff the union
                # count equals the rows fed (one memoized walk serves the
                # claim and distinct_counts)
                cnt = self._resolve_spilled(name, count=True)[1]
                if cnt is None:
                    # a run vanished: the count is gone, a DUP in evidence
                    # is final
                    out[name] = DUP if st == DUP else OVERFLOW
                elif st == DUP or cnt < self._fed.get(name, cnt):
                    out[name] = DUP
                else:
                    out[name] = UNIQUE
            elif st == UNIQUE and self._runs.get(name):
                out[name] = self._resolve_spilled(name, count=False)[0]
            else:
                out[name] = st
        return out

    def distinct_counts(self) -> Dict[str, int]:
        """Exact distinct counts of the columns still counting, at any n:
        the union of the dup-free runs and the deduped live buffers, by
        the hash-range merge.  Repeatable and memoized with the claim."""
        self._drain_spills()
        self.touch_runs()
        out: Dict[str, int] = {}
        for name, counting in self._counting.items():
            if not counting or self.status.get(name) == OVERFLOW:
                continue
            _st, count = self._resolve_spilled(name, count=True)
            if count is not None:
                out[name] = count
        return out

    def _canonical_key(self, name: str) -> Tuple:
        """Compact a counting column's buffer to its canonical form and
        return the memo key of the column's state.  ``_fed`` is in the key
        because a compaction can shrink ``_rows`` back onto a value an
        earlier snapshot memoized with fewer values seen; ``_fed`` only
        grows, so new data always invalidates."""
        if self._counting.get(name, False):
            self._compact_buffer(name)
        return (tuple(self._runs[name]), self._rows[name],
                self._fed.get(name, 0))

    def _run_layout(self, path: str, rows: int
                    ) -> Tuple[int, Optional[np.ndarray]]:
        """Validate a run file and return ``(payload byte offset,
        per-partition prefix offsets or None)``.  The offsets come from the
        header when the writer's partition count is this tracker's; a
        foreign count or a headerless run returns None and the reader
        slices the sorted payload by searchsorted.  A torn or mismatched
        file raises :class:`CorruptRunError`, a vanished one ``OSError``;
        every caller handles both alike (the column demotes)."""
        size = os.path.getsize(path)
        with open(path, "rb") as fh:
            head = fh.read(_RUN_HEAD)
            if head[:len(RUN_MAGIC)] != RUN_MAGIC:
                # a headerless run is checked by its exact size only; the
                # magic test comes first, so a partitioned run truncated to
                # rows * 8 bytes never passes as one
                if size == rows * 8:
                    return 0, None
                raise CorruptRunError(
                    f"spill run {path!r}: unrecognized layout "
                    f"({size} bytes for {rows} recorded rows)")
            if len(head) < _RUN_HEAD:
                raise CorruptRunError(
                    f"spill run {path!r}: truncated header")
            run_p, crc = struct.unpack("<II", head[len(RUN_MAGIC):])
            if not 1 <= run_p <= 1 << 16:
                raise CorruptRunError(
                    f"spill run {path!r}: implausible partition "
                    f"count {run_p}")
            index = fh.read(8 * run_p)
        if len(index) != 8 * run_p or zlib.crc32(index) != crc:
            raise CorruptRunError(
                f"spill run {path!r}: partition index corrupt "
                "(truncated or CRC mismatch)")
        counts = np.frombuffer(index, dtype="<u8")
        offset = _RUN_HEAD + 8 * run_p
        if int(counts.sum()) != rows or size != offset + rows * 8:
            raise CorruptRunError(
                f"spill run {path!r}: payload truncated or row count "
                f"mismatch ({size} bytes, {rows} recorded rows)")
        if run_p != self._partitions:
            return offset, None             # readable, slice by search
        prefix = np.zeros(run_p + 1, dtype=np.int64)
        prefix[1:] = np.cumsum(counts)
        return offset, prefix

    @staticmethod
    def _union_ranged(parts: List[np.ndarray], lo: int, hi: int,
                      n_sub: int, count: bool) -> Tuple[bool, int]:
        """(duplicate found, distinct count) across sorted dup-free arrays
        restricted to hashes in ``[lo, hi]``, in ``n_sub`` bounded
        sub-ranges.  When a duplicate settles the claim and no count is
        wanted the rest is skipped (the count is then partial and the
        caller discards it)."""
        dup = False
        distinct = 0
        step = (hi - lo + 1) // n_sub
        for k in range(n_sub):
            slo = np.uint64(lo + k * step)
            shi = np.uint64(lo + (k + 1) * step - 1) \
                if k + 1 < n_sub else np.uint64(hi)
            sub = []
            for a in parts:
                i = int(np.searchsorted(a, slo, side="left"))
                j = int(np.searchsorted(a, shi, side="right"))
                if j > i:
                    sub.append(np.asarray(a[i:j]))
            if len(sub) < 2:
                distinct += sub[0].size if sub else 0
                continue            # one source cannot cross-duplicate
            s = np.sort(np.concatenate(sub))
            news = int((s[1:] != s[:-1]).sum()) + 1 if s.size > 1 \
                else int(s.size)
            if news != s.size:
                dup = True
                if not count:
                    return dup, distinct    # claim settled
            distinct += news
        return dup, distinct

    def _resolve_spilled(self, name: str, count: bool = False
                         ) -> Tuple[str, Optional[int]]:
        self._drain_spills()    # a queued run is not readable yet
        if self._counting.get(name, False) and not self._runs[name] \
                and name not in self._clean and self._chunks[name]:
            # no runs to merge: the union is one in-place sort and an
            # adjacent-difference count over the raw buffer.  The buffer
            # stays raw; fed in the key invalidates on new data
            key = ((), self._rows[name], self._fed.get(name, 0))
            memo = self._resolve_memo.get(name)
            if memo is not None and memo[0] == key:
                return memo[1], memo[2]
            s = np.concatenate(self._chunks[name])
            s.sort()
            distinct = int((s[1:] != s[:-1]).sum()) + 1 if s.size > 1 \
                else int(s.size)
            status = UNIQUE if distinct == s.size else DUP
            self._resolve_memo[name] = (key, status, distinct)
            return status, distinct
        key = self._canonical_key(name)
        memo = self._resolve_memo.get(name)
        if memo is not None and memo[0] == key \
                and not (count and memo[2] is None
                         and memo[1] != OVERFLOW):
            return memo[1], memo[2]
        # every source is one sorted dup-free array: a memmap'd run payload
        # (with its per-partition offsets when its partition count is
        # ours) or a live canonical part
        sources: List[Tuple[np.ndarray, Optional[np.ndarray]]] = []
        for path, rows in self._runs[name]:
            try:
                offset, prefix = self._run_layout(path, rows)
                mm = np.memmap(path, dtype=np.uint64, mode="r",
                               offset=offset, shape=(rows,))
            except (OSError, ValueError):
                # a run vanished or rotted: the exact claim is gone.
                # Counting goes off first, so _demote walks nothing (a
                # partial union would settle a false DUP), and the
                # surviving runs are detached first, so a restored copy
                # that owns none of them deletes nothing
                self._counting[name] = False
                self._resolve_memo[name] = (key, OVERFLOW, None)
                self._runs[name] = []
                self._demote(name, OVERFLOW)
                return OVERFLOW, None
            sources.append((mm, prefix))
        if self._chunks[name]:
            if name in self._clean:
                for c in self._chunks[name]:
                    sources.append((c, None))
            else:
                # the probed path's chunks are sorted and mutually dup-free
                sources.append((np.unique(np.concatenate(
                    self._chunks[name])), None))
        # P independent unions: partitions never cross-merge, and a run's
        # slice comes straight off its header index.  A partition far past
        # RESOLVE_SLICE_ROWS walks bounded sub-ranges
        status = UNIQUE
        distinct = 0
        P = self._partitions
        step = (1 << 64) // P
        for p in range(P):
            lo = p * step
            hi = (p + 1) * step - 1 if p + 1 < P else (1 << 64) - 1
            parts = []
            total = 0
            for arr, prefix in sources:
                if prefix is not None:
                    i, j = int(prefix[p]), int(prefix[p + 1])
                else:
                    i = int(np.searchsorted(arr, np.uint64(lo),
                                            side="left"))
                    j = int(np.searchsorted(arr, np.uint64(hi),
                                            side="right"))
                if j > i:
                    parts.append(arr[i:j])
                    total += j - i
            if len(parts) < 2:
                distinct += int(parts[0].size) if parts else 0
                continue            # one source cannot cross-duplicate
            n_sub = max(1, -(-total // RESOLVE_SLICE_ROWS))
            dup, news = self._union_ranged(parts, lo, hi, n_sub, count)
            distinct += news
            if dup:
                status = DUP
                if not count:
                    break           # claim settled; no count wanted
        self._resolve_memo[name] = (
            key, status, distinct if count or status == UNIQUE else None)
        return status, self._resolve_memo[name][2]

    # -- the cross-process laws (the reference's) ---------------------------

    def disown_runs(self) -> None:
        """Give up the run files' ownership: this instance's GC no longer
        deletes them.  Called on the original tracker after a merge across
        processes, before the caller rebinds to the merged copy
        (:meth:`claim_runs`)."""
        self._owned = []

    def claim_runs(self) -> None:
        """Own every run file this tracker references (the merged copy of
        a gather, which unpickled with none), so an error between the merge
        and :meth:`cleanup` orphans nothing.  Several processes claiming the
        same shared paths is fine: deletion is idempotent."""
        self._owned = [p for runs in self._runs.values()
                       for p, _rows in runs]

    def _end_counting(self, name: str) -> None:
        """Take a column out of counting mode, settling its claim from all
        it counted (duplicates may survive only in ``_fed``) and leaving the
        buffer in the canonical form the probed paths expect."""
        if not self._counting.get(name, False):
            return
        dup = False
        if self.status.get(name) == UNIQUE:
            try:
                self._compact_buffer(name)
                _st, cnt = self._resolve_spilled(name, count=True)
                dup = cnt is not None and cnt < self._fed.get(name, cnt)
            except Exception:   # noqa: BLE001 — the claim cannot be affirmed
                self._counting[name] = False
                self._demote(name, OVERFLOW)
                return
        self._counting[name] = False
        if dup:
            self._demote(name, DUP)

    def seed_resolution(self, statuses: Dict[str, str],
                        counts: Optional[Dict[str, int]] = None) -> None:
        """Adopt another process's ``resolve()`` verdicts (and exact counts)
        for still-spilled columns, memoized on the current run and row state
        so a later change still invalidates them."""
        counts = counts or {}
        for name, st in statuses.items():
            if self._runs.get(name) and (
                    self.status.get(name) == UNIQUE
                    or self._counting.get(name)):
                self._resolve_memo[name] = (self._canonical_key(name),
                                            st, counts.get(name))

    def merge(self, other: "UniqueTracker") -> None:
        """Fold a peer's tracker in (the reference's law): runs are
        adopted, live chunks fold as batches, a DUP on either side is
        final, an OVERFLOW or a clash of hash implementations demotes."""
        self._drain_spills()
        other._drain_spills()
        for name, ost in other.status.items():
            if name not in self.status:
                continue
            okind = other._kind.get(name, "")
            mkind = self._kind.get(name, "")
            kind_clash = bool(okind and mkind and okind != mkind)
            counting = self._counting.get(name, False) \
                and other._counting.get(name, False)
            if not counting:
                # leaving counting mode: both sides settle their claims
                # and normalize their buffers first
                self._end_counting(name)
                other._end_counting(name)
                ost = other.status[name]
            if counting and not kind_clash \
                    and OVERFLOW not in (self.status[name], ost):
                # counting goes on: adopt the runs, fold the chunks, and
                # keep the claim law count == fed across the merge
                if other._runs.get(name):
                    self._runs[name].extend(other._runs[name])
                if okind and not mkind:
                    self._kind[name] = okind
                if DUP in (self.status[name], ost):
                    self.status[name] = DUP
                fed_before = self._fed.get(name, 0)
                for c in other._chunks[name]:
                    self.update(name, c, hash_kind=okind)
                self._fed[name] = fed_before + other._fed.get(name, 0)
                continue
            if DUP in (self.status[name], ost):
                self._demote(name, DUP)
            elif OVERFLOW in (self.status[name], ost) or kind_clash:
                self._demote(name, OVERFLOW)
            else:
                # the peer's runs were validated present here when it
                # unpickled (shared storage); cross-process duplicates
                # surface in resolve()'s hash-range merge
                if other._runs.get(name):
                    self._runs[name].extend(other._runs[name])
                if okind and not mkind:
                    self._kind[name] = okind
                for c in other._chunks[name]:
                    self.update(name, c, hash_kind=okind)

    def cleanup(self) -> None:
        """Delete every spill run (idempotent; call once the profile is
        assembled, since checkpoints reference the files until then): the
        runs this tracker references, every file under its own token and,
        past ``ORPHAN_SWEEP_AGE_S``, other tokens' abandoned files.  Young
        files under other tokens may belong to a live concurrent writer and
        stay.  A directory parity derived is removed once empty."""
        self._drain_spills()        # queued writes land, then go
        self.persistent = False     # nothing references the runs now
        for name in list(self._runs):
            self._drop_runs(name)
        self.reap_retired()
        if not self.spill_dir:
            return
        root = glob.escape(self.spill_dir)
        for path in glob.glob(os.path.join(
                root, f"tpuprof-uniq-{self._spill_token}-*.u64")):
            _remove(path)
        stale_before = time.time() - ORPHAN_SWEEP_AGE_S
        for path in glob.glob(os.path.join(root, "tpuprof-uniq-*.u64")):
            try:
                if os.path.getmtime(path) < stale_before:
                    os.remove(path)
            except OSError:
                pass
        if self.own_spill_dir:
            # rmdir refuses a non-empty directory: a concurrent writer's
            # young runs keep it
            try:
                os.rmdir(self.spill_dir)
            except OSError:
                pass

    def __del__(self):
        # files THIS instance wrote only (unpickled copies own nothing), and
        # none while a checkpoint references them
        try:
            if getattr(self, "persistent", False):
                return
            for path in getattr(self, "_owned", ()):
                _remove(path)
        except Exception:   # noqa: BLE001 — never raise from a finalizer
            pass

    def __getstate__(self) -> Dict[str, object]:
        # a checkpoint references durable runs only: every queued write
        # lands first (a failed one demotes its column here)
        self._drain_spills()
        state = dict(self.__dict__)
        state["_resolve_memo"] = {}
        state["_owned"] = []
        # retired paths belong to the writer's save/reap cycle
        state["_retired"] = []
        state["_spill_pending"] = []
        state["_draining"] = False
        return state

    def __setstate__(self, state) -> None:
        self.__dict__.update(state)
        if "_runs" not in state:
            # written before the spill tier: in-memory claims, no counting
            self.spill_dir = None
            self._partitions = 1
            self._spill_workers = 0
            self.own_spill_dir = False
            self.persistent = False
            self._runs = {n: [] for n in self.status}
            self._counting = {n: False for n in self.status}
            self._fed = {n: 0 for n in self.status}
            self._next_compact = {}
        self._resolve_memo = {}
        self._owned = []
        self._retired = []
        # a fresh token for runs written after the restore: two processes
        # resuming one checkpoint would otherwise overwrite each other's
        # files.  The inherited runs stay reachable through _runs
        self._spill_token = uuid.uuid4().hex[:12]
        self._spill_seq = 0
        self._spill_pending = []
        self._draining = False
        # restored buffers are conservatively raw (deduped once again)
        self._clean = set()
        self._last_touch = 0.0
        lost = []
        for name, runs in list(self._runs.items()):
            for path, rows in runs:
                try:
                    self._run_layout(path, rows)
                except (OSError, CorruptRunError):
                    # the checkpoint references a run this host cannot
                    # read: detach the list (the survivors are not ours to
                    # delete), stop counting first (a walk of the buffer
                    # alone would settle a false DUP), then demote
                    self._runs[name] = []
                    self._counting[name] = False
                    self._demote(name, OVERFLOW)
                    lost.append(name)
                    break
        if lost:
            logger.warning(
                "%d spilled column(s) (%s) fell back to the approximate "
                "distinct estimate: their run files are not readable here",
                len(lost), ", ".join(sorted(lost)[:5]))
        # restamp the inherited runs before any sweep can race them
        self.touch_runs(force=True)
