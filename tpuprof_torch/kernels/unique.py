"""Exact per-column duplicate detection from the host hash stream.

The in-memory part of ``tpuprof/kernels/unique.py``'s ``UniqueTracker``.
The reference's ``distinct == count -> UNIQUE`` classification is exact, and
an HLL estimate essentially never equals ``count``; this tracker answers the
one question classification needs — was any value seen twice? — exactly.
Per column it keeps every seen 64-bit hash in sorted chunks; each batch is
sorted (exposing in-batch duplicates) and probed against the chunks.  The
first duplicate demotes the column to ``DUP`` and frees its storage.  A
column that outgrows the budgets demotes to ``OVERFLOW`` and falls back to
the HLL estimate (spilling to disk is a later slice of the port).
"""

from __future__ import annotations

import logging
from typing import Dict, Iterable, List

import numpy as np

UNIQUE = "unique"       # no duplicate among all rows seen so far (exact)
DUP = "dup"             # at least one duplicate seen (exact)
OVERFLOW = "overflow"   # gave up within budget — distinct is approximate


class UniqueTracker:
    """Per column: has any value hash occurred twice?"""

    def __init__(self, names: Iterable[str], budget_rows: int,
                 total_budget_rows: int):
        self.budget = int(budget_rows)
        self.total_budget = int(total_budget_rows)
        disabled = self.budget <= 0 or self.total_budget <= 0
        self.status: Dict[str, str] = {}
        self._chunks: Dict[str, List[np.ndarray]] = {}
        self._rows: Dict[str, int] = {}
        self._kind: Dict[str, str] = {}   # hash implementation per column
        self._live = 0          # rows held across all still-UNIQUE columns
        for n in names:
            self.status[n] = OVERFLOW if disabled else UNIQUE
            self._chunks[n] = []
            self._rows[n] = 0
            self._kind[n] = ""

    def active(self, name: str) -> bool:
        """True while the column's no-duplicate claim is still open."""
        return self.status.get(name) == UNIQUE

    def deactivate(self, name: str, status: str = OVERFLOW) -> None:
        """Give up exact tracking for a column (coverage is broken)."""
        self._demote(name, status)

    def _demote(self, name: str, status: str) -> None:
        if status == OVERFLOW and self.status.get(name) == DUP:
            status = DUP
        self._live -= self._rows[name]
        self._rows[name] = 0
        self._chunks[name] = []
        self.status[name] = status

    def update(self, name: str, hashes: np.ndarray,
               hash_kind: str = "") -> None:
        """Fold one batch's valid-row hashes (duplicates included) in.  A
        column whose hash implementation changes mid-stream can no longer
        be compared exactly and demotes to OVERFLOW."""
        if self.status.get(name) != UNIQUE:
            return
        h = np.asarray(hashes, dtype=np.uint64)
        if not h.size:
            return
        if hash_kind:
            if self._kind[name] and self._kind[name] != hash_kind:
                self._demote(name, OVERFLOW)
                return
            self._kind[name] = hash_kind
        sh = np.sort(h)
        dup = False
        if sh.size > 1:
            keep = np.empty(sh.size, dtype=bool)
            keep[0] = True
            np.not_equal(sh[1:], sh[:-1], out=keep[1:])
            if not keep.all():
                dup = True
                sh = sh[keep]
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
        self._rows[name] += sh.size
        self._live += sh.size
        if self._rows[name] > self.budget or self._live > self.total_budget:
            logging.getLogger("tpuprof_torch").warning(
                "column %r exceeded the exact-UNIQUE tracking budget "
                "(unique_track_rows=%d): its distinct count falls back to "
                "the HLL estimate", name, self.budget)
            self._demote(name, OVERFLOW)
            return
        if len(self._chunks[name]) > 8:
            # keep the probe loop short: fold the chunks into one array
            self._chunks[name] = [np.sort(np.concatenate(
                self._chunks[name]))]

    def resolve(self) -> Dict[str, str]:
        """Final per-column statuses."""
        return dict(self.status)

    def distinct_counts(self) -> Dict[str, int]:
        """Exact distinct counts: none in this tier (exact counting is the
        later exact-distinct slice)."""
        return {}
