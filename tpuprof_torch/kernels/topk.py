"""Top-k frequent values: host-side Misra-Gries summaries.

Copy of the batch-fold part of ``tpuprof/kernels/topk.py``.  With capacity
k, every kept count underestimates by at most n/k and any value with
frequency above n/k is kept; when a column's distinct count never exceeds
the capacity, counts are exact.  The store keys on the 64-bit value hashes
that ingest computes anyway; values ride in a parallel object array and are
touched only when a new key is appended.  Pass B recounts the surviving
candidates exactly.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Tuple

import numpy as np
import pandas as pd


def _fallback_hashes(values: np.ndarray) -> np.ndarray:
    """Hash keys for callers with no ingest hashes (one instance must be
    fed from one hash source)."""
    return pd.util.hash_array(
        np.asarray(values, dtype=object)).astype(np.uint64)


class MisraGries:
    """One column's frequent-values summary (value -> count)."""

    __slots__ = ("capacity", "_index", "_counts", "_values", "offset",
                 "overflowed")

    def __init__(self, capacity: int):
        self.capacity = int(capacity)
        self._index = pd.Index([], dtype=np.uint64)   # value hashes
        self._counts = np.zeros(0, dtype=np.int64)
        self._values = np.zeros(0, dtype=object)      # aligned with _index
        self.offset = 0          # total decrement applied (error bound)
        self.overflowed = False  # True once any eviction happened

    def update_batch(self, values: np.ndarray, counts: np.ndarray,
                     hashes: Optional[np.ndarray] = None) -> None:
        """Fold pre-aggregated (unique values, counts) from one batch in;
        ``hashes`` is the aligned uint64 key array from ingest."""
        counts = np.asarray(counts, dtype=np.int64)
        if hashes is None:
            hashes = _fallback_hashes(values)
        hashes = np.asarray(hashes, dtype=np.uint64)
        if hashes.size > 1:
            # a duplicated key would lose counts in the fancy add below:
            # duplicates take the aggregate path
            sh = np.sort(hashes)
            if (sh[1:] == sh[:-1]).any():
                uh, first, inv = np.unique(hashes, return_index=True,
                                           return_inverse=True)
                agg = np.zeros(uh.size, dtype=np.int64)
                np.add.at(agg, inv, counts)
                values = np.asarray(values, dtype=object)[first]
                hashes, counts = uh, agg
        self._update_core(
            hashes, counts,
            lambda src: np.asarray(values, dtype=object)[src])

    def update_hashed(self, hashes: np.ndarray, counts: np.ndarray,
                      resolver) -> None:
        """Fold pre-aggregated unique (hashes, counts) whose values
        materialize late: ``resolver(src)`` returns the values at positions
        ``src`` of ``hashes`` and is called only for new entries that
        survive the compaction (ingest's row-hash path never builds a
        dictionary of the batch)."""
        self._update_core(np.asarray(hashes, dtype=np.uint64),
                          np.asarray(counts, dtype=np.int64), resolver)

    def _update_core(self, hashes: np.ndarray, counts: np.ndarray,
                     resolver) -> None:
        if len(self._index):
            pos = self._index.get_indexer(hashes)
            hit = np.flatnonzero(pos >= 0)
            self._counts[pos[hit]] += counts[hit]
            miss = np.flatnonzero(pos < 0)
        else:
            miss = np.arange(len(counts))
        if not miss.size:
            return
        # new keys are appended with value slots deferred: only the
        # survivors of the compaction below get their values materialized
        start = len(self._counts)
        self._index = self._index.append(
            pd.Index(hashes[miss], copy=False))
        self._counts = np.concatenate([self._counts, counts[miss]])
        self._values = np.concatenate(
            [self._values, np.empty(miss.size, dtype=object)])
        if len(self._index) > self.capacity:
            src = miss[self._compact(start)]
        else:
            src = miss
        if src.size:
            self._values[len(self._values) - src.size:] = resolver(src)

    def _compact(self, new_start: int = 0) -> np.ndarray:
        """Misra-Gries decrement: subtract the (capacity+1)-th largest
        count from everyone and drop the non-positive.  Returns the keep
        mask of the entries from ``new_start`` on."""
        self.overflowed = True
        arr = self._counts
        kth = np.partition(arr, -(self.capacity + 1))[-(self.capacity + 1)]
        self.offset += int(kth)
        keep = arr > kth
        self._index = self._index[keep]
        self._counts = arr[keep] - kth
        self._values = self._values[keep]
        return keep[new_start:]

    @property
    def exact(self) -> bool:
        """True when every stored count is the true frequency."""
        return not self.overflowed

    def top(self, k: int) -> List[Tuple[object, int]]:
        order = np.argsort(-self._counts, kind="stable")[:k]
        return [(self._values[int(i)], int(self._counts[int(i)]))
                for i in order]

    def distinct_count(self) -> Optional[int]:
        """Exact distinct count, or None if the summary overflowed."""
        return len(self._index) if self.exact else None

    def candidates(self) -> Iterable[object]:
        return list(self._values)
