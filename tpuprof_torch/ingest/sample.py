"""Host-side mergeable uniform row sample (bottom-k priority sampling).

Copy of ``tpuprof/ingest/sample.py``. Keeping the global top-K of i.i.d.
uniform row priorities over any partition of the stream is a uniform sample
without replacement, so the merge is exact in distribution and sample
quantiles have rank error O(1/sqrt(K)). The RNG stream (seed, process,
batch) matches the reference, so the same batches give the same sample.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np


class RowSampler:
    """Mergeable bottom-k priority row sample, host-resident."""

    def __init__(self, k: int, n_num: int, seed: int = 0,
                 process_index: int = 0):
        self.k = int(k)
        self.n_num = int(n_num)
        self.seed = int(seed)
        self.process_index = int(process_index)
        self.values = np.empty((0, n_num), dtype=np.float32)
        self.prio = np.empty((0,), dtype=np.float64)
        self.step = 0                        # batches folded (RNG position)

    # -- ingestion ---------------------------------------------------------

    def update(self, x: np.ndarray, nrows: int) -> None:
        """Fold one host batch.  ``x``: (>=nrows, n_num) float32 (NaN for
        missing); rows past ``nrows`` are padding and never sampled."""
        rng = np.random.default_rng(
            (self.seed, self.process_index, self.step))
        self.step += 1
        prio = rng.random(nrows)
        if self.prio.size >= self.k:
            # only candidates that beat the current kth priority can enter
            tau = self.prio.min()
            cand = prio > tau
            if not cand.any():
                return
            rows = np.ascontiguousarray(x[:nrows][cand])
            prio = prio[cand]
        else:
            rows = np.ascontiguousarray(x[:nrows])
        self.values = np.concatenate([self.values, rows], axis=0)
        self.prio = np.concatenate([self.prio, prio])
        if self.prio.size > self.k:
            self._compact()

    def _compact(self) -> None:
        idx = np.argpartition(self.prio, -self.k)[-self.k:]
        self.values = np.ascontiguousarray(self.values[idx])
        self.prio = self.prio[idx]

    # -- merge (the commutative-monoid law; tests/test_sample.py) ----------

    def merge(self, other: "RowSampler") -> "RowSampler":
        if other.n_num != self.n_num:
            raise ValueError("cannot merge samplers over different schemas")
        self.values = np.concatenate([self.values, other.values], axis=0)
        self.prio = np.concatenate([self.prio, other.prio])
        if self.prio.size > self.k:
            self._compact()
        return self

    # -- finalize ----------------------------------------------------------

    def columns(self) -> Tuple[np.ndarray, np.ndarray]:
        """Per-column view shaped like the device sketch produced:
        (values (n_num, k) float64, kept (n_num, k) bool) with kept
        marking finite sampled values."""
        out = np.full((self.n_num, self.k), np.nan, dtype=np.float64)
        size = min(self.values.shape[0], self.k)
        if size:
            out[:, :size] = self.values[:size].T
        return out, np.isfinite(out)

    def quantiles(self, probes: Sequence[float]) -> np.ndarray:
        """(n_probes, n_num) float64 linear-interpolated quantiles of each
        column's finite sample; NaN where a column kept nothing."""
        vals, kept = self.columns()
        out = np.full((len(probes), self.n_num), np.nan)
        for c in range(self.n_num):
            v = vals[c, kept[c]]
            if v.size:
                out[:, c] = np.quantile(v, list(probes))
        return out

    def cdf_grid(self, n_grid: int) -> np.ndarray:
        """(n_num, n_grid) float32 per-column sample quantiles at probes
        (j+0.5)/n_grid: the rank grid of the Spearman kernels K5/K6
        (counterpart of the reference's ``RowSampler.cdf_grid``).  Columns
        with no finite sample are all +inf (their ranks collapse to 0 and
        the correlation finalizes to NaN via the zero-variance guard)."""
        vals, kept = self.columns()
        probes = (np.arange(n_grid) + 0.5) / n_grid
        out = np.full((self.n_num, n_grid), np.inf, dtype=np.float32)
        for c in range(self.n_num):
            v = vals[c, kept[c]]
            if v.size:
                out[c] = np.quantile(v, probes).astype(np.float32)
        return out

    def spearman(self) -> np.ndarray:
        """(n_num, n_num) pairwise-complete Spearman rank correlation of
        the sampled rows (counterpart of the reference's
        ``RowSampler.spearman``): the estimate when no second scan runs,
        standard error ~1/sqrt(K); exact when the sample holds every row.
        Average ranks on ties, as pandas."""
        import pandas as pd
        if self.values.shape[0] < 2:
            return np.full((self.n_num, self.n_num), np.nan)
        df = pd.DataFrame(self.values)
        with np.errstate(invalid="ignore"):
            rho = df.corr(method="spearman").to_numpy()
        return rho

    def sorted_padded(self) -> Tuple[np.ndarray, np.ndarray]:
        """For the exact Spearman tier (tables wider than the rank
        kernels take): each column's ascending finite sample, padded with
        +inf to k, and the kept counts (counterpart of the reference's
        ``RowSampler.sorted_padded``)."""
        vals, kept = self.columns()
        padded = np.where(kept, vals, np.inf).astype(np.float32)
        return np.sort(padded, axis=1), kept.sum(axis=1).astype(np.int64)
