"""Host-side mergeable uniform row sample (bottom-k priority sampling).

Counterpart of ``tpuprof/ingest/sample.py``. Keeping the global top-K of
i.i.d. uniform row priorities over any partition of the stream is a uniform
sample without replacement, so the merge is exact in distribution and sample
quantiles have rank error O(1/sqrt(K)). The RNG stream (seed, process,
batch) matches the reference, so the same batches give the same sample,
byte for byte and in the same row order.

Unlike the reference, a fold decides the survivors from the priorities
alone and then copies only their rows out of the batch: the first batch of
a 65,536 x 2,000 F-ordered plane copies 4,096 rows, not the whole plane.
:func:`record_rows` counts the rows offered and copied (``rows_offered``,
``rows_copied``, and ``tpuprof_sample_rows_total{kind}`` with metrics on).
"""

from __future__ import annotations

import threading
from typing import Optional, Sequence, Tuple

import numpy as np

from tpuprof_torch.obs import metrics as _obs_metrics

_ROWS = _obs_metrics.counter(
    "tpuprof_sample_rows_total",
    "batch rows offered to the row sampler (kind=offered) and copied out "
    "of the batch into the sample (kind=copied)")
rows_offered = 0        # batch rows samplers in this process were offered
rows_copied = 0         # ... and copied out of their batches
_count_lock = threading.Lock()


def record_rows(offered: int, copied: int) -> None:
    """Count one fold's rows (once an ``update``)."""
    global rows_offered, rows_copied
    with _count_lock:
        rows_offered += offered
        rows_copied += copied
    for kind, n in (("offered", offered), ("copied", copied)):
        if n:
            _ROWS.inc(n, kind=kind)


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
        rows = None                          # every row is a candidate
        if self.prio.size >= self.k:
            # only candidates that beat the current kth priority can enter
            rows = np.flatnonzero(prio > self.prio.min())
            if not rows.size:
                record_rows(nrows, 0)
                return
            prio = prio[rows]
        record_rows(nrows, self._fold(x[:nrows], rows, prio))

    def _fold(self, x: np.ndarray, rows: Optional[np.ndarray],
              prio: np.ndarray) -> int:
        """Keep the top-k of the sample's priorities and ``prio``, the
        priorities of ``x``'s rows ``rows`` (all of them for None), in the
        order concatenating both and running ``argpartition`` gives.  Only
        the kept rows are copied out of ``x``; returns how many."""
        n_old = self.prio.size
        p = np.concatenate([self.prio, prio])
        keep = np.argpartition(p, -self.k)[-self.k:] if p.size > self.k \
            else np.arange(p.size)
        new = keep >= n_old
        src = keep[new] - n_old
        if rows is not None:
            src = rows[src]
        values = np.empty((keep.size, self.n_num),
                          np.result_type(self.values.dtype, x.dtype))
        values[~new] = self.values[keep[~new]]
        values[new] = x[src]
        self.values = values
        self.prio = p[keep]
        return src.size

    # -- merge (the commutative-monoid law; tests/test_sample.py) ----------

    def merge(self, other: "RowSampler") -> "RowSampler":
        if other.n_num != self.n_num:
            raise ValueError("cannot merge samplers over different schemas")
        self._fold(other.values, None, other.prio)
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
