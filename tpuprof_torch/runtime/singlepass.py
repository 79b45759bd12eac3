"""Single-pass profiles: provisional bin edges and edge-hit adoption.

Counterpart of ``tpuprof/runtime/singlepass.py``.  Pass B of a two-pass
profile exists only because its bin edges need pass A's exact finite
min/max and its MAD needs pass A's mean.  A re-profile of a source often
knows them already, from the previous profile's artifact.
``profile_passes="fused"`` seeds *provisional* per-column ``(lo, hi, mean)``
from that artifact (or from a sketch of the first batch), folds the
moments AND the histograms in one read of every batch (kernel K4), and
after the scan compares the provisional triple with the exact one:

* **hit** — the provisional float32 triple equals the exact triple bit for
  bit: the fused counts and MAD numerator are what pass B would have
  computed, since K4 bins every value as K2 does;
* **miss** — any difference: the lane re-bins in a second scan of the
  missed columns only, on the exact triple.

**The exact triple** is what the port's two-pass path feeds K2:
``Runner.bounds_b_device(state)``, copied to the host (:func:`exact_triple`).
It forms the mean as ``shift + s1/n`` in float32 on the device, where the
reference's host recipe rounds a float64 mean once; the two can differ by
one ulp.  Only the device triple makes "hit => the counts and MAD two-pass
would have computed" literally true, so the hit check, the re-bin and the
artifact's ``bin_seeds`` all use it.  A seed written by the reference may
then miss on ``mean`` in a few lanes; those lanes re-bin and the result is
still identical to two-pass.

The hit, miss and re-bin counts are plain module-level integers
(:data:`edge_hits`, :data:`edge_misses`, :data:`rebins`,
:data:`rebin_lanes`); with metrics on a profile's outcome also feeds the
reference's metrics (:func:`record_outcome`, :func:`record_rebin`:
``tpuprof_singlepass_*`` and the ``singlepass_rebin`` event).
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Dict, List, Optional, Tuple

import numpy as np

from tpuprof_torch.obs import events
from tpuprof_torch.obs import metrics as _obs_metrics

logger = logging.getLogger("tpuprof_torch")

_EDGE_HITS = _obs_metrics.counter(
    "tpuprof_singlepass_edge_hits_total",
    "fused-profile numeric lanes whose provisional bin edges matched "
    "the exact pass-A bounds bitwise (counts adopted, no re-bin)")
_EDGE_MISSES = _obs_metrics.counter(
    "tpuprof_singlepass_edge_misses_total",
    "fused-profile numeric lanes whose provisional edges missed "
    "(re-binned in the targeted pass-B fallback)")
_REBIN_SECONDS = _obs_metrics.histogram(
    "tpuprof_singlepass_rebin_seconds",
    "wall seconds per targeted pass-B re-bin scan (edge-miss fallback)")

# missed column names one singlepass_rebin event carries, at most
REBIN_COLUMNS_CAP = 16

edge_hits = 0       # numeric lanes whose provisional triple held
edge_misses = 0     # numeric lanes whose provisional triple missed
rebins = 0          # targeted re-bin scans run
rebin_lanes = 0     # lanes those scans re-binned

Triple = Tuple[np.ndarray, np.ndarray, np.ndarray]


@dataclasses.dataclass
class ProvisionalEdges:
    """Per-numeric-lane provisional pass-B inputs of a fused scan: float32
    ``(lo, hi, mean)`` in lane order, which lanes an artifact seeded (the
    rest come from the first batch's sketch) and where the seed came
    from."""

    lo: np.ndarray            # (n_num,) float32
    hi: np.ndarray            # (n_num,) float32
    mean: np.ndarray          # (n_num,) float32
    seeded: np.ndarray        # (n_num,) bool
    origin: str = "sketch"    # "artifact" | "sketch" | "checkpoint"

    def as_blob(self) -> Dict[str, object]:
        """The checkpoint form (a collect checkpoint, a stream's payload,
        a fold-state artifact): a resume must bin on the same edges, or
        the restored counts would mix bin layouts."""
        return {"lo": self.lo, "hi": self.hi, "mean": self.mean,
                "seeded": self.seeded, "origin": self.origin}

    @classmethod
    def from_blob(cls, blob: Dict[str, object]) -> "ProvisionalEdges":
        return cls(lo=np.asarray(blob["lo"], dtype=np.float32),
                   hi=np.asarray(blob["hi"], dtype=np.float32),
                   mean=np.asarray(blob["mean"], dtype=np.float32),
                   seeded=np.asarray(blob["seeded"], dtype=bool),
                   origin="checkpoint")


def _empty_edges(n_num: int) -> ProvisionalEdges:
    z = np.zeros((n_num,), dtype=np.float32)
    return ProvisionalEdges(lo=z.copy(), hi=z.copy(), mean=z.copy(),
                            seeded=np.zeros((n_num,), dtype=bool))


def exact_triple(bounds) -> Triple:
    """The exact pass-B inputs on the host: ``Runner.bounds_b_device``'s
    float32 ``(lo, hi, mean)`` tensors as numpy arrays."""
    return tuple(np.asarray(t.detach().cpu().numpy(), dtype=np.float32)
                 for t in bounds)


def bin_seeds(plan, exact: Triple) -> Dict[str, List[float]]:
    """Per-column ``[lo, hi, mean]`` of every numeric lane (bool, constant
    and correlation-rejected columns included): the stats dict's private
    ``_bin_seeds``, which artifacts seal as ``sketches["bin_seeds"]``.
    float32 values survive the float64 JSON round trip exactly."""
    lo, hi, mean = exact
    return {str(s.name): [float(lo[s.num_lane]), float(hi[s.num_lane]),
                          float(mean[s.num_lane])]
            for s in plan.specs if s.role == "num"}


def seed_from_artifact(path: str, plan) -> Optional[ProvisionalEdges]:
    """Provisional edges from a previous ``tpuprof-stats-v1`` artifact:
    its ``sketches["bin_seeds"]``, else (an artifact written before them)
    the histogram's end edges and the column's mean.  Advisory: any
    failure (missing file, corrupt artifact, no shared column) warns and
    returns None, and the first-batch sketch takes over."""
    from tpuprof_torch.artifact.store import read_artifact
    try:
        art = read_artifact(path)
    except Exception as exc:    # noqa: BLE001 — a seed is only a hint
        logger.warning(
            "seed_edges: artifact %r unusable (%s: %s) — falling back to "
            "the first-batch sketch", path, type(exc).__name__, exc)
        return None
    edges = _empty_edges(plan.n_num)
    edges.origin = "artifact"
    seeds = (art.sketches or {}).get("bin_seeds") or {}
    hists = (art.sketches or {}).get("histograms") or {}
    variables = (art.stats or {}).get("variables") or {}
    for spec in plan.specs:
        if spec.role != "num":
            continue
        lane, name = spec.num_lane, str(spec.name)
        triple = seeds.get(name)
        if triple is not None and len(triple) == 3:
            edges.lo[lane], edges.hi[lane], edges.mean[lane] = (
                np.float32(v) for v in triple)
            edges.seeded[lane] = True
            continue
        h = hists.get(name)
        mean = (variables.get(name) or {}).get("mean")
        if h and h.get("edges") and mean is not None:
            edges.lo[lane] = np.float32(h["edges"][0])
            edges.hi[lane] = np.float32(h["edges"][-1])
            edges.mean[lane] = np.float32(mean)
            edges.seeded[lane] = True
    if not edges.seeded.any():
        logger.warning(
            "seed_edges: artifact %r shares no numeric column with this "
            "source — falling back to the first-batch sketch", path)
        return None
    return edges


def sketch_edges(x: np.ndarray, nrows: int,
                 into: Optional[ProvisionalEdges] = None
                 ) -> ProvisionalEdges:
    """Cold-start provisional edges from the first batch ``x`` (rows,
    n_num): per-column finite min/max and mean (float64 sum, cast to
    float32), so constant columns hit by construction; a column with no
    finite value sketches (0, 0, 0), the exact triple of an all-missing
    column.  ``into`` fills only its unseeded lanes."""
    edges = into if into is not None else _empty_edges(x.shape[1])
    prefix = x[:nrows]
    if prefix.shape[0] == 0 or edges.seeded.all():
        return edges
    finite = np.isfinite(prefix)
    cnt = finite.sum(axis=0)
    lo = np.where(cnt > 0, np.where(finite, prefix, np.inf).min(axis=0), 0.0)
    hi = np.where(cnt > 0, np.where(finite, prefix, -np.inf).max(axis=0),
                  0.0)
    mean = np.where(
        cnt > 0,
        np.where(finite, prefix, 0.0).astype(np.float64).sum(axis=0)
        / np.maximum(cnt, 1), 0.0)
    fill = ~edges.seeded
    edges.lo[fill] = lo.astype(np.float32)[fill]
    edges.hi[fill] = hi.astype(np.float32)[fill]
    edges.mean[fill] = mean.astype(np.float32)[fill]
    return edges


def resolve_seeds(config, plan) -> Optional[ProvisionalEdges]:
    """Artifact edges for ``config.seed_edges`` (or ``TPUPROF_SEED_EDGES``),
    else None: the caller sketches from the first batch."""
    from tpuprof_torch.config import resolve_seed_edges
    path = resolve_seed_edges(config.seed_edges)
    return seed_from_artifact(path, plan) if path is not None else None


def hit_lanes(edges: ProvisionalEdges, exact: Triple) -> np.ndarray:
    """Per lane: did the provisional float32 triple equal the exact one
    bit for bit?  Counts the outcome in :data:`edge_hits` /
    :data:`edge_misses`."""
    global edge_hits, edge_misses
    lo, hi, mean = exact
    hits = (edges.lo == lo) & (edges.hi == hi) & (edges.mean == mean)
    edge_hits += int(hits.sum())
    edge_misses += int(hits.size - hits.sum())
    return hits


def record_outcome(hits: np.ndarray) -> None:
    """A profile's hit check into the metrics: one increment a lane, so a
    hit rate is ``hits / (hits + misses)`` over any window."""
    if not _obs_metrics.enabled():
        return
    n_hit = int(hits.sum())
    if n_hit:
        _EDGE_HITS.inc(n_hit)
    if hits.size - n_hit:
        _EDGE_MISSES.inc(int(hits.size - n_hit))


def record_rebin(seconds: float, miss_names: List[str],
                 origin: str) -> None:
    """One targeted re-bin scan ran over the missed lanes ``miss_names``
    of edges from ``origin``, in ``seconds``; with metrics on, its
    histogram and a ``singlepass_rebin`` event naming up to
    :data:`REBIN_COLUMNS_CAP` of the columns."""
    global rebins, rebin_lanes
    rebins += 1
    rebin_lanes += len(miss_names)
    if not _obs_metrics.enabled():
        return
    _REBIN_SECONDS.observe(seconds)
    events.emit("singlepass_rebin", n_miss=len(miss_names),
                columns=sorted(miss_names)[:REBIN_COLUMNS_CAP],
                seconds=round(seconds, 4), origin=origin)


def merge_rebinned(res_fused: Dict[str, np.ndarray],
                   res_sub: Dict[str, np.ndarray],
                   miss: np.ndarray) -> Dict[str, np.ndarray]:
    """The full pass-B result: hit lanes keep their fused counts, missed
    lanes take the re-bin's."""
    counts = np.array(res_fused["counts"], copy=True)
    abs_dev = np.array(res_fused["abs_dev"], copy=True)
    counts[miss] = res_sub["counts"]
    abs_dev[miss] = res_sub["abs_dev"]
    return {"counts": counts, "abs_dev": abs_dev}
