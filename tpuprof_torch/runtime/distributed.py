"""Profiles across processes: each scans a stripe, the finalized states
merge.

Counterpart of ``tpuprof/runtime/distributed.py``.  N processes run the
same profile; process i reads the dataset fragments i, i+N, i+2N, ...
(``assign_fragments``), scans them on the CUDA devices it sees (one runner,
or a ``runtime/mesh.py`` mesh of them), and the states merge across
processes with the kernels' own merge laws, so every process ends with the
whole table's statistics.  What crosses processes is host data: finalized
device states as numpy arrays (a few KB of mergeable sums), ``HostAgg``s,
samplers, HLL registers, recount vectors and metric wires, pickled.  So the
transport is a ``torch.distributed`` **gloo** group
(``dist.all_gather_object``) on every machine: it carries objects, lets
several ranks share one card, and needs no NCCL.  States are finalized to
numpy *before* a gather: a pickled CUDA tensor would come back on the
sender's device.

Everything here degrades to a no-op in one process (no group, or a group of
one), which is how the single-process paths run it.

The part-level laws (``merge_*_parts``, ``_merge_pair``) are shared with
the elastic fleet (``runtime/fleet.py``), which hands them contribution
parts read off shared storage instead of a gather's rank-ordered list.
"""

from __future__ import annotations

import datetime
from typing import Any, Dict, Iterator, List, Optional

import numpy as np

# the gloo group's collective timeout when barrier_timeout_s is unset
DEFAULT_GROUP_TIMEOUT_S = 1800.0


def _dist():
    import torch.distributed as dist
    return dist if dist.is_available() else None


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               timeout_s: Optional[float] = None) -> None:
    """Join the gloo process group (a no-op when every argument is None or
    a group exists).  ``coordinator_address`` is ``HOST:PORT`` (rank 0
    listens there: ``tcp://HOST:PORT``) or an init URL such as
    ``file:///shared/rendezvous``.  ``timeout_s`` bounds every collective
    of the group (``barrier_timeout_s``; default
    :data:`DEFAULT_GROUP_TIMEOUT_S`), so a dead peer fails the survivors
    instead of hanging them."""
    if coordinator_address is None and num_processes is None:
        return
    dist = _dist()
    if dist is None:
        raise RuntimeError("torch.distributed is not available in this "
                           "build of PyTorch")
    if dist.is_initialized():
        return
    url = coordinator_address if "://" in coordinator_address \
        else f"tcp://{coordinator_address}"
    dist.init_process_group(
        "gloo", init_method=url, world_size=int(num_processes),
        rank=int(process_id),
        timeout=datetime.timedelta(
            seconds=float(timeout_s or DEFAULT_GROUP_TIMEOUT_S)))


def shutdown() -> None:
    """Leave the process group (after the last collective)."""
    dist = _dist()
    if dist is not None and dist.is_initialized():
        dist.destroy_process_group()


def process_info():
    """(this process's rank, the number of processes); (0, 1) without a
    group."""
    dist = _dist()
    if dist is None or not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def assign_fragments(fragments, process_index: int,
                     process_count: int) -> Iterator:
    """Stripe fragments over processes: process i reads fragments i,
    i+n, i+2n, ... (deterministic, no coordination)."""
    for k, frag in enumerate(fragments):
        if k % process_count == process_index:
            yield frag


def allgather_objects(obj) -> List[Any]:
    """Every process's ``obj`` on every process, in rank order (pickled
    over the gloo group); ``[obj]`` in one process."""
    rank, world = process_info()
    if world == 1:
        return [obj]
    out: List[Any] = [None] * world
    _dist().all_gather_object(out, obj)
    return out


def allgather_with_watchdog(obj, timeout_s=None, site: str = "barrier",
                            heartbeat=None):
    """:func:`allgather_objects` under a watchdog deadline (the resume
    barrier, the fleet publication): a peer that died before its gather
    raises :class:`WatchdogTimeout` with the heartbeat instead of hanging
    every healthy process.  ``timeout_s`` None is the plain gather."""
    from tpuprof_torch.runtime import guard
    from tpuprof_torch.testing import faults

    def _gather():
        faults.hit("barrier")
        return allgather_objects(obj)

    return guard.watched(_gather, timeout_s, site=site, heartbeat=heartbeat)


def publish_fleet(reason: str, metrics_path=None, quarantined=None,
                  timeout_s=None):
    """The fleet's metrics: every process gathers every process's registry
    wire (symmetric: every process must call it) and rank 0 writes
    ``<metrics_path>.fleet.prom`` and a ``fleet_snapshot`` event, gauges
    labelled ``host="<rank>"``.  ``quarantined`` (this process's quarantine
    count) rides the same gather.  Returns the path rank 0 wrote, else
    None."""
    from tpuprof_torch.obs import fleet, metrics
    payload = {"wire": metrics.registry().to_wire(),
               "quarantined": int(quarantined or 0)}
    parts = allgather_with_watchdog(payload, timeout_s,
                                    site="fleet_publish") \
        if timeout_s else allgather_objects(payload)
    if process_info()[0] != 0:
        return None
    return fleet.write_fleet(
        metrics_path, [p["wire"] for p in parts], reason=reason,
        quarantined_by_host=[p["quarantined"] for p in parts])


def merge_host_aggs(hostagg):
    """Every process's ``HostAgg`` merged into one, on every process.  The
    run files of the exact tracker change owner: the merged copy claims
    them, the original lets them go (after the merge, so a failure
    mid-merge leaves each process owning its own)."""
    parts = allgather_objects(hostagg)
    merged = merge_host_agg_parts(parts)
    if len(parts) > 1:
        hostagg.unique.disown_runs()
        merged.unique.claim_runs()
    return merged


def resolve_unique_distributed(tracker) -> None:
    """Decide spilled columns once for all processes: rank 0 runs the
    k-way resolve over the shared spill dir and every process adopts its
    verdicts and counts (after the merge every process holds the same run
    lists).  No-op in one process."""
    rank, world = process_info()
    if world == 1:
        return
    payload = (tracker.resolve(), tracker.distinct_counts()) \
        if rank == 0 else None
    parts = allgather_objects(payload)
    tracker.seed_resolution(parts[0][0], parts[0][1])


def merge_shift_estimates(local_shift):
    """One centering shift for every process: the mean of the estimates of
    the processes that saw data (None where none did).  Every process calls
    it exactly once before its pass-A state starts; a process with an empty
    stripe passes None and still takes part."""
    parts = [p for p in allgather_objects(local_shift) if p is not None]
    if not parts:
        return None
    return np.mean(np.stack(parts), axis=0).astype(np.float32)


def merge_samplers(sampler):
    """Every process's row sample merged (the bottom-k priority law)."""
    return merge_sampler_parts(allgather_objects(sampler))


def merge_hll_registers(host_hll):
    """Every process's host HLL registers, elementwise max."""
    parts = allgather_objects(host_hll)
    merged = parts[0]
    for other in parts[1:]:
        merged = merged.merge(other)
    return merged


# ---------------------------------------------------------------------------
# The part-level laws: the fold half of each merge, shared by the gathers
# above (rank-ordered parts) and the elastic fleet (parts read off shared
# storage in (host, seq) order).
# ---------------------------------------------------------------------------

def _torch_state(tree):
    import torch
    if isinstance(tree, dict):
        return {k: _torch_state(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, copy=True))


def _numpy_state(tree):
    if isinstance(tree, dict):
        return {k: _numpy_state(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy()


def merge_sampler_parts(parts):
    """Fold ``RowSampler`` parts (bottom-k: order-free)."""
    merged = parts[0]
    for other in parts[1:]:
        merged = merged.merge(other)
    return merged


def merge_pass_a_parts(parts: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Fold finalized pass-A states (numpy ``{"mom", "corr", "hll"}``) with
    the kernels' merges: moments and the Gram rebase onto one shift
    exactly, HLL registers max."""
    from tpuprof_torch.kernels import corr as kcorr
    from tpuprof_torch.kernels import moments as kmoments
    merged = parts[0]
    for other in parts[1:]:
        merged = {
            "mom": _numpy_state(kmoments.merge(
                _torch_state(merged["mom"]), _torch_state(other["mom"]))),
            "corr": _numpy_state(kcorr.merge(
                _torch_state(merged["corr"]), _torch_state(other["corr"]))),
            "hll": np.maximum(merged["hll"], other["hll"]),
        }
    return merged


def merge_corr_parts(parts):
    """Fold finalized Gram states (a Spearman state; the parts may carry
    different shifts, which the merge rebases)."""
    from tpuprof_torch.kernels import corr as kcorr
    merged = parts[0]
    for other in parts[1:]:
        merged = _numpy_state(kcorr.merge(_torch_state(merged),
                                          _torch_state(other)))
    return merged


def merge_pass_b_parts(parts):
    """Fold finalized pass-B states (sums)."""
    merged = dict(parts[0])
    for other in parts[1:]:
        merged["counts"] = merged["counts"] + other["counts"]
        merged["abs_dev"] = merged["abs_dev"] + other["abs_dev"]
    return merged


def merge_recount_parts(parts):
    """Sum pass-B recount vectors (the candidates are the same everywhere:
    they come from the merged ``HostAgg``)."""
    merged = dict(parts[0])
    for other in parts[1:]:
        for name, arr in other.items():
            merged[name] = merged[name] + arr
    return merged


def merge_host_agg_parts(parts):
    """Fold ``HostAgg`` parts with :func:`_merge_pair`; mutates and returns
    ``parts[0]``.  Run-file ownership is the caller's concern."""
    merged = parts[0]
    for other in parts[1:]:
        merged = _merge_pair(merged, other)
    return merged


def merge_pass_a_states(res_a):
    """The cross-process merge of a finalized pass-A state (no-op in one
    process)."""
    if process_info()[1] == 1:
        return res_a
    return merge_pass_a_parts(allgather_objects(res_a))


def merge_corr_states(state):
    """The cross-process merge of a finalized Gram state."""
    if process_info()[1] == 1:
        return state
    return merge_corr_parts(allgather_objects(state))


def merge_pass_b_states(res_b):
    """The cross-process merge of a finalized pass-B state."""
    if process_info()[1] == 1:
        return res_b
    return merge_pass_b_parts(allgather_objects(res_b))


def merge_recount_arrays(counts_by_col):
    """Each process's pass-B recount vectors, summed."""
    return merge_recount_parts(allgather_objects(counts_by_col))


def _merge_pair(a, b):
    """Combine two ``HostAgg``s (commutative laws: Misra-Gries merge,
    tracker merge, sums, date min/max; first values from ``a`` first)."""
    a.n_rows += b.n_rows
    for name, nb in b.col_nbytes.items():
        a.col_nbytes[name] = a.col_nbytes.get(name, 0) + nb
    for name, nb in b.col_dict_nbytes.items():
        # summed across processes: a dictionary is shared within one
        # process's stripe (a max there), each process holds its own
        a.col_dict_nbytes[name] = a.col_dict_nbytes.get(name, 0) + nb
    for name, mg in b.mg.items():
        a.mg[name].merge(mg)
    a.unique.merge(b.unique)
    for name, cnt in b.cat_null.items():
        a.cat_null[name] += cnt
    for name, cnt in b.date_null.items():
        a.date_null[name] += cnt
    for name, lo in b.date_min.items():
        a.date_min[name] = min(a.date_min.get(name, lo), lo)
    for name, hi in b.date_max.items():
        a.date_max[name] = max(a.date_max.get(name, hi), hi)
    for name, vals in b.first_values.items():
        a.first_values.setdefault(name, vals)
    return a
