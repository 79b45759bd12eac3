"""Shared thread pools for the host-side batch prepare.

Counterpart of ``tpuprof/ingest/prep.py``.  Three tiers, three pools, no
nesting:

* the **column pool** runs the leaf tasks of one ``prepare_batch``: one a
  column, plus row-chunk tasks for tall numeric columns.  Leaf tasks never
  submit work, so any number of concurrent prepares can share the pool
  without a saturation deadlock.  Sized by
  :func:`tpuprof_torch.config.resolve_prep_workers`.
* the **batch pool** runs whole-batch work for ordered pipelines over a
  known worklist (:func:`ordered_map`).  Batch tasks fan out onto the
  column pool, never onto their own, so the tiers form a DAG.
* the **io pool** runs background disk writes (:func:`submit_io`): the
  exact-unique tracker's spill runs (``kernels/unique.py``), so they hide
  under the device scan and the next prepare.  IO tasks are leaves and wait
  on the disk, not the GIL; callers bound their own window and settle
  futures oldest first.

All pools are process-wide and built on first use: the hot paths (Arrow
decode, numpy casts, the native hash and pack, ``ndarray.tofile``) release
the GIL, so shared pools keep the cores busy without a thread pool a batch.
The reference's per-worker task counters wait for the telemetry slice.
"""

from __future__ import annotations

import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable, Iterable, Iterator, List, Optional, Sequence

_LOCK = threading.Lock()
_POOLS = {}         # tier -> (ThreadPoolExecutor, workers)


def _shared(kind: str, workers: int) -> ThreadPoolExecutor:
    """The shared pool of one tier, grown (never shrunk) to ``workers``.
    A replaced pool drains its queued tasks before its threads end, so
    futures from it stay valid."""
    with _LOCK:
        pool, have = _POOLS.get(kind, (None, 0))
        if pool is None or have < workers:
            pool = ThreadPoolExecutor(
                max_workers=workers,
                thread_name_prefix=f"tpuprof-torch-{kind}")
            _POOLS[kind] = (pool, workers)
        return pool


def submit_io(fn: Callable[[], object], workers: int) -> Future:
    """Queue one background disk write on the io tier and return its
    Future.  The caller owns the completion policy: it bounds the window,
    settles futures oldest first and turns a raised ``OSError`` into its
    own failure semantics; the pool never swallows one.  (The reference
    counts each task here; that counter comes with the telemetry slice.)"""
    return _shared("io", max(int(workers), 1)).submit(fn)


def run_tasks(tasks: Sequence[Callable[[], None]], workers: int) -> None:
    """Run one batch's leaf tasks, on the column pool when it helps.

    Tasks write disjoint output slices, so completion order does not reach
    the result.  Every task is awaited even on failure (a late writer into
    a freed plane would corrupt the next batch); then the first exception
    in submission order re-raises, the one the serial loop raises."""
    if workers <= 1 or len(tasks) <= 1:
        for t in tasks:
            t()
        return
    pool = _shared("col", workers)
    futs = [pool.submit(t) for t in tasks]
    first: Optional[BaseException] = None
    for f in futs:
        try:
            f.result()
        except BaseException as exc:    # noqa: BLE001 — re-raised below
            if first is None:
                first = exc
    if first is not None:
        raise first


def ordered_map(items: Iterable, fn: Callable, workers: int,
                depth: int = 2) -> Iterator:
    """``fn`` over ``items`` on the batch pool, delivered in order with up
    to ``depth`` results in flight ahead of the consumer; ``workers <= 1``
    is exactly a for loop."""
    if workers <= 1:
        for it in items:
            yield fn(it)
        return
    pool = _shared("batch", workers)
    pending: List = []
    depth = max(depth, 1)
    try:
        for it in items:
            pending.append(pool.submit(fn, it))
            while len(pending) > depth:
                yield pending.pop(0).result()
        while pending:
            yield pending.pop(0).result()
    finally:
        for f in pending:       # consumer bailed: don't leak queued work
            f.cancel()
