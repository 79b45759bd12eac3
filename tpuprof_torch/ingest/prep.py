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
Each tier counts the tasks it ran by worker thread (``worker="serial"`` for
the in-caller path): a skewed spread means the split leaves cores idle.
"""

from __future__ import annotations

import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable, Iterable, Iterator, List, Optional, Sequence

from tpuprof_torch.obs import metrics

_PREP_TASKS = metrics.counter(
    "tpuprof_prep_tasks_total",
    "intra-batch prep leaf tasks executed, by worker thread")
_BATCH_TASKS = metrics.counter(
    "tpuprof_prep_batch_tasks_total",
    "whole-batch prepares run through the ordered cross-batch pipeline")
_IO_TASKS = metrics.counter(
    "tpuprof_prep_io_tasks_total",
    "background disk-write tasks (unique-spill runs) run on the io tier")
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
    own failure semantics; the pool never swallows one."""

    def _counted():
        out = fn()
        _IO_TASKS.inc(worker=threading.current_thread().name)
        return out

    return _shared("io", max(int(workers), 1)).submit(_counted)


def run_tasks(tasks: Sequence[Callable[[], None]], workers: int) -> None:
    """Run one batch's leaf tasks, on the column pool when it helps.

    Tasks write disjoint output slices, so completion order does not reach
    the result.  Every task is awaited even on failure (a late writer into
    a freed plane would corrupt the next batch); then the first exception
    in submission order re-raises, the one the serial loop raises."""
    if workers <= 1 or len(tasks) <= 1:
        for t in tasks:
            t()
        _PREP_TASKS.inc(len(tasks), worker="serial")
        return

    def _counted(t: Callable[[], None]) -> None:
        t()
        # after the body: the count is completed work, not attempts
        _PREP_TASKS.inc(worker=threading.current_thread().name)

    pool = _shared("col", workers)
    futs = [pool.submit(_counted, t) for t in tasks]
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
            _BATCH_TASKS.inc(worker="serial")
        return
    pool = _shared("batch", workers)
    pending: List = []
    depth = max(depth, 1)

    def _counted(it):
        out = fn(it)
        _BATCH_TASKS.inc(worker=threading.current_thread().name)
        return out

    try:
        for it in items:
            pending.append(pool.submit(_counted, it))
            while len(pending) > depth:
                yield pending.pop(0).result()
        while pending:
            yield pending.pop(0).result()
    finally:
        for f in pending:       # consumer bailed: don't leak queued work
            f.cancel()
