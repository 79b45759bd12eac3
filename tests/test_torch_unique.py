"""The port's exact-unique tracker against the reference's.

``tpuprof_torch.kernels.unique.UniqueTracker`` and
``tpuprof.kernels.unique.UniqueTracker`` take the same numpy-seeded 64-bit
hash streams: in memory, compacted and spilled, probing (UNIQUE/DUP
claims) and counting (``count_exact``), at 1, 4 and 16 partitions and 0
and 2 spill workers.  Statuses and exact distinct counts are equal, and
the run files hold the same bytes in write order (their names carry each
tracker's own token).  Then the tracker's durability: a write into an
unwritable directory demotes, a pickle keeps the runs, a restore with a run
gone or torn demotes, ``persistent``/``reap_retired`` keep what the last
save references, and ``cleanup`` removes its own runs, other tokens' only
past the sweep age, and the directory only when it owns it."""

import os
import pickle
import time

import numpy as np
import pytest

from tpuprof.kernels import unique as ref_unique
from tpuprof_torch.kernels import unique as port_unique

NAMES = ("ids", "late", "low", "mid", "top")
BATCHES, ROWS = 6, 400
GOLDEN = np.uint64(0x9E3779B97F4A7C15)


def _streams(seed=5):
    """Per batch, per column, the hashes of its valid rows: all distinct
    (``ids``), distinct until one repeat in the last batch (``late``, found
    only across epochs once spilled), 40 values (``low``), about 1,500
    (``mid``) and distinct values packed into the top partition (``top``)."""
    rng = np.random.default_rng(seed)
    ids = rng.permutation(np.arange(1, 1 << 20, dtype=np.uint64))
    ids = ids[:2 * BATCHES * ROWS] * GOLDEN
    out = []
    for b in range(BATCHES):
        late = ids[BATCHES * ROWS + b * ROWS:BATCHES * ROWS + (b + 1) * ROWS]
        if b == BATCHES - 1:
            late = late.copy()
            late[-1] = ids[BATCHES * ROWS]          # batch 0's first value
        out.append({
            "ids": ids[b * ROWS:(b + 1) * ROWS],
            "late": late,
            "low": rng.integers(1, 41, ROWS).astype(np.uint64) * GOLDEN,
            "mid": rng.integers(1, 1500, ROWS).astype(np.uint64) * GOLDEN,
            "top": ids[b * ROWS:(b + 1) * ROWS] | np.uint64(0xFF << 56),
        })
    return out


STREAMS = _streams()
TRUTH = {n: int(np.unique(np.concatenate([s[n] for s in STREAMS])).size)
         for n in NAMES}
# per-column / global budgets: nothing spills, the counting tier compacts
# in memory, and every high-cardinality column spills
BUDGETS = {"memory": (1 << 20, 1 << 22), "compact": (1800, 1 << 22),
           "spill": (500, 1500)}


def _make(mod, spill_dir, budget, count_exact, partitions, workers, **kw):
    per, total = BUDGETS[budget]
    return mod.UniqueTracker(NAMES, per, total, spill_dir=spill_dir,
                             count_exact=count_exact, partitions=partitions,
                             spill_workers=workers, **kw)


def _feed(t, streams=STREAMS):
    for s in streams:
        for n in NAMES:
            t.update(n, s[n], hash_kind="native")


def _run_bytes(t):
    """(the run files' bytes in write order, the columns holding runs); the
    sequence number in each name is the order."""
    paths = [p for n in NAMES for p, _rows in t._runs[n]]
    paths.sort(key=lambda p: int(p.rsplit("-", 1)[1].split(".")[0]))
    out = []
    for p in paths:
        with open(p, "rb") as fh:
            out.append(fh.read())
    return out, {n for n in NAMES if t._runs[n]}


@pytest.mark.parametrize("workers", [0, 2])
@pytest.mark.parametrize("partitions", [1, 4, 16])
@pytest.mark.parametrize("count_exact", [False, True])
@pytest.mark.parametrize("budget", list(BUDGETS))
def test_matches_reference(tmp_path, budget, count_exact, partitions,
                           workers):
    got = {}
    for label, mod in (("ref", ref_unique), ("port", port_unique)):
        t = _make(mod, str(tmp_path / label), budget, count_exact,
                  partitions, workers)
        _feed(t)
        t.flush_spills()
        got[label] = (t.resolve(), t.distinct_counts(), _run_bytes(t))
        t.cleanup()
        assert not os.listdir(tmp_path / label) \
            if (tmp_path / label).exists() else True
    assert got["port"][0] == got["ref"][0]
    assert got["port"][1] == got["ref"][1]
    assert got["port"][2] == got["ref"][2]
    status, counts, (runs, spilled) = got["port"]
    assert status["low"] == status["mid"] == status["late"] == \
        port_unique.DUP
    assert status["ids"] == status["top"] == port_unique.UNIQUE
    if count_exact:
        assert counts == TRUTH
    else:
        assert counts == {}
    # the low-cardinality columns compact in memory at the middle budget
    assert bool(runs) == (budget != "memory")
    if budget == "compact":
        assert spilled and not spilled & {"low", "mid"}


@pytest.mark.parametrize("workers", [0, 2])
def test_unwritable_spill_dir_demotes(tmp_path, workers):
    """A spill into a path under a regular file fails; the column falls
    back to OVERFLOW unless a duplicate is already in evidence, as the
    reference's does, and no partial file is left."""
    blocker = tmp_path / "file"
    blocker.write_bytes(b"")
    got = {}
    for label, mod in (("ref", ref_unique), ("port", port_unique)):
        t = _make(mod, str(blocker / "sub"), "spill", True, 4, workers)
        _feed(t)
        got[label] = (t.resolve(), t.distinct_counts())
        t.cleanup()
    assert got["port"] == got["ref"]
    status, counts = got["port"]
    assert status["ids"] == port_unique.OVERFLOW
    assert status["late"] in (port_unique.OVERFLOW, port_unique.DUP)
    assert "ids" not in counts and counts["low"] == TRUTH["low"]


@pytest.mark.parametrize("count_exact", [False, True])
def test_pickle_keeps_the_runs(tmp_path, count_exact):
    t = _make(port_unique, str(tmp_path), "spill", count_exact, 4, 2)
    _feed(t, STREAMS[:3])
    blob = pickle.dumps(t)
    paths = {p for n in NAMES for p, _r in t._runs[n]}
    assert paths and all(os.path.exists(p) for p in paths)
    u = pickle.loads(blob)
    assert {p for n in NAMES for p, _r in u._runs[n]} == paths
    assert u._spill_token != t._spill_token
    _feed(t, STREAMS[3:])
    _feed(u, STREAMS[3:])
    assert u.resolve() == t.resolve()
    assert u.distinct_counts() == t.distinct_counts()
    t.persistent = True     # the restored copy still references its runs
    del u                   # owns none of them: its GC deletes nothing
    assert all(os.path.exists(p) for p in paths)
    t.cleanup()
    assert os.listdir(tmp_path) == []


def _tear(path, how):
    if how == "deleted":
        os.remove(path)
    elif how == "truncated":
        with open(path, "r+b") as fh:
            fh.truncate(os.path.getsize(path) - 8)
    else:                               # a bit flip in the partition index
        with open(path, "r+b") as fh:
            fh.seek(len(port_unique.RUN_MAGIC) + 8)
            byte = fh.read(1)
            fh.seek(-1, os.SEEK_CUR)
            fh.write(bytes([byte[0] ^ 1]))


@pytest.mark.parametrize("how", ["deleted", "truncated", "bitflip"])
def test_restore_with_a_lost_run_demotes(tmp_path, how):
    """The reference's ``__setstate__`` law: a column one of whose runs is
    gone or torn falls back to OVERFLOW, the others keep their runs and
    their exact answer, and no surviving run is deleted."""
    got = {}
    for label, mod in (("ref", ref_unique), ("port", port_unique)):
        d = tmp_path / label
        t = _make(mod, str(d), "spill", True, 4, 0)
        _feed(t)
        t.persistent = True
        blob = pickle.dumps(t)
        _tear(t._runs["ids"][0][0], how)
        survivors = [p for p, _r in t._runs["ids"][1:]]
        u = pickle.loads(blob)
        assert all(os.path.exists(p) for p in survivors)
        got[label] = (u.resolve(), u.distinct_counts())
    assert got["port"] == got["ref"]
    status, counts = got["port"]
    assert status["ids"] == port_unique.OVERFLOW and "ids" not in counts
    assert counts["top"] == TRUTH["top"] and counts["mid"] == TRUTH["mid"]


def test_persistent_runs_wait_for_the_next_save(tmp_path):
    """While a save references the runs, a demoted column's runs are
    retired, not deleted, and survive the tracker's GC; ``reap_retired``
    (after the next save) deletes exactly those."""
    t = _make(port_unique, str(tmp_path), "spill", True, 4, 2)
    _feed(t)
    t.flush_spills()
    t.persistent = True
    ids_runs = [p for p, _r in t._runs["ids"]]
    kept = [p for p, _r in t._runs["top"]]
    t.deactivate("ids")
    assert t.status["ids"] == port_unique.OVERFLOW
    assert all(os.path.exists(p) for p in ids_runs + kept)
    t.reap_retired()
    assert not any(os.path.exists(p) for p in ids_runs)
    assert all(os.path.exists(p) for p in kept)
    owned = list(t._owned)
    del t                               # persistent: GC deletes nothing
    assert all(os.path.exists(p) for p in kept) and owned


@pytest.mark.parametrize("own_dir", [False, True])
def test_cleanup_removes_only_what_it_may(tmp_path, own_dir):
    d = tmp_path / "spill"
    t = _make(port_unique, str(d), "spill", True, 4, 0, own_spill_dir=own_dir)
    _feed(t)
    assert os.listdir(d)
    young = d / "tpuprof-uniq-0123456789ab-0.u64"
    old = d / "tpuprof-uniq-ba9876543210-0.u64"
    other = d / "notes.txt"
    for f in (young, old, other):
        f.write_bytes(b"x")
    stale = time.time() - port_unique.ORPHAN_SWEEP_AGE_S - 60
    os.utime(old, (stale, stale))
    t.cleanup()
    assert sorted(os.listdir(d)) == ["notes.txt", young.name]
    os.remove(young)
    os.remove(other)
    t.cleanup()                         # idempotent; an owned empty dir goes
    assert d.exists() != own_dir


def test_touch_runs_restamps_referenced_runs(tmp_path):
    t = _make(port_unique, str(tmp_path), "spill", True, 1, 0)
    _feed(t)
    paths = [p for n in NAMES for p, _r in t._runs[n]]
    stale = time.time() - port_unique.ORPHAN_SWEEP_AGE_S - 60
    for p in paths:
        os.utime(p, (stale, stale))
    t.touch_runs()              # rate-limited: updates just stamped
    assert all(os.path.getmtime(p) < stale + 1 for p in paths)
    t.touch_runs(force=True)
    assert all(os.path.getmtime(p) > stale + 60 for p in paths)


def test_a_tracker_pickled_before_the_spill_tier_restores(tmp_path):
    """A checkpoint of the in-memory tracker (no runs, no counting) loads
    into this one and goes on with its claims."""
    t = port_unique.UniqueTracker(NAMES, 1 << 20, 1 << 22)
    _feed(t, STREAMS[:2])
    state = {k: t.__dict__[k] for k in ("budget", "total_budget", "status",
                                        "_chunks", "_rows", "_kind",
                                        "_live")}
    u = port_unique.UniqueTracker.__new__(port_unique.UniqueTracker)
    u.__setstate__(state)
    _feed(u, STREAMS[2:])
    _feed(t, STREAMS[2:])
    assert u.resolve() == t.resolve() and u.distinct_counts() == {}
