"""K2's cluster body (``csrc/hist_b.cu`` ``hist_partial_cluster``), past
8,192 bins, modelled in numpy on the CPU.

The kernel needs the card; its plan and its arithmetic do not.  What the
body does, step for step:

* the grid is (C, S_pad): S = ``hist.splits(split_cols or C, R)`` row
  splits a column, padded to S_pad, a multiple of the cluster size K;
  each K consecutive splits of a column are one cluster; a block with
  s < S counts its split's rows, a padding block (s >= S) none;
* ``private16`` / ``private32``: every block counts into a whole copy of
  the histogram in its shared memory (two 16-bit counters a word, bin b
  in half b & 1 of word b >> 1, where a block counts fewer than 2**16
  values; else one a word), then block k sums the k-th range of 16-byte
  words over the cluster's K copies and flushes those bins;
* ``spread``: block k holds ``words`` of one histogram spread over the
  cluster: bin b lies in block b % K at word b // K; every add goes to
  the owner; each block flushes its slice (the plan takes it only up to
  ``hist.SPREAD_MAX`` blocks; the kernel, and the model, at any K);
* the flush: plain stores when one cluster holds the column (S_pad == K),
  else integer adds onto a zeroed output.

``hist.cluster_plan`` makes the plan.  Every plan at the tier edges must
fit a block's shared memory, cover every bin exactly once and keep the
row partition; the model's counts must equal ``histogram_plain``'s on
adversarial batches.  The budget constants are read from ``hist.cuh``
itself, as ``test_torch_hist_order.py`` reads its own.
"""

import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from tpuprof_torch.kernels import hist

HIST_CUH = Path(hist.__file__).parent / "csrc" / "hist.cuh"
F32 = np.float32


def _cuh_constant(name: str) -> int:
    """``constexpr int <name> = <value>;`` in hist.cuh."""
    m = re.search(rf"constexpr int {name} = (\d+);", HIST_CUH.read_text())
    assert m, f"{name} not in {HIST_CUH}"
    return int(m.group(1))


THREADS = _cuh_constant("HIST_THREADS")
CLUSTER_MAX = _cuh_constant("HIST_CLUSTER_MAX")
SLICE_MAX_BINS = _cuh_constant("HIST_SLICE_MAX_BINS")
SMEM_OPTIN = _cuh_constant("HIST_SMEM_OPTIN")
# dev_store's tree: one float a thread, static shared memory of the block
DEV_TREE = THREADS * 4

# the tier edges: the first past the shared body, the headline's, the
# largest 32-bit copy, 65,536, the largest 16-bit copy and one past it,
# the largest spread histogram (the cluster body's reach) and one past it
EDGES = [hist.SHARED_MAX_BINS + 1, 16384, SLICE_MAX_BINS, 65536,
         2 * SLICE_MAX_BINS, 2 * SLICE_MAX_BINS + 1,
         hist.SPREAD_MAX * SLICE_MAX_BINS,
         hist.SPREAD_MAX * SLICE_MAX_BINS + 1]


def test_constants_match_the_wrapper():
    assert (CLUSTER_MAX, SLICE_MAX_BINS) == (hist.CLUSTER_MAX,
                                             hist.SLICE_MAX_BINS)
    assert hist.CLUSTER_MAX_BINS == hist.SPREAD_MAX * SLICE_MAX_BINS
    assert hist.SPREAD_MAX <= CLUSTER_MAX
    assert SLICE_MAX_BINS * 4 + DEV_TREE == SMEM_OPTIN


def flushed(plan, nbins):
    """{(block rank, word): [bins]} the flush writes from each word: in a
    private layout block k sums the k-th range of 16-byte words over the
    copies; in a spread layout each block writes its own slice (it stops
    at the first word past nbins)."""
    K, words = plan.cluster, plan.words
    out = {}
    if plan.layout.startswith("private"):
        n4 = words // 4
        w4 = -(-n4 // K)
        for k in range(K):
            for w in range(4 * k * w4, 4 * min(n4, (k + 1) * w4)):
                bins = [w] if plan.layout == "private32" else [2 * w,
                                                               2 * w + 1]
                out[(k, w)] = [b for b in bins if b < nbins]
        return out
    for k in range(K):
        for w in range(words):
            b = w * K + k
            if b >= nbins:
                break
            out[(k, w)] = [b]
    return out


def counted_at(b, plan, nbins):
    """(block rank or -1 for the counting block, word, increment) of bins
    ``b``: the kernel's add."""
    if plan.layout == "private32":
        return -1, b, np.ones_like(b)
    if plan.layout == "private16":
        return -1, b >> 1, np.where(b & 1, 1 << 16, 1)
    return b % plan.cluster, b // plan.cluster, np.ones_like(b)


def plan_of(C, R, nbins, split_cols=None, kind=None):
    """``hist.cluster_plan``'s plan (kind None), or with kind
    ``"spread"`` the spread layout forced at any cluster size the kernel
    takes (``chip_smoke.py --k2-probe`` times it past the plan's
    ``hist.SPREAD_MAX``): K = max(S, the blocks whose slices hold nbins),
    16 where S passes 16."""
    if kind is None:
        return hist.cluster_plan(C, R, nbins, split_cols)
    S = hist.splits(split_cols or C, R)[0]
    k = max(-(-nbins // SLICE_MAX_BINS), S) if S <= CLUSTER_MAX \
        else CLUSTER_MAX
    return hist._plan(k, S, hist._round4(-(-nbins // k)), "spread")


@pytest.mark.parametrize("kind", [None, "spread"])
@pytest.mark.parametrize("nbins", EDGES)
@pytest.mark.parametrize("R", [4096, 65536, 1048576])
@pytest.mark.parametrize("C", [1, 2, 33, 200, 528, 2048])
def test_plan_fits_covers_and_keeps_the_partition(C, R, nbins, kind):
    plan = plan_of(C, R, nbins, kind=kind)
    S, rows = hist.splits(C, R)
    copy = -(-nbins // (2 if rows < 1 << 16 else 1))
    k_spread = max(-(-nbins // SLICE_MAX_BINS), S)
    if kind is None and copy > SLICE_MAX_BINS \
            and k_spread > hist.SPREAD_MAX:
        assert plan is None                 # the device-memory body
        return
    assert plan.splits == S
    assert 1 <= plan.cluster <= CLUSTER_MAX
    assert plan.splits_pad % plan.cluster == 0
    assert S <= plan.splits_pad < S + plan.cluster
    if S <= CLUSTER_MAX:
        assert plan.splits_pad == plan.cluster      # one cluster a column
    assert plan.flush == ("store" if plan.splits_pad == plan.cluster
                          else "atomic")
    # the block's words and the MAD tree fit its opt-in shared memory
    assert plan.words % 4 == 0
    assert plan.words * 4 + DEV_TREE <= SMEM_OPTIN
    if kind is None:
        private = plan.layout.startswith("private")
        fits = -(-nbins // (2 if rows < 1 << 16 else 1)) \
            <= SLICE_MAX_BINS
        assert private == fits
        if private:
            assert plan.cluster == min(S, CLUSTER_MAX)
            # 16-bit counters only where no count can pass 65,535
            assert (plan.layout == "private16") == (rows < 1 << 16)
        else:
            assert plan.layout == "spread"
            assert plan.cluster == k_spread <= hist.SPREAD_MAX
    else:
        assert plan.layout == kind
    if not plan.layout.startswith("private"):
        assert plan.words * plan.cluster >= nbins
    if nbins > 70000:
        return          # the map below is checked in full up to 65,536
    # every bin is counted in one word, and the flush writes it once
    b = np.arange(nbins)
    rank, word, inc = counted_at(b, plan, nbins)
    assert word.min() >= 0 and word.max() < plan.words
    if plan.layout.startswith("private"):
        assert len(np.unique(word * 2 + (inc > 1))) == nbins
    else:
        assert rank.min() >= 0 and rank.max() < plan.cluster
        assert len(np.unique(rank * plan.words + word)) == nbins
    written = sorted(x for bins in flushed(plan, nbins).values()
                     for x in bins)
    assert written == list(range(nbins))


def test_private_plan_none_where_no_copy_fits():
    """65,536 32-bit counters (a split of 65,536 rows) pass a block's
    words, so that batch spreads; 16-bit ones fit."""
    assert hist._private_plan(1, 65536, 65536) is None
    assert hist.cluster_plan(2048, 65536, 65536).layout == "spread"
    assert hist._private_plan(3, 21846, 65536).layout == "private16"
    assert hist.cluster_plan(200, 65536, 65536).layout == "private16"


@pytest.mark.parametrize("C,R,nbins,want", [
    (200, 65536, 131072, (3, "spread")), (2048, 65536, 65536, (2, "spread")),
    (2048, 65536, 131072, (3, "spread")), (200, 65536, 173569, None),
    (64, 65536, 131072, None), (1, 65536, 115713, None),
    (1, 1048576, 131072, None)])
def test_spread_only_up_to_spread_max(C, R, nbins, want):
    """Past the private copies the plan spreads a histogram over at most
    ``hist.SPREAD_MAX`` blocks (one cluster a column, stored once); where
    that needs more blocks the device-memory body counts (it measured
    faster there)."""
    plan = hist.cluster_plan(C, R, nbins)
    if want is None:
        assert plan is None
    else:
        assert (plan.cluster, plan.layout, plan.flush) == want + ("store",)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_probe_times_the_modelled_plans():
    """``chip_smoke.py``'s forced plans (the probe's spread at any size,
    the kinds its checks force) are the plans this file models."""
    cs = _chip_smoke()
    for C, R, nbins in cs.K2_BODY_SHAPES:
        assert cs.k2_spread_any(hist, C, R, nbins) == plan_of(
            C, R, nbins, kind="spread")
    kinds = cs.k2_kinds(hist, 200, 65536, 16384)
    assert list(kinds) == ["private16", "private32", "spread"]
    assert kinds["private16"] == hist.cluster_plan(200, 65536, 16384)
    assert kinds["spread"] == plan_of(200, 65536, 16384, kind="spread")
    assert list(cs.k2_kinds(hist, 200, 65536, 65536)) == ["private16",
                                                          "spread"]


def test_split_cols_plans_on_the_tables_partition():
    """A re-bin of 3 of 200 columns plans on the table's row partition,
    so its MAD bits are the full width's."""
    plan = hist.cluster_plan(3, 65536, 16384, split_cols=200)
    assert plan.splits == hist.splits(200, 65536)[0]
    assert hist.cluster_plan(3, 65536, 16384).splits == hist.splits(
        3, 65536)[0]


# --- the numpy model of the body -------------------------------------------

def _device_scale(lo, hi, nbins):
    """hist.cuh bin_scale."""
    with np.errstate(all="ignore"):
        width = (hi - lo).astype(F32)
        width = np.where(np.isnan(width), width,
                         np.maximum(width, F32(1e-30))).astype(F32)
        return (F32(nbins) / width).astype(F32)


def _bin_of(x, lo, scale, nbins):
    """hist.cuh bin_of: t = (x - lo) * scale, floor, NaN to bin 0,
    clipped."""
    with np.errstate(invalid="ignore", over="ignore"):
        b = np.floor(((x - lo) * scale).astype(F32))
    return np.clip(np.nan_to_num(b, nan=0.0), 0, nbins - 1).astype(np.int64)


def cluster_model(x, rv, lo, hi, nbins, plan, split_cols=None):
    """The body's counts (C, nbins): per column, per cluster, the K blocks'
    words zeroed, each working block's rows added where the layout puts
    them (a padding block adds none), then the flush.  A sentinel stands
    for the wrapper's ``torch.empty``: a store flush must write every
    bin."""
    C, R = x.shape
    rows = hist.splits(split_cols or C, R)[1]
    K = plan.cluster
    private = plan.layout.startswith("private")
    if plan.flush == "store":
        out = np.full((C, nbins), -7, dtype=np.int64)   # never read
    else:
        out = np.zeros((C, nbins), dtype=np.int64)
    scale = _device_scale(lo, hi, nbins)
    where = flushed(plan, nbins)
    for c in range(C):
        for first in range(0, plan.splits_pad, K):
            sm = np.zeros((K, plan.words), dtype=np.int64)
            for s in range(first, first + K):
                if s >= plan.splits:
                    continue                # a padding block: no rows
                r = np.arange(s * rows, min(R, (s + 1) * rows))
                ok = rv[r] & np.isfinite(x[c, r])
                b = _bin_of(x[c, r[ok]], lo[c], scale[c], nbins)
                rank, word, inc = counted_at(b, plan, nbins)
                if private:
                    np.add.at(sm[s - first], word, inc)
                    # a 16-bit counter never passes 65,535
                    assert plan.layout == "private32" or (
                        (sm[s - first] & 0xFFFF).max() < 1 << 16 and
                        (sm[s - first] >> 16).max() < 1 << 16)
                else:
                    np.add.at(sm, (rank, word), inc)
            if private:
                total = sm.sum(0)
                lo16 = (sm & 0xFFFF).sum(0)
                hi16 = (sm >> 16).sum(0)
            for (k, w), bins in where.items():
                for b in bins:
                    if not private:
                        v = sm[k, w]
                    elif plan.layout == "private32":
                        v = total[w]
                    else:
                        v = hi16[w] if b & 1 else lo16[w]
                    if plan.flush == "store":
                        out[c, b] = v
                    else:
                        out[c, b] += v
    return out


def _adversarial(C, R, seed, kind):
    """NaN, +-inf, denormal lanes, a constant and an all-NaN column,
    invalid tail rows; ``one-bin``: hi moved out so every value of every
    column lands in bin 0; ``edges``: values on the bin edges."""
    rng = np.random.default_rng(seed)
    x = rng.normal(10.0, 3.0, (C, R)).astype(F32)
    x[rng.random((C, R)) < 0.05] = np.nan
    x[rng.random((C, R)) < 0.02] = np.inf
    x[rng.random((C, R)) < 0.02] = -np.inf
    x[rng.random((C, R)) < 0.02] = F32(3e-41)
    if C > 2:
        x[1] = 4.25
        x[2] = np.nan
    rv = np.ones(R, dtype=bool)
    rv[-R // 8:] = False
    fin = rv[None, :] & np.isfinite(x)
    with np.errstate(all="ignore"):
        lo = np.where(fin.any(1), np.where(fin, x, np.inf).min(1), 0)
        hi = np.where(fin.any(1), np.where(fin, x, -np.inf).max(1), 0)
        mean = np.where(fin, x, 0).astype(np.float64).sum(1) \
            / np.maximum(fin.sum(1), 1)
    lo, hi, mean = lo.astype(F32), hi.astype(F32), mean.astype(F32)
    if kind == "one-bin":
        hi = (lo + (hi - lo) * F32(1e6)).astype(F32)
    elif kind == "one-top":
        lo = (hi - (hi - lo) * F32(1e7)).astype(F32)
    elif kind == "edges":
        nb = 9000
        edges = lo[:, None] + (hi - lo)[:, None] * (
            rng.integers(0, nb, (C, 64)) / nb)
        pos = rng.integers(0, R, (C, 64))
        x[np.arange(C)[:, None], pos] = edges.astype(F32)
    return x, rv, lo, hi, mean


# (C, R, nbins, split_cols): one cluster of S = 5 blocks, at an even and
# an odd bin count; S = 16 (C = 1); two clusters of 16 a column (R past
# 65,536 with few columns: atomic flush); a re-bin of 2 columns on a
# 2,048-column table's partition (one split of 65,536 rows: 32-bit
# counters)
MODEL_CASES = [(9, 20000, 9000, None), (9, 20000, 9001, None),
               (1, 65536, 16384, None), (2, 131072, 12000, None),
               (2, 65536, 16384, 2048)]


@pytest.mark.parametrize("kind", ["adversarial", "one-bin", "one-top",
                                  "edges"])
@pytest.mark.parametrize("plan_kind", [None, "spread"])
@pytest.mark.parametrize("C,R,nbins,split_cols", MODEL_CASES)
def test_cluster_model_counts_equal_plain(C, R, nbins, split_cols,
                                          plan_kind, kind):
    x, rv, lo, hi, mean = _adversarial(C, R, seed=C * 7 + nbins, kind=kind)
    plan = plan_of(C, R, nbins, split_cols, kind=plan_kind)
    got = cluster_model(x, rv, lo, hi, nbins, plan, split_cols)
    want, _ = hist.histogram_plain(*(torch.from_numpy(np.ascontiguousarray(a))
                                     for a in (x, rv, lo, hi, mean)), nbins)
    np.testing.assert_array_equal(got, want.numpy())
    if kind == "one-bin":
        assert (got[:, 1:] == 0).all()
    if kind == "one-top":
        # a constant column's width is 0: its values stay in bin 0
        spread = np.isfinite(hi - lo) & (hi > lo)
        assert spread.sum() > 0 and (got[spread, :-1] == 0).all()
    if (C, R) == (2, 131072):
        assert plan.flush == "atomic" and plan.splits_pad > plan.cluster
    else:
        assert plan.flush == "store"
    if plan_kind is None:
        assert plan.layout == ("private32" if split_cols else "private16")
