"""The rank search of kernels K5 and K6 (``csrc/grid_rank.cuh``) modelled
in numpy on the CPU, step for step, against the JAX reference.

The kernels need the card.  What their search computes is fixed here:

* the grid staged in heap (Eytzinger) order, padded with +inf to
  2^MAX_LOG - 1 points, MAX_LOG = ceil(log2(MAX_GRID + 1)) for every G;
* the lower bound lt = #(g < x): MAX_LOG branch-free steps
  k = 2k + (e[k] < x) from k = 1, then lt = k - 2^MAX_LOG, keeping the
  last point at which the descent went left (x's successor g[lt]);
* the tie check: g[lt] <= x (with lt < G) is the only case that counts
  further, by a gallop over the sorted grid from lt and a binary
  refinement of its last step;
* rank = (lt + le) * float32(0.5 / G), NaN where the row is invalid or x
  not finite.

The model is held bit for bit against the port's plain version and the
reference's ``_rank_tiles(..., interpret=True)`` (whose CPU compares take
a denormal as zero: the model is given the same flushed inputs there), and
its counts against the dense compare for every x (NaN and +-inf too), on grids
with tie runs at the start, the middle and the end, all-equal grids, +inf
pads, signed zeros and denormals, for G in {1, 2, 16, 100, 255, 256}.  A
value that ties no grid point takes exactly MAX_LOG reads: one search.  The
constants come from ``grid_rank.cuh`` itself, so the model follows the
kernel's source.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuprof.kernels import fused as ref_fused
from tpuprof_torch.config import MAX_SPEAR_GRID
from tpuprof_torch.kernels import fused

GRID_RANK_CUH = Path(fused.__file__).parent / "csrc" / "grid_rank.cuh"
GRIDS = (1, 2, 16, 100, 255, 256)
F32 = np.float32


def _cuh_constant(name: str) -> int:
    """``constexpr int <name> = <value>;`` in grid_rank.cuh."""
    m = re.search(rf"constexpr int {name} = (\d+);",
                  GRID_RANK_CUH.read_text())
    assert m, f"{name} not in {GRID_RANK_CUH}"
    return int(m.group(1))


MAX_GRID, MAX_LOG = _cuh_constant("MAX_GRID"), _cuh_constant("MAX_LOG")


def heap_order(g: np.ndarray, log: int) -> np.ndarray:
    """The grid row in heap order, words 1 .. 2^log - 1 (word 0 unused):
    node k at depth d holds sorted point (2 (k - 2^d) + 1) 2^(log-d-1) - 1,
    +inf past G."""
    G = len(g)
    eyt = np.full(1 << log, np.inf, dtype=F32)
    for k in range(1, 1 << log):
        d = k.bit_length() - 1
        i = (2 * (k - (1 << d)) + 1) * (1 << (log - d - 1)) - 1
        eyt[k] = g[i] if i < G else np.inf
    return eyt


def tie_count(s: np.ndarray, lt: int, x: F32):
    """``tie_count``: (le, reads) for a value whose successor s[lt] is x."""
    G = len(s)
    le, step, reads = lt + 1, 1, 0
    while le + step - 1 < G:
        reads += 1
        if not s[le + step - 1] <= x:
            break
        le += step
        step <<= 1
    step >>= 1
    while step > 0:
        if le + step - 1 < G:
            reads += 1
            if s[le + step - 1] <= x:
                le += step
        step >>= 1
    return le, reads


def search(g: np.ndarray, x: np.ndarray):
    """(lt, le, reads) for every value of ``x`` against grid row ``g``,
    as ``rank_rows`` runs them."""
    G = len(g)
    log = MAX_LOG
    eyt = heap_order(g, log)
    k = np.ones(x.shape, dtype=np.int64)
    succ = np.full(x.shape, np.inf, dtype=F32)
    with np.errstate(invalid="ignore"):
        for _ in range(log):
            e = eyt[k]
            below = e < x
            succ = np.where(below, succ, e)
            k = 2 * k + below
        lt = k - (1 << log)
        tie = (lt < G) & (succ <= x)
    le = lt.copy()
    reads = np.full(x.shape, log)
    for j in np.flatnonzero(tie):
        le[j], extra = tie_count(g, int(lt[j]), x[j])
        reads[j] += extra
    return lt, le, reads, tie


def model_ranks(xt, rv, grid):
    """K6's output by the model: (ranks, reads, ties)."""
    c = F32(fused._rank_scale(grid.shape[1]))
    out = np.empty_like(xt)
    reads = np.empty(xt.shape, dtype=np.int64)
    ties = np.empty(xt.shape, dtype=bool)
    for col in range(xt.shape[0]):
        lt, le, reads[col], ties[col] = search(grid[col], xt[col])
        rank = (lt + le).astype(F32) * c
        ok = rv & np.isfinite(xt[col])
        out[col] = np.where(ok, rank, F32(np.nan))
    return out, reads, ties


def grids(G: int, seed: int) -> np.ndarray:
    """(8, G) nondecreasing rows: a random one, tie runs at the start, in
    the middle and at the end, all equal, +inf pads, three values in long
    runs, signed zeros and denormals."""
    rng = np.random.default_rng(seed)

    def rand(n):
        return np.sort(rng.normal(0.0, 3.0, n).astype(F32))

    run = max(G // 3, 1)
    rows = [rand(G)]
    g = rand(G)
    g[:run] = g[0]
    rows.append(g)                                  # ties at the start
    g = rand(G)
    mid = G // 2
    g[mid:mid + run] = g[mid]
    rows.append(np.sort(g))                         # ties in the middle
    g = rand(G)
    g[G - run:] = g[G - 1]
    rows.append(g)                                  # ties at the end
    rows.append(np.full(G, F32(7.0)))               # all equal
    g = rand(G)
    g[G - max(G // 4, 1):] = np.inf
    rows.append(g)                                  # +inf pads
    rows.append(np.sort(rng.choice(np.array([-1.0, 0.5, 2.0], dtype=F32),
                                   G)))             # three values
    g = np.sort(np.concatenate([
        np.array([-0.0, 0.0, 1e-45, -1e-45, 1e-40, -1e-40], dtype=F32),
        rand(G)])[:G])
    rows.append(np.sort(g, kind="stable"))          # zeros and denormals
    return np.stack(rows).astype(F32)


def values(grid: np.ndarray, R: int, seed: int):
    """(xt (C, R), row_valid (R,)): every grid point and its float32
    neighbours, NaN, +-inf, +-0, denormals, then normals."""
    rng = np.random.default_rng(seed)
    special = np.array([np.nan, np.inf, -np.inf, 0.0, -0.0, 1e-45, -1e-45,
                        1e-40, -1e-40, 7.0, -1.0, 0.5, 2.0], dtype=F32)
    xt = rng.normal(0.0, 4.0, (grid.shape[0], R)).astype(F32)
    for col, g in enumerate(grid):
        fin = g[np.isfinite(g)]
        picks = np.concatenate([
            special, g, np.nextafter(fin, F32(np.inf)),
            np.nextafter(fin, F32(-np.inf))]).astype(F32)
        xt[col, :len(picks)] = picks[:R]
    rv = rng.random(R) > 0.1
    rv[:len(special)] = True
    return xt, rv


def _inputs(G: int):
    grid = grids(G, seed=G)
    R = 3 * G + 64
    xt, rv = values(grid, R, seed=G + 1)
    return xt, rv, grid


def test_constants_are_the_config_and_the_descent_depth():
    assert MAX_GRID == MAX_SPEAR_GRID
    # one descent depth, ceil(log2(MAX_GRID + 1)), serves every G
    assert (1 << (MAX_LOG - 1)) <= MAX_GRID < (1 << MAX_LOG)
    assert all(1 <= G <= MAX_GRID for G in GRIDS)


def flush_denormals(a: np.ndarray) -> np.ndarray:
    """Denormals as signed zeros: XLA on the CPU compares a denormal as
    zero (ROADMAP Queue 3), so that is what the reference's interpret-mode
    kernel sees."""
    return np.where(np.abs(a) < np.finfo(F32).tiny,
                    np.copysign(F32(0.0), a), a)


@pytest.mark.parametrize("G", GRIDS)
def test_model_is_the_reference_rank_bit_for_bit(G):
    xt, rv, grid = _inputs(G)
    ref = np.asarray(ref_fused._rank_tiles(
        jnp.asarray(xt), jnp.asarray(rv), jnp.asarray(grid),
        interpret=True))
    flushed, _, _ = model_ranks(flush_denormals(xt), rv,
                                flush_denormals(grid))
    np.testing.assert_array_equal(flushed.view(np.int32),
                                  ref.view(np.int32))
    # IEEE compares: the port's plain version (the card's oracle), and the
    # reference wherever no denormal meets a zero or another denormal
    got, _, ties = model_ranks(xt, rv, grid)
    plain = fused.rank_transform_plain(
        torch.from_numpy(xt), torch.from_numpy(rv), torch.from_numpy(grid))
    np.testing.assert_array_equal(got.view(np.int32),
                                  plain.numpy().view(np.int32))
    np.testing.assert_array_equal(got[:-1].view(np.int32),
                                  ref[:-1].view(np.int32))
    assert ties.any()                   # the tie count ran


@pytest.mark.parametrize("G", GRIDS)
def test_model_counts_are_the_dense_compare_for_every_value(G):
    """Also where the kernel masks the rank (NaN, +-inf, invalid rows):
    the search itself is exact for any x."""
    xt, _, grid = _inputs(G)
    for col in range(grid.shape[0]):
        g, x = grid[col], xt[col]
        lt, le, _, _ = search(g, x)
        with np.errstate(invalid="ignore"):
            np.testing.assert_array_equal(lt, (g[None, :] < x[:, None])
                                          .sum(1))
            np.testing.assert_array_equal(le, (g[None, :] <= x[:, None])
                                          .sum(1))


@pytest.mark.parametrize("G", GRIDS)
def test_a_value_that_ties_no_point_takes_one_search(G):
    xt, rv, grid = _inputs(G)
    _, reads, ties = model_ranks(xt, rv, grid)
    log = MAX_LOG
    assert (reads[~ties] == log).all()
    # a tie run of n points costs about 2 log2(n) more reads, never a
    # scan of the run
    assert reads.max() <= log + 2 * log + 1
