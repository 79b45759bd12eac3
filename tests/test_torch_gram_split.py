"""The arithmetic of the tensor-core Gram (``csrc/gram.cuh::gram_tc``, run
by kernels K1, K3, K4 and K5) modelled in torch on the CPU.

The kernel itself needs the card.  What it computes is fixed here:

* TF32 ``cvt.rna`` rounding (round to nearest, ties away from zero, to 10
  mantissa bits), done by bit operations on an int32 view;
* the split v = hi + lo of d and d^2, with hi truncated where rounding
  carries a finite v past the largest TF32 value and lo = 0 where v is
  not finite;
* the passes: P = lo*hi + hi*lo + hi*hi (3), S1 = d m^T and S2 = d^2 m^T
  (2 each: m is exact in TF32), N = m m^T (1, exact);
* float32 promotion: each block of ``PROMOTE_ROWS`` rows is summed apart
  (here exactly, in float64, then rounded once to float32, the best the
  tensor cores' accumulation can do) and added to a float32 sum.

The model is held against a float64 Gram of the same float32 operands,
within the split's error bound, and its rho against the reference's
``_fused_tiles(..., interpret=True)`` at the reference's tolerance (atol
5e-4), on ``chip_smoke.py``-style adversarial batches and on columns at
+-1e20 and 3e38.  The row partition the kernel runs on is checked here
too: one block per pair of tiles of the upper triangle, one partition a
width for K1, K3 and K5 (the Spearman Gram over its ranks) up to 512
columns.

The model's tile, chunk and promotion constants are read from
``gram.cuh`` itself, so the model follows the kernel's source.
"""

import contextlib
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuprof.kernels import corr as ref_corr
from tpuprof.kernels import fused as ref_fused
from tpuprof_torch.kernels import corr, fused

GRAM_CUH = Path(fused.__file__).parent / "csrc" / "gram.cuh"


def _cuh_constant(name: str) -> int:
    """``constexpr int <name> = <value>;`` in gram.cuh."""
    m = re.search(rf"constexpr int {name} = (\d+);", GRAM_CUH.read_text())
    assert m, f"{name} not in {GRAM_CUH}"
    return int(m.group(1))


TC_TILE, TC_ROWS = _cuh_constant("TC_TILE"), _cuh_constant("TC_ROWS")
PROMOTE_ROWS = _cuh_constant("TC_PROMOTE") * TC_ROWS
F32_MAX = float(np.finfo(np.float32).max)


def tf32_rna(v: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32``: add half a TF32 ulp to the magnitude bits,
    clear the 13 low bits (a finite value past the largest TF32 value
    becomes inf, as in the instruction)."""
    u = v.contiguous().view(torch.int32).to(torch.int64)
    r = ((u + 0x1000) & ~0x1FFF) & 0xFFFFFFFF
    r = torch.where(r >= 1 << 31, r - (1 << 32), r).to(torch.int32)
    return torch.where(torch.isnan(v), v, r.view(torch.float32))


def _truncate(v: torch.Tensor) -> torch.Tensor:
    return (v.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def tf32_split(v: torch.Tensor):
    """(hi, lo), both TF32, as ``gram.cuh::tf32_split``."""
    hi = tf32_rna(v)
    hi = torch.where(torch.isinf(hi) & ~torch.isinf(v), _truncate(v), hi)
    r = v - hi
    lo = torch.where(torch.isfinite(r), tf32_rna(r),
                     torch.zeros((), dtype=torch.float32))
    return hi, lo


def operands(xt: torch.Tensor, rv: torch.Tensor, shift: torch.Tensor):
    """d (float32, 0 where the row is invalid or x not finite) and m."""
    fin = rv[None, :] & torch.isfinite(xt)
    return torch.where(fin, xt - shift[:, None], 0.0), fin.to(torch.float32)


def gram_3xtf32(d: torch.Tensor, m: torch.Tensor,
                promote_rows: int = PROMOTE_ROWS):
    """(P, S1, S2, N) as the kernel forms them."""
    dh, dl = tf32_split(d)
    qh, ql = tf32_split(d * d)
    C, R = d.shape
    f32 = torch.float32
    P, S1, S2 = (torch.zeros((C, C), dtype=f32) for _ in range(3))

    def block(passes, sl):
        # TF32 x TF32 products are exact in float64; one rounding a block
        acc = torch.zeros((C, C), dtype=torch.float64)
        with np.errstate(invalid="ignore", over="ignore"):
            for a, b in passes:
                acc = acc + a[:, sl].double() @ b[:, sl].double().T
        return acc.to(f32)

    for r0 in range(0, R, promote_rows):
        sl = slice(r0, r0 + promote_rows)
        P = P + block(((dl, dh), (dh, dl), (dh, dh)), sl)
        S1 = S1 + block(((dl, m), (dh, m)), sl)
        S2 = S2 + block(((ql, m), (qh, m)), sl)
    N = torch.round(m.double() @ m.double().T).to(torch.int32)
    return P, S1, S2, N


def gram_f64(d: torch.Tensor, m: torch.Tensor):
    """(P, S1, S2) in float64 from the same float32 d, d^2, m, and the
    scale of each entry, sum_r |a_r b_r|."""
    d64, m64, q64 = d.double(), m.double(), (d * d).double()
    with np.errstate(invalid="ignore", over="ignore"):
        exact = (d64 @ d64.T, d64 @ m64.T, q64 @ m64.T)
        scale = (d64.abs() @ d64.abs().T, d64.abs() @ m64.T,
                 q64.abs() @ m64.T)
    return exact, scale


def scaled_error(got, exact, scale) -> float:
    """max |G - G64| / sum |a b| over the entries finite in both."""
    g = got.double()
    ok = torch.isfinite(g) & torch.isfinite(exact) & (scale > 0)
    if not ok.any():
        return 0.0
    return float(((g - exact).abs() / scale)[ok].max())


def split_bound(R: int, promote_rows: int = PROMOTE_ROWS) -> float:
    """The model's scaled error bound: the dropped lo*lo and the rounding
    of lo cost at most 3 * 2^-22 of each |a b|, and each of the
    ceil(R / promote_rows) blocks plus its float32 addition one float32
    rounding (2^-24) of the running sum."""
    return 3 * 2.0 ** -22 + 2 * (-(-R // promote_rows) + 1) * 2.0 ** -24


def adversarial(C: int, R: int, seed: int):
    """``chip_smoke.py``'s adversarial batch: NaN, +-inf, zeros,
    denormals, a constant and an all-NaN column, invalid tail rows."""
    rng = np.random.default_rng(seed)
    x = rng.normal(50.0, 10.0, (C, R)).astype(np.float32)
    x[rng.random((C, R)) < 0.07] = np.nan
    x[rng.random((C, R)) < 0.01] = np.inf
    x[rng.random((C, R)) < 0.01] = -np.inf
    x[rng.random((C, R)) < 0.03] = 0.0
    x[rng.random((C, R)) < 0.01] = np.float32(1e-40)
    if C > 2:
        x[1] = 7.0
        x[2] = np.nan
    rv = np.ones(R, dtype=bool)
    rv[-max(R // 10, 1):] = False
    return x, rv


def finite_shift(x: np.ndarray) -> np.ndarray:
    prefix = x[:, :4096]
    fin = np.isfinite(prefix)
    return (np.where(fin, prefix, 0.0).sum(1)
            / np.maximum(fin.sum(1), 1)).astype(np.float32)


def extremes(R: int, seed: int):
    """Columns at +-1e20 (so d^2 overflows), between 3e38 and the float32
    maximum with shift 0 (the split near the largest TF32 value), a small
    partner column (finite products with the large ones), a column whose
    mean is far above its spread, and two ordinary ones."""
    rng = np.random.default_rng(seed)
    x = np.empty((7, R), dtype=np.float32)
    x[0] = np.float32(1e20) * rng.choice([-1.0, 1.0], R)
    x[1] = rng.uniform(3e38, F32_MAX, R).astype(np.float32)
    x[1, :4] = [F32_MAX, -F32_MAX, np.float32(3e38), np.float32(3.4e38)]
    x[2] = rng.normal(0.0, 1e-3, R)
    x[3] = 1e6 + rng.normal(0.0, 1e-1, R)
    x[4:] = rng.normal(5.0, 2.0, (3, R))
    x[4, rng.random(R) < 0.05] = np.nan
    rv = np.ones(R, dtype=bool)
    rv[-3:] = False
    with np.errstate(over="ignore"):      # column 1's mean overflows
        shift = finite_shift(x)
    shift[:3] = 0.0
    return x, rv, shift


@pytest.mark.parametrize("value", [
    0.0, -0.0, 1.0, -1.5, 1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -11,
    -(1.0 + 2.0 ** -11), 3.0e38, 3.4e38, F32_MAX, -F32_MAX, 1e-40,
    np.pi, 1e20, -1e-30])
def test_split_is_exact_to_its_bound(value):
    v = torch.tensor([value], dtype=torch.float32)
    hi, lo = tf32_split(v)
    for part in (hi, lo):
        assert int(part.view(torch.int32)) & 0x1FFF == 0   # TF32 values
    assert torch.isfinite(hi).all() and torch.isfinite(lo).all()
    x = float(v)
    # relative below 2^-22; among denormals TF32's grid is 2^-136 apart
    assert abs(float(hi.double() + lo.double()) - x) \
        <= max(2.0 ** -22 * abs(x), 2.0 ** -137)
    if 2.0 ** -126 <= abs(x) <= 3.0e38:
        assert abs(float(hi) - x) <= 2.0 ** -11 * abs(x)


def test_rna_rounds_ties_away_from_zero():
    half = 2.0 ** -11                       # half a TF32 ulp at 1.0
    v = torch.tensor([1.0 + half, -(1.0 + half), 1.0 + 3 * half,
                      1.0 + half - 2.0 ** -23], dtype=torch.float32)
    want = [1.0 + 2 * half, -(1.0 + 2 * half), 1.0 + 4 * half, 1.0]
    assert tf32_rna(v).tolist() == want


def test_non_finite_values_split_to_themselves_and_zero():
    v = torch.tensor([np.inf, -np.inf, np.nan], dtype=torch.float32)
    hi, lo = tf32_split(v)
    assert torch.isinf(hi[:2]).all() and torch.isnan(hi[2])
    assert (lo == 0).all()


def _check_against_f64_and_reference(x, rv, shift):
    xt, rvt, sh = (torch.from_numpy(a) for a in (x, rv, shift))
    d, m = operands(xt, rvt, sh)
    got = gram_3xtf32(d, m)
    plain = fused._gram_plain(d, m)
    exact, scale = gram_f64(d, m)
    bound = split_bound(x.shape[1])
    for name, g, p, e, s in zip(("P", "S1", "S2"), got, plain, exact,
                                scale):
        # non-finite exactly where float32's own Gram is
        assert torch.equal(torch.isfinite(g), torch.isfinite(p)), name
        assert scaled_error(g, e, s) <= bound, name
    assert torch.equal(got[3], plain[3])

    ref = ref_fused._fused_tiles(jnp.asarray(x), jnp.asarray(rv),
                                 jnp.asarray(shift), interpret=True)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(ref[5]))
    C = x.shape[0]
    co = corr.init(C, "cpu")
    co["shift"] = sh
    co["set"].fill_(1)
    rho = corr.finalize(fused._fold_corr(co, *got))
    rco = ref_corr.init(C)
    rco["shift"] = jnp.asarray(shift)
    rco["set"] = jnp.ones((), dtype=jnp.int32)
    rco = ref_fused._fold_corr(rco, *ref[2:])
    np.testing.assert_allclose(rho, ref_corr.finalize(rco), rtol=0,
                               atol=5e-4, equal_nan=True)
    # against float64 wherever float32 did not overflow
    e64 = corr.finalize({"N": got[3], "S1": exact[1], "S2": exact[2],
                         "P": exact[0]})
    both = np.isfinite(rho) & np.isfinite(e64)
    assert both.sum() >= C
    np.testing.assert_allclose(rho[both], e64[both], rtol=0, atol=5e-4)


@pytest.mark.parametrize("C,R,seed", [(5, 3000, 0), (13, 4100, 1),
                                      (70, 1000, 2)])
def test_model_on_adversarial_batches(C, R, seed):
    x, rv = adversarial(C, R, seed)
    _check_against_f64_and_reference(x, rv, finite_shift(x))


@pytest.mark.parametrize("seed", [3, 4])
def test_model_on_extreme_columns(seed):
    _check_against_f64_and_reference(*extremes(4096, seed))


def test_all_positive_pair_over_a_batch_stays_in_bound():
    """The S2 drift case: 65,536 all-positive rows of two columns."""
    rng = np.random.default_rng(9)
    x = rng.uniform(1.0, 2.0, (2, 65536)).astype(np.float32)
    d, m = operands(torch.from_numpy(x), torch.ones(65536, dtype=torch.bool),
                    torch.zeros(2))
    got = gram_3xtf32(d, m)
    exact, scale = gram_f64(d, m)
    for g, e, s in zip(got[:3], exact, scale):
        assert scaled_error(g, e, s) <= split_bound(65536)


@pytest.mark.parametrize("C,R,pairs,gram_s,gram_rows", [
    (200, 65536, 10, 52, 1280),      # the headline batch: 520 blocks
    (37, 65536, 1, 512, 128),
    (512, 65536, 36, 14, 4704),
    (2048, 65536, 528, 1, 65536),
    (3, 1000, 1, 32, 32)])
def test_splits_count_triangle_tile_pairs(C, R, pairs, gram_s, gram_rows):
    t = -(-C // TC_TILE)
    assert t * (t + 1) // 2 == pairs
    _, _, got_s, got_rows = fused.splits(C, R, TC_TILE, TC_ROWS)
    assert (got_s, got_rows) == (gram_s, gram_rows)
    assert pairs * got_s <= max(fused._TARGET_BLOCKS, pairs)
    assert got_rows % TC_ROWS == 0


class _RecordingLib:
    """Stands in for the built libraries: the tile constants of gram.cuh,
    and each Gram entry point records the (gram_splits, gram_rows) its
    wrapper hands it."""

    # entry point -> position of gram_splits among its arguments
    GRAM_ARG = {"tpt_fused_a": 7, "tpt_fused_wide": 8, "tpt_spear": 7}

    def __init__(self):
        self.partition = {}

    def tpt_tc_tile(self):
        return TC_TILE

    def tpt_tc_rows(self):
        return TC_ROWS

    def __getattr__(self, name):
        k = self.GRAM_ARG[name]

        def entry(*args):
            self.partition[name] = tuple(args[k:k + 2])
            return 0
        return entry


@pytest.mark.parametrize("C", [37, 200, 512])
def test_k5_runs_k1s_triangle_partition(C, monkeypatch):
    """K5's Gram runs on K1's partition (and K3's at these widths), so K5
    is bit for bit K6 then K3 with skip_stats on the card."""
    lib = _RecordingLib()
    monkeypatch.setattr(fused._k, "library", lambda name, bind: lib)
    monkeypatch.setattr(fused, "_need_cuda", lambda xt, what: None)
    monkeypatch.setattr(fused, "_stream", lambda dev: 0)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    R = 65536
    xt = torch.empty((C, R))
    rv = torch.ones(R, dtype=torch.bool)
    fused.spear_tiles_cuda(xt, rv, torch.zeros((C, 256)))
    fused.tiles_cuda(xt, rv, torch.zeros(C))
    fused.tiles_wide_cuda(xt, rv, torch.zeros(C), skip_stats=True)
    k1 = fused.splits(C, R, TC_TILE, TC_ROWS)[2:]
    assert lib.partition == {"tpt_spear": k1, "tpt_fused_a": k1,
                             "tpt_fused_wide": k1}
