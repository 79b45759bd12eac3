"""The card's published peaks and the least time each pass's function
could take at them.

The work is counted from shapes alone: pass A is the moments and the
pairwise-complete Pearson Gram of C float32 columns over R rows, pass B
the histogram counts and the MAD, the fused pass both.  The count does
not depend on which kernel, route or library computes the function, so a
change that replaces a kernel is read against the same work.  Each input
byte is read once and each output byte written once.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates without sparsity, at 700 W
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
TF32_FLOPS = 495e12
BF16_FLOPS = 989e12
INT8_OPS = 1979e12


def bytes_ms(nbytes: float) -> float:
    """Milliseconds to move ``nbytes`` at the HBM rate."""
    return 1e3 * nbytes / HBM_BYTES_PER_S


def gram_bound(nbytes: float, C: int, R: int, d_parts: int = 3,
               d2_parts: int = 3) -> float:
    """The least milliseconds of a function whose work is the Gram of C
    columns over R rows and which moves ``nbytes``.

    Each product is taken at the card's rate for the cheapest type that
    computes it to float32 accuracy: P = d d^T (one triangle) in
    ``d_parts``^2 bf16 passes or 3 TF32 passes, whichever is cheaper; S1
    and S2 in ``d_parts`` and ``d2_parts`` bf16 passes (m is 0 or 1,
    exact in bf16); N = m m^T in one int8 pass.  Three bf16 terms hold any
    float32 value."""
    tri = C * (C + 1) * R
    t_ops = (min(d_parts ** 2 * tri / BF16_FLOPS, 3 * tri / TF32_FLOPS)
             + 2 * (d_parts + d2_parts) * C * C * R / BF16_FLOPS
             + tri / INT8_OPS)
    return max(1e3 * t_ops, bytes_ms(nbytes))


def pass_a_bytes(C: int, R: int) -> int:
    """Pass A's bytes: the (C, R) float32 values and R row flags read,
    the C shifts read, the (C, 8) sums and counts and the four (C, C)
    Gram matrices written."""
    return C * R * 4 + R + C * 4 + C * 8 * 8 + 4 * C * C * 4


def pass_b_bytes(C: int, R: int, nbins: int) -> int:
    """Pass B's bytes: values and row flags read, lo, hi and mean read,
    the (C, nbins) counts and the C absolute-deviation sums written."""
    return C * R * 4 + R + 3 * C * 4 + C * nbins * 4 + C * 4


def pass_a_bound(C: int, R: int) -> float:
    """The least milliseconds of pass A over C columns and R rows."""
    return gram_bound(pass_a_bytes(C, R), C, R)


def pass_b_bound(C: int, R: int, nbins: int) -> float:
    """The least milliseconds of pass B: its bytes, or 8 float32
    operations a value, whichever takes longer."""
    return max(bytes_ms(pass_b_bytes(C, R, nbins)),
               1e3 * 8 * C * R / F32_FLOPS)


def pass_ab_bound(C: int, R: int, nbins: int) -> float:
    """The least milliseconds of the fused pass: pass A's Gram over the
    union of both passes' bytes (the shifts, lo, hi and mean read once
    each); the bin compares are not counted."""
    nbytes = (C * R * 4 + R + 4 * C * 4 + C * 8 * 8 + 4 * C * C * 4
              + C * nbins * 4 + C * 4)
    return gram_bound(nbytes, C, R)
