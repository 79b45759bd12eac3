#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``tpuprof_torch``) once on one NVIDIA GPU.

Run from the repository root:

    python3 chip_smoke.py                  # the full check on the card
    python3 chip_smoke.py --only limits,durable   # build + phases 7 and 8
    python3 chip_smoke.py --kernels-only   # build + kernel checks only
    python3 chip_smoke.py --k2-probe       # build + K2's SASS and times
    python3 chip_smoke.py --ingest-only    # build + phase 6 (--seed N)
    python3 chip_smoke.py --cpu-rehearsal  # tiny sizes, plain versions, CPU

``--only`` takes any of kernels, main, cli, ingest, limits, durable
(phases 3 to 8) and k2big (phase 3's check of K2's device-memory body
alone); ``--kernels-only`` and ``--ingest-only`` are its short forms.

Phases, each fatal on failure:

1. the card's name, power limit, torch and CUDA versions;
2. build every kernel from ``tpuprof_torch/kernels/csrc`` with nvcc (one
   process per source, all started together) and print the build time;
3. each kernel against its plain PyTorch version on the same inputs on the
   card (exact counts/min/max/pair counts, bit-identical ranks, moments at
   rtol 5e-4, rho at atol 5e-4): K1 at the bench shape's widths; K2 at
   37, 200, 512 and 2,048 columns x 1, 10, 128 and 8,192 bins, at the
   ``LAYOUTS`` and again with bounds pass A never gives (the scale K2
   forms itself), on a batch whose every value lands in one bin and on a
   re-bin of three of 200 columns, counts exact, its MAD numerator bit for
   bit its order model (``mad_order``) and within rtol 5e-4 of the plain
   version, the re-bin's the full width's bits; K2's device-memory body
   (past 8,192 bins) at 200 x 65,536 with 16,384 and 65,536 bins on the
   adversarial and a clean batch, counts equal to ``histogram_plain``, the
   MAD bits the 10-bin shared body's, timed as the shared body is (events,
   a CUDA graph, the bincount route, its bytes bound); K3
   at 513, 1024 and 2048 columns with and without ``skip_stats``, K5 at
   37, 200 and 512 columns for grids of 16, 100 and 256 points, K6 beside
   each, and K5 bit for bit K6 then K3 with ``skip_stats`` over its ranks
   (the ranks' inputs hold a constant and a three-valued column, so whole
   grids are runs of ties); reruns give identical bits; then the time of
   each kernel at the main path's shapes (K1, K2, K5: 200 float32 columns
   x 65,536 rows; K3, K6: 2,048 columns x 65,536 rows, K3 also at 1,024)
   beside its bound, its plain version's time and one library route's
   time (K2 also its device time alone, from a CUDA graph of 20 calls, at
   10, 128 and 8,192 bins, 2,048 columns and on the one-bin batch, and
   the ``torch.bincount`` route, checked against K2's counts first; K6:
   two ``torch.searchsorted`` and ``torch.where``, checked
   against K6's bits first; K5: that, then the Gram-only
   ``torch.matmul``); K4 at 37, 200 and 512 columns for 1, 10, 100 and
   8192 bins on provisional bounds narrower than the data, bit for bit
   against K1 then K2 and within tolerance of its plain version, timed at
   200 x 65,536 with 10 bins; K1, K3 (513 columns), K4, K5 and K6 (200)
   also at the ``LAYOUTS``: ragged row counts and inputs not 16-byte
   aligned, the Gram's and the rank launch's other load paths;
   K1, K3, K4 and K5 run one Gram on the tensor cores (3xTF32), so each
   has three bounds: the function's (each product at the rate of the
   cheapest type exact to float32, ``bound_ms``; K5's from the bf16 terms
   its run's ranks need, ``bound_bf16_parts_d_d2``), its route's (TF32
   products at 495 TFLOP/s, ``route_bound_ms``) and the float32 one of
   the same work (``bound_f32_ms``); then the float64 phase: K1, K4 and
   K5 (200 columns) and K3 with and without ``skip_stats`` (1,024) at
   65,536 rows on an adversarial batch (also at the ``LAYOUTS``), an
   all-positive one and one of extremes (+-1e20, mean far above spread),
   each Gram's largest error scaled by sum |a b| against float64 beside
   the plain (cuBLAS float32) version's: at most 4x it, the same
   non-finite entries, rho within 5e-4 of float64's;
4. the main path, ``tpuprof_torch.describe(df)`` at its default device,
   each run with the launch counters set to 0 just before and read just
   after: a 200-column x 2,097,152-row float32 table in two passes (K1,
   K2), then single-pass (``profile_passes="fused"``) cold (K4, K2 for
   the missed lanes) and warm from an artifact of the two-pass profile
   (K4 only, every lane a hit), both exactly equal to two-pass; a
   1,000,000-row mixed frame, two-pass and fused; the 200-column table at
   1,048,576 rows with ``spearman=True`` (K1, K2, K5); a 1,024-column x
   131,072-row table two-pass and fused warm (K3 and K2 paired, exactly
   equal); and a 2,048-column x 131,072-row table with ``spearman=True``
   (K3 for pass A and the rank Gram, K2, K6).  Each is held against
   ``describe(..., device="cpu")`` on a cut of its rows (262,144, two-pass
   and fused; the whole mixed frame; 65,536; 8,192 in one batch of its
   size), Spearman included; each run prints the host seconds of its
   phases (``stats["_phases"]``: ``scan_a``, ``merge``, ``scan_b``);
5. the command line on the card: the 200-column table at 1,048,576 rows
   written as a Parquet directory of 4 files with row groups of 65,536,
   profiled by ``tpuprof_torch.cli.main(["profile", ...])`` in process
   with ``--stats-json`` and ``--artifact`` (K1 16 and K2 16 launches;
   the stats equal ``describe(df)`` of the same frame except
   ``memorysize``, which measures the Arrow layout; the HTML is
   ``to_standalone_html`` of its stats), then ``--profile-passes fused
   --seed-edges`` that artifact (K4 only, every lane a hit,
   ``stats_to_json`` equal to the two-pass one); the 1,000,000-row mixed
   frame and a drifted copy (``fare_amount`` moved by one standard
   deviation, the share of one-passenger trips raised to about 1/2) as
   Parquet files with string columns, each profiled by a child ``python
   -m tpuprof_torch profile`` (exit 0, the rows/s line, neither ``jax``
   nor ``tpuprof`` among its imports), the first held against
   ``describe(path, device="cpu")``; then ``python -m tpuprof_torch diff``
   of the two artifacts: the two changed columns at drift, the rest ok,
   and exit 1 with ``--fail-on-drift`` (in process).  Each
   run prints its wall time, rows/s and phase seconds, and the in-process
   runs their ``render`` seconds;
6. the rest of host ingest on one frame made from ``--seed``: the
   headline's 200 float32 columns plus ``tags`` list<string>, ``meta``
   struct<a: int64, b: string>, ``uid`` (about one distinct value a
   row) and ``city``, 524,288 rows in 8 batches (a depth cut to keep the
   script inside its time limit).  ``describe`` of it
   in memory at ``prep_workers`` 1, default and 8 (K1 8, K2 8; the
   three ``stats_to_json`` equal; which of the dictionary and row-hash
   paths each string column took, batch by batch); the command line on
   it as a Parquet directory with ``--nested stringify`` (two-pass, equal
   to ``describe`` but for ``memorysize``; then fused warm from its
   artifact, K4 16 alone, equal to two-pass) and ``--nested opaque``
   (``tags`` and ``meta`` count, missing and memory only); then, with
   ``nested="opaque"``, the ingest guard through the port's fault sites:
   two transient prepare faults retried (equal to the clean run), one
   poison batch quarantined (one manifest entry, one ``quarantine_log``
   line, ``n`` one batch short, the degraded banner), the same with no
   budget raising, and a 3 s ``device_wait`` under a 1 s
   ``drain_timeout_s`` raising ``WatchdogTimeout``; every run prints its
   wall and phase seconds;
7. past the kernels' limits: 2,112 float32 columns x 32,768 rows two-pass
   and with ``spearman=True`` (the XLA twin, K2, the exact rank tier; K1,
   K3, K5 and K6 launch 0 times) against ``describe(..., device="cpu")``;
   4,096 x 131,072 (two device batches) two-pass with ``spearman=True`` and
   fused warm (equal to two-pass), with wall, phase seconds and peak
   device memory, and the card times of the routes that are not kernels
   (the twin, its ``torch.matmul`` Gram, the exact tier's
   ``searchsorted``) on one batch; the headline 200 x 2,097,152 at
   ``bins=16384`` two-pass and fused warm (K1 then K2, equal), each
   histogram's bin pairs summing to the 8,192-bin describe's exactly;
8. durable profiles: a ``StreamingProfiler`` over the headline table in
   16,384-row micro-batches, two-pass (K1) and fused (K4), checkpointed at
   1,048,576 rows and written as a fold-state artifact at 1,572,864; a
   child process (``--resume-child``) restores the checkpoint and
   ``resume_profiler``-s the artifact, feeds the rest, and both equal the
   uninterrupted stream's ``stats_to_json``; the stream's counts, min/max
   and moments equal ``describe``'s; then ``python -m tpuprof_torch
   profile --checkpoint P --checkpoint-every 4`` on phase 5's Parquet
   directory: one child killed by ``TPUPROF_FAULTS=fold:1@9``, one that
   resumes, its artifact's stats equal to phase 5's uninterrupted profile's.
   It prints the stream's rows/s, each save's seconds and bytes and the
   resume seconds;
9. one JSON line of per-kernel numbers, the card's name and power limit,
   and as the last line ``{"ok": true, "device": {...}}``.

Without a CUDA device (and without ``--cpu-rehearsal``) it exits 2 and
prints no result.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import warnings

import numpy as np

# H100 SXM peaks the bounds are computed against (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
# dense, on the tensor cores
TF32_FLOPS = 495e12
BF16_FLOPS = 989e12
INT8_OPS = 1979e12

RTOL_MOM, ATOL_MOM, ATOL_RHO = 5e-4, 1e-5, 5e-4

# (rows, offset views) of the Gram's load paths beyond the main path's
# aligned 65,536-row batches: a ragged row count that leaves a partial
# last chunk with R % 4 != 0 (4-byte copies of x), one with R % 4 == 0
# (16-byte copies ending mid-chunk), and inputs that start one element
# into their buffers (x not 16-byte aligned, row_valid read byte by byte)
LAYOUTS = ((65533, False), (65540, False), (65533, True))
REHEARSAL_LAYOUTS = ((301, False), (308, False), (301, True))


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def require(ok: bool, msg: str) -> None:
    if not ok:
        fail(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0].strip()


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

def adversarial_batch(C: int, R: int, seed: int):
    """(xt (C, R) f32, row_valid (R,) bool): NaN, +-inf, zeros, denormals,
    a constant and an all-NaN column, invalid tail rows."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((C, R), dtype=np.float32)
    x *= np.float32(10.0)
    x += np.float32(50.0)
    # one uniform draw places every special value (float32 draws: the
    # generation of the larger batches is a visible share of the script)
    u = rng.random((C, R), dtype=np.float32)
    x[u < 0.07] = np.nan
    x[(u >= 0.07) & (u < 0.08)] = np.inf
    x[(u >= 0.08) & (u < 0.09)] = -np.inf
    x[(u >= 0.09) & (u < 0.12)] = 0.0
    x[(u >= 0.12) & (u < 0.13)] = np.float32(1e-40)     # denormal
    if C > 2:
        x[1] = 7.0
        x[2] = np.nan
    rv = np.ones(R, dtype=bool)
    rv[-max(R // 10, 1):] = False
    return x, rv


def on_device(torch, device, a: np.ndarray, offset: bool = False):
    """``a`` on ``device``; with ``offset``, as a contiguous tensor that
    starts one element into its buffer, so its address is not 16-byte
    aligned."""
    t = torch.from_numpy(a)
    if not offset:
        return t.to(device)
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=device)
    return buf[1:].view(t.shape).copy_(t)


def finite_shift(x: np.ndarray) -> np.ndarray:
    prefix = x[:, :4096]
    fin = np.isfinite(prefix)
    return (np.where(fin, prefix, 0.0).sum(1)
            / np.maximum(fin.sum(1), 1)).astype(np.float32)


def hist_bounds(x: np.ndarray, rv: np.ndarray, nbins: int, rng,
                narrow: float = 0.0):
    """Pass-A style (lo, hi, mean) plus values placed exactly on bin
    edges, so the boundary rounding is exercised.  ``narrow`` > 0 takes
    that fraction of the range off each end and moves the mean, as a
    single-pass profile's provisional bounds can be off: values then fall
    outside [lo, hi] too."""
    v = np.where(rv[None, :] & np.isfinite(x), x, np.nan)
    with warnings.catch_warnings():       # the all-NaN column warns
        warnings.simplefilter("ignore", RuntimeWarning)
        lo = np.nan_to_num(np.nanmin(v, axis=1), nan=0.0)
        hi = np.nan_to_num(np.nanmax(v, axis=1), nan=0.0)
        mean = np.nan_to_num(np.nanmean(v, axis=1), nan=0.0)
    width = hi - lo
    lo, hi = lo + narrow * width, hi - narrow * width
    mean = mean + narrow * width
    lo, hi = lo.astype(np.float32), hi.astype(np.float32)
    edges = lo[:, None] + (hi - lo)[:, None] * (
        np.arange(nbins + 1, dtype=np.float32)[None, :] / np.float32(nbins))
    cols = np.arange(x.shape[0])[:, None]
    pos = rng.integers(0, x.shape[1], (x.shape[0], nbins + 1))
    x = x.copy()
    x[cols, pos] = edges.astype(np.float32)
    return x, lo, hi, mean.astype(np.float32)


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

def time_ms(fn, torch, device, warmup=3, reps=20) -> float:
    """Mean milliseconds per call: CUDA events around ``reps`` calls after
    ``warmup``; the host clock with no events on the CPU rehearsal."""
    for _ in range(warmup):
        fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, torch, reps=20, replays=5, warmup=3) -> float:
    """Device milliseconds per call: ``reps`` calls of ``fn`` captured in
    one CUDA graph, replayed ``replays`` times between CUDA events.  The
    host's work per call (argument checks, allocation, the enqueue) stays
    out of the figure, which :func:`time_ms` measures where the host is
    slower than the device.  The warm-up runs on the capture stream, so
    what a first call allocates is not captured."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (replays * reps)
    del graph
    return ms


def bound(nbytes: float, ops: float, flops: float = F32_FLOPS):
    """(bound_ms, bound_by): the larger of bytes over the HBM rate and
    operations over ``flops`` (the float32 rate unless given)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / flops
    return 1e3 * max(t_bytes, t_ops), ("operations" if t_ops > t_bytes
                                       else "bytes")


def gram_ops(C: int, R: int) -> int:
    """The Gram work a pass-A or Spearman kernel needs: P = d d^T and
    N = m m^T are symmetric (one triangle, diagonal included, at 2 flops
    a row each); S1 = d m^T and S2 = d^2 m^T are not (2 C^2 R each)."""
    return 2 * C * (C + 1) * R + 4 * C * C * R


def gram_bounds(nbytes: float, C: int, R: int, d_parts: int = 3,
                d2_parts: int = 3):
    """The bounds of a kernel whose work is the Gram (K1, K3, K4, K5):
    (bound_ms, bound_by, route_bound_ms, bound_f32_ms).

    ``bound_ms`` is the function's: each product at the card's rate for
    the cheapest type that computes it to float32 accuracy.  ``d_parts``
    and ``d2_parts`` are the bf16 terms that hold every d and d^2 of the
    inputs exactly (:func:`bf16_parts`; 3 hold any float32 value).  P =
    d d^T (one triangle) takes d_parts^2 bf16 passes, at most 3 TF32
    passes (a 3xTF32 split; six bf16 passes cost the same); S1 = d m^T
    and S2 = d^2 m^T take d_parts and d2_parts bf16 passes (m is 0 or 1,
    exact in bf16); N = m m^T (one triangle) one exact int8 pass.  Those
    rates' times add.  ``route_bound_ms`` is the route the kernel takes:
    the 3xTF32 split's TF32 products, twice :func:`gram_ops` (3 + 1
    passes for P and N, 2 + 2 for S1 and S2, over two), at the TF32 rate.
    ``bound_f32_ms`` is :func:`gram_ops` at the float32 rate, kept from
    the CUDA-core design."""
    tri = C * (C + 1) * R               # one triangle at 2 flops a row
    t_ops = (min(d_parts ** 2 * tri / BF16_FLOPS, 3 * tri / TF32_FLOPS)
             + 2 * (d_parts + d2_parts) * C * C * R / BF16_FLOPS
             + tri / INT8_OPS)
    t_bytes = nbytes / HBM_BYTES_PER_S
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops > t_bytes else "bytes",
            bound(nbytes, 2 * gram_ops(C, R), TF32_FLOPS)[0],
            bound(nbytes, gram_ops(C, R))[0])


def bf16_parts(torch, v) -> int:
    """How many bf16 terms, each the rounding of what the ones before left,
    sum to every value of the float32 tensor ``v`` exactly: 1, 2, or 3
    (three hold a float32 value to float32 accuracy)."""
    rest = v
    for parts in (1, 2):
        rest = rest - rest.bfloat16().float()
        if bool((rest == 0).all()):
            return parts
    return 3


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def print_row(r) -> None:
    """One kernel-line row as a line of text."""
    print(f"{r['name']} at {r['shape']}: {r['ms']:.4f} ms (bound "
          f"{r['bound_ms']:.4f} ms by {r['bound_by']}, route bound "
          f"{r.get('route_bound_ms')}, float32 bound "
          f"{r.get('bound_f32_ms')}; plain {r['plain_ms']:.4f} ms; "
          f"library {r['library_ms']})", flush=True)


def max_abs_diff(torch, a, b) -> float:
    """Largest |a - b| over the entries finite in both (0.0 if none)."""
    a, b = a.double(), b.double()
    both = torch.isfinite(a) & torch.isfinite(b)
    return float((a - b).abs()[both].max()) if both.any() else 0.0


def check_pass_a(torch, device, label, kernel_fn, plain_fn, shapes,
                 seed0=0, skip_stats=False):
    """A pass-A kernel (K1, or K3 with or without ``skip_stats``) against
    its plain version at ``shapes``, (C, R, offset) each (``offset``:
    x and row_valid as :func:`on_device` offsets them).  Returns (the
    largest absolute error of its float outputs s1..s4, P, S1, S2; the
    largest error of the finalized moments scaled by max(|ref|, 1) and of
    rho) over all shapes."""
    from tpuprof_torch.kernels import corr, fused, moments
    worst_abs = worst = 0.0
    for k, (C, R, offset) in enumerate(shapes):
        x, rv = adversarial_batch(C, R, seed0 + k)
        xt = on_device(torch, device, x, offset)
        rvt = on_device(torch, device, rv, offset)
        shift = torch.from_numpy(finite_shift(x)).to(device)
        got = kernel_fn(xt, rvt, shift)
        ref = plain_fn(xt, rvt, shift)
        if device.type == "cuda":
            torch.cuda.synchronize()
        sums, counts, P, S1, S2, N = got
        rs, rc, rP, rS1, rS2, rN = ref
        del xt, got, ref
        at = f"{label} at {C}x{R}" + (" offset" if offset else "")
        require(torch.equal(counts, rc), f"{at}: counts differ")
        require(torch.equal(N, rN), f"{at}: pair counts N differ")
        require(torch.equal(sums[:, 4:], rs[:, 4:]), f"{at}: min/max differ")
        if skip_stats:
            require(torch.equal(sums, rs), f"{at}: sums are not the "
                    "identities")
        worst_abs = max([worst_abs, max_abs_diff(torch, sums[:, :4],
                                                 rs[:, :4])]
                        + [max_abs_diff(torch, u, v) for u, v in
                           ((P, rP), (S1, rS1), (S2, rS2))])
        c0 = corr.init(C, device)
        c0["shift"] = shift
        c0["set"].fill_(1)
        if not skip_stats:
            m0 = moments.init(C, device)
            m0["shift"] = shift
            fg = moments.finalize(fused._fold_mom(m0, sums, counts))
            fr = moments.finalize(fused._fold_mom(m0, rs, rc))
            for key in ("mean", "variance", "skewness", "kurtosis", "sum"):
                ok = np.allclose(fg[key], fr[key], rtol=RTOL_MOM,
                                 atol=ATOL_MOM, equal_nan=True)
                require(ok, f"{at}: {key} outside rtol {RTOL_MOM}")
                both = np.isfinite(fg[key]) & np.isfinite(fr[key])
                if both.any():
                    worst = max(worst, float(np.max(np.abs(
                        fg[key][both] - fr[key][both]) / np.maximum(
                        np.abs(fr[key][both]), 1.0))))
        rho_g = corr.finalize(fused._fold_corr(c0, P, S1, S2, N))
        rho_r = corr.finalize(fused._fold_corr(c0, rP, rS1, rS2, rN))
        require(np.allclose(rho_g, rho_r, rtol=0, atol=ATOL_RHO,
                            equal_nan=True),
                f"{at}: rho outside atol {ATOL_RHO}")
        both = np.isfinite(rho_g) & np.isfinite(rho_r)
        if both.any():
            worst = max(worst, float(np.max(np.abs(rho_g - rho_r)[both])))
        print(f"{at}: counts/N/min/max exact, "
              + ("sums at their identities" if skip_stats else "moments")
              + " and rho within tolerance", flush=True)
    return worst_abs, worst


def mad_order(torch, xt, rvt, mean, split_cols=None):
    """K2's sum |x - mean| per column in its order of float32 additions
    (``tests/test_torch_hist_order.py`` models it in numpy): on the
    partition ``hist.splits(split_cols or C, R)``, thread t of a split's
    block sums its rows r0 + t + 256 k in order, the block's tree
    ``red[t] += red[t + stride]`` (stride 128 .. 1), then the partials
    in split order from 0.  Padding adds +0.0, which leaves every sum
    (>= 0) as it is."""
    from tpuprof_torch.kernels import hist
    C, R = xt.shape
    n_s, rows = hist.splits(split_cols or C, R)
    T = hist._THREADS
    k = -(-rows // T)
    v = torch.where(rvt[None, :] & torch.isfinite(xt),
                    (xt - mean[:, None]).abs(), 0.0)
    v = torch.nn.functional.pad(v, (0, n_s * rows - R)).view(C, n_s, rows)
    v = torch.nn.functional.pad(v, (0, k * T - rows)).view(C, n_s, k, T)
    red = torch.zeros((C, n_s, T), dtype=torch.float32, device=xt.device)
    for j in range(k):
        red += v[:, :, j]
    stride = T // 2
    while stride:
        red[..., :stride] += red[..., stride:2 * stride]
        stride //= 2
    acc = torch.zeros((C,), dtype=torch.float32, device=xt.device)
    for s in range(n_s):
        acc += red[:, s, 0]
    return acc


def hostile_bounds(lo, hi, mean):
    """Bounds beyond what pass A gives, on columns 3-7 (if there): a width
    that overflows to inf (scale 0), a negative width (clamped to 1e-30),
    NaN bounds (clamp_min keeps the NaN: every value in bin 0), a
    denormal width (1e-39, clamped to 1e-30) and infinite bounds
    (inf - inf: a NaN scale).  K2 forms the scale from lo and hi itself."""
    lo, hi = lo.copy(), hi.copy()
    for c, (l, h) in zip(range(3, len(lo)),
                         ((-3e38, 3e38), (60.0, 40.0), (np.nan, np.nan),
                          (0.0, 1e-39), (np.inf, np.inf))):
        lo[c], hi[c] = l, h
    return lo, hi, mean


def check_k2(torch, device, kernel_fn, cases, rehearsal, seed=7):
    """K2 against histogram_plain at each (C, R, offset, bins) of
    ``cases`` (``offset``: x and row_valid as :func:`on_device` offsets
    them), on the adversarial batch with values on the bin edges, then on
    it with :func:`hostile_bounds`: counts exact, the MAD numerator within
    rtol 5e-4 and, on the card, bit for bit :func:`mad_order`; a rerun
    gives the same bits.  Then a batch whose every value lands in one bin
    and a re-bin of three of 200 columns (``index_select``, ``split_cols``
    200), whose MAD must be the full width's bits.  Returns (the largest
    absolute error of K2's sum |x - mean| output against the plain
    version; the largest MAD error scaled by max(|ref|, 1))."""
    from tpuprof_torch.kernels import hist
    rng = np.random.default_rng(seed)
    worst_abs = worst = 0.0
    def held(t, nbins, at, split_cols=None, want_dev=None):
        nonlocal worst_abs, worst
        cnt, dev = kernel_fn(*t, nbins, split_cols=split_cols)
        rc, rd = hist.histogram_plain(*t, nbins)
        require(torch.equal(cnt, rc), f"K2 {at}: counts differ")
        n = t[1][None, :] & torch.isfinite(t[0])
        nf = n.sum(1).clamp_min(1).double()
        mad_g = (dev.double() / nf).cpu().numpy()
        mad_r = (rd.double() / nf).cpu().numpy()
        require(np.allclose(mad_g, mad_r, rtol=RTOL_MOM, atol=0),
                f"K2 {at}: MAD outside rtol {RTOL_MOM}")
        worst_abs = max(worst_abs, max_abs_diff(torch, dev, rd))
        worst = max(worst, float(np.max(np.abs(mad_g - mad_r)
                                        / np.maximum(np.abs(mad_r), 1.0))))
        if not rehearsal:
            model = mad_order(torch, t[0], t[1], t[4], split_cols)
            require(torch.equal(dev.view(torch.int32),
                                model.view(torch.int32)),
                    f"K2 {at}: MAD not bit for bit its order model")
            again = kernel_fn(*t, nbins, split_cols=split_cols)
            require(torch.equal(cnt, again[0]) and torch.equal(
                dev.view(torch.int32), again[1].view(torch.int32)),
                f"K2 {at}: rerun changed bits")
        if want_dev is not None:
            require(torch.equal(dev.view(torch.int32),
                                want_dev.view(torch.int32)),
                    f"K2 {at}: not the full width's MAD bits")
        return cnt, dev

    for k, (C, R, offset, bins_list) in enumerate(cases):
        x0, rv = adversarial_batch(C, R, seed + k)
        for nbins in bins_list:
            x, lo, hi, mean = hist_bounds(x0, rv, nbins, rng)
            for hostile in (False, True):
                b = hostile_bounds(lo, hi, mean) if hostile else (lo, hi,
                                                                  mean)
                t = [on_device(torch, device, a, offset and j < 2)
                     for j, a in enumerate((x, rv) + b)]
                at = f"{C}x{R} bins={nbins}" + (" offset" if offset else "") \
                    + (" hostile bounds" if hostile else "")
                held(t, nbins, at)
                for kernel in hist.KERNELS:
                    c2, _ = hist.histogram_batch(*t, nbins, kernel=kernel)
                    require(torch.equal(c2, hist.histogram_plain(
                        *t, nbins)[0]), f"K2 {at} kernel={kernel}: counts "
                        "differ")
                del t
            print(f"K2 {C}x{R} bins={nbins}" + (" offset" if offset else "")
                  + ": counts exact, MAD within tolerance"
                  + ("" if rehearsal else " and bit for bit its order "
                     "model, rerun identical")
                  + "; again with hostile bounds", flush=True)
        del x0, x

    # at the second case's shape: the main path's 200 columns on the card
    C, R = cases[min(1, len(cases) - 1)][:2]
    x, rv = adversarial_batch(C, R, seed + 50)
    x, lo, hi, mean = hist_bounds(x, rv, 10, rng)
    t = [torch.from_numpy(a).to(device) for a in (x, rv, lo, hi, mean)]
    one_hi = (t[2] + (t[3] - t[2]) * 10 * 1.01).contiguous()
    cnt, _ = held([t[0], t[1], t[2], one_hi, t[4]], 10,
                  f"{C}x{R} one bin")
    require(bool((cnt[:, 1:] == 0).all()), "the one-bin batch spans bins")
    _, full = held(t, 10, f"{C}x{R} full width")
    lanes = torch.tensor([0, 5, C - 1], device=device)
    sub = [t[0].index_select(0, lanes), t[1]] + [
        v.index_select(0, lanes) for v in t[2:]]
    held(sub, 10, f"3 of {C} columns, split_cols={C}", split_cols=C,
         want_dev=full.index_select(0, lanes))
    print(f"K2 one-bin batch at {C}x{R}: counts exact; re-bin of 3 of {C} "
          "columns: the full width's MAD bits", flush=True)
    return worst_abs, worst


def hist_library(torch, xt, rvt, lo, hi, mean, nbins):
    """The closest PyTorch route to K2, several calls: each finite value's
    bin floor((x - lo) * scale) (NaN to bin 0, clamped to [0, nbins - 1],
    offset by its column's nbins), masked values to one extra bin, one
    ``torch.bincount`` over C * nbins + 1, and the masked
    sum |x - mean|.  The port never calls it."""
    from tpuprof_torch.kernels import hist
    C = xt.shape[0]
    scale = hist.bin_scale(lo, hi, nbins)
    fin = rvt[None, :] & torch.isfinite(xt)
    b = torch.nan_to_num(((xt - lo[:, None]) * scale[:, None]).floor_(),
                         nan=0.0).clamp_(0, nbins - 1).long()
    b += torch.arange(C, device=xt.device)[:, None] * nbins
    b = torch.where(fin, b, C * nbins)
    counts = torch.bincount(b.view(-1), minlength=C * nbins + 1)
    dev = torch.where(fin, (xt - mean[:, None]).abs(), 0.0).sum(1)
    return counts[:C * nbins].view(C, nbins).int(), dev


def clean_batch(torch, device, C, R, seed=5):
    """The timed batch: N(50, 10) float32, every row valid, pass-A bounds
    (min, max, mean) of each column."""
    x = np.random.default_rng(seed).normal(50.0, 10.0, (C, R)).astype(
        np.float32)
    xt = torch.from_numpy(x).to(device)
    rvt = torch.ones(R, dtype=torch.bool, device=device)
    lo, hi = xt.amin(1).contiguous(), xt.amax(1).contiguous()
    return xt, rvt, lo, hi, xt.mean(1).contiguous()


def k2_times(torch, device, k2, C=200, R=65536, CW=2048, nbins=10,
             out=None):
    """K2's times on clean batches: the wrapper call as :func:`time_ms`
    takes it (``ms``), device time alone from a CUDA graph of wrapper
    calls (``device_ms``), that at 128 and 8,192 bins, at ``CW`` columns,
    and on a batch whose every value lands in one bin (``hi`` moved out
    to lo + nbins x the range: all of bin 0), and the library route's
    time, its counts checked equal to K2's first.  Fills and returns
    ``out``.  On the CPU rehearsal every figure is :func:`time_ms`'s."""
    out = {} if out is None else out
    xt, rvt, lo, hi, mean = clean_batch(torch, device, C, R)
    out["ms"] = time_ms(lambda: k2(xt, rvt, lo, hi, mean, nbins), torch,
                        device)

    def dev_ms(*a):
        if device.type != "cuda":
            return time_ms(lambda: k2(*a), torch, device)
        return graph_ms(lambda: k2(*a), torch)

    out["device_ms"] = dev_ms(xt, rvt, lo, hi, mean, nbins)
    one_hi = (lo + (hi - lo) * nbins * 1.01).contiguous()
    one = k2(xt, rvt, lo, one_hi, mean, nbins)[0]
    require(bool((one[:, 1:] == 0).all()), "the one-bin batch spans bins")
    out["device_ms_one_bin"] = dev_ms(xt, rvt, lo, one_hi, mean, nbins)
    for nb in (128, 8192):
        out[f"device_ms_{nb}_bins"] = dev_ms(xt, rvt, lo, hi, mean, nb)
    lib = hist_library(torch, xt, rvt, lo, hi, mean, nbins)
    got = k2(xt, rvt, lo, hi, mean, nbins)
    require(torch.equal(lib[0], got[0]),
            "the bincount route's counts differ from K2's")
    require(np.allclose(lib[1].cpu().numpy(), got[1].cpu().numpy(),
                        rtol=RTOL_MOM, atol=0),
            f"the bincount route's MAD numerator is outside rtol {RTOL_MOM}")
    # bincount reads its largest index back to the host: no graph
    out["library_ms"] = time_ms(
        lambda: hist_library(torch, xt, rvt, lo, hi, mean, nbins), torch,
        device)
    del xt, lib, got
    xw, rvw, low, hiw, meanw = clean_batch(torch, device, CW, R, seed=6)
    out[f"device_ms_{CW}_cols"] = dev_ms(xw, rvw, low, hiw, meanw, nbins)
    return out


def check_k2_global(torch, device, k2, rehearsal: bool):
    """K2's device-memory body (past 8,192 bins) at 200 x 65,536 with
    16,384 and 65,536 bins (tiny sizes on the CPU rehearsal): counts
    equal to ``histogram_plain`` exactly, on the adversarial batch and on a
    clean one; the MAD numerator bit for bit the 10-bin shared body's on
    the same batch.  Then its times on the clean batch: the wrapper as the
    host issues it, device time alone from a CUDA graph, the bincount
    route (its counts checked equal first) and the bytes bound (each
    input read once, the (C, nbins) counts and the MAD written once).
    Returns the fields K2's kernel-line row gains."""
    from tpuprof_torch.kernels import hist
    if rehearsal:
        C, R, bins_list = 5, 700, (hist.SHARED_MAX_BINS + 1, 9000)
    else:
        C, R, bins_list = 200, 65536, (16384, 65536)
    x, rv = adversarial_batch(C, R, 70)
    x, lo, hi, mean = hist_bounds(x, rv, 10, np.random.default_rng(71))
    xc, rvc, loc, hic, meanc = clean_batch(torch, device, C, R, seed=72)
    out = {"global_body_bins": list(bins_list)}
    for batch_name, t in (
            ("adversarial", [torch.from_numpy(a).to(device)
                             for a in (x, rv, lo, hi, mean)]),
            ("clean", [xc, rvc, loc, hic, meanc])):
        _, dev10 = k2(*t, 10)
        for nbins in bins_list:
            cnt, dev = k2(*t, nbins)
            want, want_dev = hist.histogram_plain(*t, nbins)
            require(torch.equal(cnt, want), f"K2 device-memory body "
                    f"{C}x{R} bins={nbins} {batch_name}: counts differ")
            if not rehearsal:
                require(torch.equal(dev.view(torch.int32),
                                    dev10.view(torch.int32)),
                        f"K2 device-memory body bins={nbins} "
                        f"{batch_name}: MAD not the shared body's bits")
            out["max_abs_err_global"] = max(
                out.get("max_abs_err_global", 0.0),
                max_abs_diff(torch, dev, want_dev))
            print(f"K2 device-memory body {C}x{R} bins={nbins} "
                  f"{batch_name}: counts equal to histogram_plain"
                  + ("" if rehearsal else ", MAD bits the 10-bin shared "
                     "body's"), flush=True)
    for nbins in bins_list:
        args = (xc, rvc, loc, hic, meanc, nbins)
        out[f"ms_{nbins}_bins"] = time_ms(lambda: k2(*args), torch, device)
        out[f"device_ms_{nbins}_bins"] = graph_ms(
            lambda: k2(*args), torch) if not rehearsal else \
            out[f"ms_{nbins}_bins"]
        lib = hist_library(torch, *args)
        require(torch.equal(lib[0], k2(*args)[0]), f"the bincount route's "
                f"counts differ from K2's at {nbins} bins")
        out[f"library_ms_{nbins}_bins"] = time_ms(
            lambda: hist_library(torch, *args), torch, device)
        out[f"plain_ms_{nbins}_bins"] = time_ms(
            lambda: hist.histogram_plain(*args), torch, device, warmup=1,
            reps=1)
        out[f"bound_ms_{nbins}_bins"] = bound(
            C * R * 4 + R + 3 * C * 4 + C * nbins * 4 + C * 4,
            8 * C * R)[0]
    print("K2 device-memory body times: " + json.dumps(
        {k: v for k, v in out.items() if "ms" in k}), flush=True)
    return out


SASS_OPS = ("LDG", "STG", "LDS", "STS", "ATOMS", "ATOMG", "RED", "BAR")


def sass_counts(text: str) -> dict:
    """{kernel function: {opcode: count, "LDG_between_ATOMS": n}} of a
    ``cuobjdump -sass`` listing: the memory and barrier opcodes, and the
    most global loads in program order with no shared atomic between
    them (an unrolled row loop's loads in flight ahead of its bin
    increments, with the block's few scalar loads where they lead)."""
    out, fn, run = {}, None, 0
    for line in text.splitlines():
        if "Function : " in line:
            fn, run = line.split("Function : ")[1].strip(), 0
            out[fn] = dict.fromkeys(SASS_OPS + ("LDG_between_ATOMS",), 0)
            continue
        if fn is None or "*/" not in line:
            continue
        words = line.split("*/")[1].split()
        if words and words[0].startswith("@"):
            words = words[1:]
        op = words[0].split(".")[0] if words else ""
        if op in SASS_OPS:
            out[fn][op] += 1
        run = 0 if op == "ATOMS" else run + (op == "LDG")
        out[fn]["LDG_between_ATOMS"] = max(out[fn]["LDG_between_ATOMS"],
                                           run)
    return out


def k2_probe(torch, device) -> None:
    """``--k2-probe``: K2 alone, to compare checkouts in one call (each
    run with its own copy of this script, or this copy placed beside
    another checkout's package).  Prints its times (:func:`k2_times`),
    K4's wrapper and device time at 200 x 65,536 with 10 bins, the device
    time of each kernel that 20 K2 wrapper calls launch, from
    ``torch.profiler``, and the SASS counts of its library
    (:func:`sass_counts`)."""
    from torch.profiler import ProfilerActivity, profile
    from tpuprof_torch import _build, kernels
    from tpuprof_torch.kernels import fused, hist
    times = k2_times(torch, device, hist.histogram_cuda)
    print(f"K2 times: {json.dumps(times)}", flush=True)
    xt, rvt, lo, hi, mean = clean_batch(torch, device, 200, 65536)
    shift = mean.clone()

    def k4():
        return fused.tiles_ab_cuda(xt, rvt, shift, lo, hi, mean, 10)
    print("K4 times: " + json.dumps(
        {"ms": time_ms(k4, torch, device), "device_ms": graph_ms(k4, torch)}),
        flush=True)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            hist.histogram_cuda(xt, rvt, lo, hi, mean, 10)
        torch.cuda.synchronize()
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", 0)
        if us > 0:
            print(f"profiler: {ev.key[:70]} x{ev.count} "
                  f"{us / ev.count:.2f} us each", flush=True)
    so = _build.library_path(kernels.SOURCES["hist_b"], kernels._command())
    tool = os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", so], capture_output=True,
                          text=True, timeout=120, check=True).stdout
    for fn, counts in sass_counts(sass).items():
        print(f"sass {fn}: {json.dumps(counts)}", flush=True)


def phase_kernels(torch, device, rehearsal: bool):
    from tpuprof_torch.kernels import fused, hist
    if rehearsal:
        k1 = fused.tiles_plain

        def k2(*a, split_cols=None):
            """The plain version, whose sums do not depend on split_cols"""
            return hist.histogram_plain(*a)
        shapes, C, R = [(5, 300), (13, 700)], 13, 700
        k2_cols, k2_bins, CW = (5, 13, 40), (1, 10, 128), 40
        layouts = REHEARSAL_LAYOUTS
    else:
        k1, k2 = fused.tiles_cuda, hist.histogram_cuda
        R = 65536
        shapes, C = [(37, R), (200, R), (512, R)], 200
        k2_cols, k2_bins, CW = (37, 200, 512, 2048), (1, 10, 128, 8192), 2048
        layouts = LAYOUTS
    shapes = [(c, r, False) for c, r in shapes] + [
        (C, r, offset) for r, offset in layouts]
    err1, scaled1 = check_pass_a(torch, device, "K1", k1, fused.tiles_plain,
                                 shapes)
    err2, scaled2 = check_k2(
        torch, device, k2,
        [(c, R, False, k2_bins) for c in k2_cols]
        + [(C, r, offset, (10,)) for r, offset in layouts], rehearsal)

    # determinism: K1 twice on one input gives the same bits
    x, rv = adversarial_batch(C, R, 99)
    xt = torch.from_numpy(x).to(device)
    rvt = torch.from_numpy(rv).to(device)
    shift = torch.from_numpy(finite_shift(x)).to(device)
    a, b = k1(xt, rvt, shift), k1(xt, rvt, shift)
    require(all(torch.equal(u, v) for u, v in zip(a, b)),
            "K1 rerun changed bits")
    a, b = k2(xt, rvt, shift, shift + 1, shift, 10), \
        k2(xt, rvt, shift, shift + 1, shift, 10)
    require(all(torch.equal(u, v) for u, v in zip(a, b)),
            "K2 rerun changed bits")
    print("K1 and K2 reruns: identical bits", flush=True)

    # times at the bench shape (clean data: the common case)
    rng = np.random.default_rng(5)
    xb = rng.normal(50.0, 10.0, (C, R)).astype(np.float32)
    xt = torch.from_numpy(xb).to(device)
    rvt = torch.ones(R, dtype=torch.bool, device=device)
    shift = torch.from_numpy(finite_shift(xb)).to(device)
    lo, hi = xt.amin(1).contiguous(), xt.amax(1).contiguous()
    mean = xt.mean(1).contiguous()
    nbins = 10
    t1 = time_ms(lambda: k1(xt, rvt, shift), torch, device)
    p1 = time_ms(lambda: fused.tiles_plain(xt, rvt, shift), torch, device,
                 reps=5)
    ops = gram_operands(torch, xt, rvt, shift)
    lib1 = time_ms(lambda: gram_products(*ops), torch, device)
    k2t = k2_times(torch, device, k2, C, R, CW, nbins)
    p2 = time_ms(lambda: hist.histogram_plain(xt, rvt, lo, hi, mean, nbins),
                 torch, device, reps=5)
    b1, by1, b1r, b1f = gram_bounds(
        C * R * 4 + R + C * 4 + C * 8 * 8 + 4 * C * C * 4, C, R)
    b2, by2 = bound(C * R * 4 + R + 3 * C * 4 + C * nbins * 4 + C * 4,
                    8 * C * R)
    b2w, _ = bound(CW * R * 4 + R + 3 * CW * 4 + CW * nbins * 4 + CW * 4,
                   8 * CW * R)
    k2g = check_k2_global(torch, device, k2, rehearsal)
    rows = [
        {"name": "fused_a", "route": "cuda",
         "source": "tpuprof_torch/kernels/csrc/fused_a.cu",
         "replaces": "tpuprof/kernels/fused.py:245", "shape": f"{C}x{R}",
         "max_abs_err": err1, "max_scaled_err": scaled1,
         "ms": t1, "plain_ms": p1, "bound_ms": b1, "bound_by": by1,
         "route_bound_ms": b1r, "bound_f32_ms": b1f, "library_ms": lib1},
        {"name": "hist_b", "route": "cuda",
         "source": "tpuprof_torch/kernels/csrc/hist_b.cu",
         "replaces": "tpuprof/kernels/pallas_hist.py:202",
         "shape": f"{C}x{R} bins={nbins}", "max_abs_err": err2,
         "max_scaled_err": scaled2, "ms": k2t.pop("ms"), "plain_ms": p2,
         "bound_ms": b2, "bound_by": by2,
         "library_ms": k2t.pop("library_ms"), **k2t,
         f"bound_ms_{CW}_cols": b2w, **k2g},
    ]
    for r in rows:
        print_row(r)
    print(f"hist_b: ms is the wrapper call as the host issues it (CUDA "
          f"events over 20 calls); device time from a CUDA graph of 20 "
          f"calls: {json.dumps(k2t)} (bound at {CW} columns {b2w:.4f} ms); "
          "library_ms: torch.bincount over C*nbins+1 after floor, "
          "nan_to_num, clamp and where, and the masked abs sum", flush=True)
    print("K1 library_ms covers the Gram only: torch.matmul of already "
          "materialized d, m, d^2", flush=True)
    return rows


def sample_grid(x: np.ndarray, G: int, seed: int) -> np.ndarray:
    """The (C, G) CDF grid of ``x`` (C, R) as the main path builds it: the
    port's row sampler over the first rows, then ``cdf_grid``."""
    from tpuprof_torch.ingest.sample import RowSampler
    n = min(x.shape[1], 16384)
    sampler = RowSampler(4096, x.shape[0], seed=seed)
    sampler.update(x[:, :n].T, n)
    return sampler.cdf_grid(G)


def rank_inputs(C: int, R: int, G: int, seed: int):
    """(xt (C, R) f32, row_valid (R,) bool, grid (C, G) f32): K1's
    adversarial batch (NaN, +-inf, zeros, denormals, a constant column,
    whose grid is all one value, and an all-NaN column, invalid rows), a
    discrete column of three values (its grid is three long runs of ties:
    the rank search's tie count), a CDF grid built by the port's row
    sampler as the main path builds it, an eighth of the values set equal
    to grid points (ties), and a column of finite values whose grid is all
    +inf."""
    x, rv = adversarial_batch(C, R, seed)
    rng = np.random.default_rng(seed + 1)
    if C > 5:
        x[4] = rng.choice(np.array([-1.0, 0.5, 2.0], dtype=np.float32), R)
        x[4, rng.random(R) < 0.07] = np.nan
    grid = sample_grid(x, G, seed)
    pos = rng.integers(0, R, (C, max(R // 8, 1)))
    pick = rng.integers(0, G, pos.shape)
    x[np.arange(C)[:, None], pos] = np.take_along_axis(grid, pick, axis=1)
    grid[min(3, C - 1)] = np.inf
    return x, rv, grid


def check_rank_kernels(torch, device, k5, k6, k3, cases, seed0=40):
    """K6 bit for bit against rank_transform_plain, and K5 (at most 512
    columns) bit for bit against K6 then K3 with ``skip_stats`` over its
    ranks and within tolerance of spear_tiles_plain, on ``rank_inputs`` at
    each (C, R, G, offset) of ``cases`` (``offset``: x and row_valid as
    :func:`on_device` offsets them).  Returns (the largest absolute error
    of K5's P, S1, S2; the largest rho error)."""
    from tpuprof_torch.kernels import corr, fused
    worst_abs = worst = 0.0
    for k, (C, R, G, offset) in enumerate(cases):
        x, rv, grid = rank_inputs(C, R, G, seed0 + k)
        t = [on_device(torch, device, a, offset and j < 2)
             for j, a in enumerate((x, rv, grid))]
        at = f"at {C}x{R} G={G}" + (" offset" if offset else "")
        ranks, ref = k6(*t), fused.rank_transform_plain(*t)
        if device.type == "cuda":
            torch.cuda.synchronize()
        require(torch.equal(ranks.view(torch.int32), ref.view(torch.int32)),
                f"K6 {at}: ranks not bit-identical")
        del ref
        if C > fused.MAX_FUSED_COLS:
            print(f"K6 {at}: ranks bit-identical", flush=True)
            continue
        got = k5(*t)
        half = torch.full((C,), 0.5, dtype=torch.float32, device=device)
        two = k3(ranks, t[1], half, skip_stats=True)[2:]
        ref = fused.spear_tiles_plain(*t)
        if device.type == "cuda":
            torch.cuda.synchronize()
        require(all(torch.equal(u, v) for u, v in zip(got, two)),
                f"K5 {at}: not bit-identical to K6 then K3 skip_stats")
        require(torch.equal(got[3], ref[3]), f"K5 {at}: pair counts differ")
        worst_abs = max([worst_abs] + [max_abs_diff(torch, u, v)
                                       for u, v in zip(got[:3], ref[:3])])
        c0 = corr.init(C, device)
        c0["shift"].fill_(0.5)
        c0["set"].fill_(1)
        rho_g = corr.finalize(fused._fold_corr(c0, *got))
        rho_r = corr.finalize(fused._fold_corr(c0, *ref))
        require(np.allclose(rho_g, rho_r, rtol=0, atol=ATOL_RHO,
                            equal_nan=True),
                f"K5 {at}: rho outside atol {ATOL_RHO}")
        both = np.isfinite(rho_g) & np.isfinite(rho_r)
        if both.any():
            worst = max(worst, float(np.max(np.abs(rho_g - rho_r)[both])))
        del ranks, got, two, ref
        print(f"K6 {at}: ranks bit-identical; K5: bit-identical to K6 then "
              "K3 skip_stats, N exact, rho within tolerance", flush=True)
    return worst_abs, worst


def rank_library(torch, xt, rvt, grid):
    """The closest PyTorch route to K6: two ``torch.searchsorted`` over
    the (C, G) grid (lt and le as int32), their sum times float32(0.5 /
    G), NaN where the row is invalid or x not finite."""
    from tpuprof_torch.kernels import fused
    c = torch.tensor(fused._rank_scale(grid.shape[1]), dtype=torch.float32,
                     device=xt.device)
    lt = torch.searchsorted(grid, xt, side="left", out_int32=True)
    le = torch.searchsorted(grid, xt, side="right", out_int32=True)
    fin = rvt[None, :] & torch.isfinite(xt)
    return torch.where(fin, (lt + le).float() * c, float("nan"))


def gram_operands(torch, vt, rvt, shift):
    """(d, m, [d; m], [d^2; m]) of values ``vt`` about ``shift``: the
    operands of the Gram-only library route."""
    fin = torch.isfinite(vt) & rvt[None, :]
    m = fin.float()
    d = torch.where(fin, vt - shift[:, None], 0.0)
    return d, m, torch.cat([d, m]), torch.cat([d * d, m])


def gram_products(d, m, dm, d2m):
    """The Gram-only library route: two torch.matmul calls, P and S1 as
    d [d; m]^T, S2 and N as [d^2; m] m^T."""
    return d @ dm.T, d2m @ m.T


def phase_kernels_wide_and_rank(torch, device, rehearsal: bool):
    """Phase 3 for K3, K5 and K6: checks against the plain versions (K5
    also bit for bit against K6 then K3 with ``skip_stats``), reruns,
    times.  Returns their kernel-line rows."""
    from tpuprof_torch.kernels import fused
    G = fused.MAX_SPEAR_GRID
    if rehearsal:
        k3, k5, k6 = (fused.tiles_wide_plain, fused.spear_tiles_plain,
                      fused.rank_transform_plain)
        R, C5, CW, C3s = 300, 13, 520, (520,)
        cases = [(C, R, g, False) for C in (5, 13) for g in (16, 100)]
        layouts = REHEARSAL_LAYOUTS
    else:
        k3, k5, k6 = fused.tiles_wide_cuda, fused.spear_tiles_cuda, \
            fused.rank_cuda
        R, C5, CW, C3s = 65536, 200, 2048, (513, 1024, 2048)
        cases = [(C, R, g, False) for C in (37, 200, 512)
                 for g in (16, 100, 256)]
        layouts = LAYOUTS
    # K5 and K6 at the ragged and unaligned layouts (the rank launch's
    # scalar path; 65,540 rows take the vector one), then K6 at the widest
    cases += [(C5, r, G, offset) for r, offset in layouts]
    cases.append((CW, R, G, False))
    shapes3 = [(C, R, False) for C in C3s] + [
        (C3s[0], r, offset) for r, offset in layouts]
    err3, scaled3 = check_pass_a(torch, device, "K3", k3,
                                 fused.tiles_wide_plain, shapes3, seed0=60)
    err3s, scaled3s = check_pass_a(
        torch, device, "K3 skip_stats",
        lambda *a: k3(*a, skip_stats=True),
        lambda *a: fused.tiles_wide_plain(*a, skip_stats=True), shapes3,
        seed0=70, skip_stats=True)
    err5, scaled5 = check_rank_kernels(torch, device, k5, k6, k3, cases)

    # determinism: each kernel twice on one input gives the same bits
    for label, fn, C in (("K3", k3, CW // 2),
                         ("K3 skip_stats",
                          lambda *a: k3(*a, skip_stats=True), CW // 2)):
        x, rv = adversarial_batch(C, R, 98)
        t = [torch.from_numpy(a).to(device)
             for a in (x, rv, finite_shift(x))]
        a, b = fn(*t), fn(*t)
        require(all(torch.equal(u, v) for u, v in zip(a, b)),
                f"{label} rerun changed bits")
    for label, fn, C in (("K5", k5, C5), ("K6", k6, CW)):
        t = [torch.from_numpy(a).to(device)
             for a in rank_inputs(C, R, G, 97)]
        a, b = fn(*t), fn(*t)
        same = torch.equal(a.view(torch.int32), b.view(torch.int32)) \
            if label == "K6" else all(torch.equal(u, v)
                                      for u, v in zip(a, b))
        require(same, f"{label} rerun changed bits")
    del a, b, t
    print("K3, K5 and K6 reruns: identical bits", flush=True)

    # times at the main path's shapes (clean data: the common case)
    rng = np.random.default_rng(5)

    def clean(C):
        x = rng.normal(50.0, 10.0, (C, R)).astype(np.float32)
        return [torch.from_numpy(a).to(device)
                for a in (x, np.ones(R, dtype=bool), finite_shift(x),
                          sample_grid(x, G, 5))]

    def check_rank_library(xt, rvt, grid, kernel_ranks):
        """The library route's ranks, held to the kernel's bits on the
        finite values before they are timed."""
        lib = rank_library(torch, xt, rvt, grid)
        fin = torch.isfinite(kernel_ranks)
        require(torch.equal(lib[fin].view(torch.int32),
                            kernel_ranks[fin].view(torch.int32))
                and torch.equal(fin, torch.isfinite(lib)),
                "the searchsorted route's ranks differ from K6's")

    xt, rvt, shift, grid = clean(C5)
    half5 = torch.full((C5,), 0.5, dtype=torch.float32, device=device)
    t5 = time_ms(lambda: k5(xt, rvt, grid), torch, device)
    # K5's two stages apart: K6 at its width, then K3's Gram of the ranks
    # (K1's partition at this width, so K5's Gram stage)
    ranks = k6(xt, rvt, grid)
    t5_rank = time_ms(lambda: k6(xt, rvt, grid), torch, device)
    t5_gram = time_ms(lambda: k3(ranks, rvt, half5, skip_stats=True),
                      torch, device)
    p5 = time_ms(lambda: fused.spear_tiles_plain(xt, rvt, grid), torch,
                 device, reps=5)
    check_rank_library(xt, rvt, grid, ranks)
    lib5 = time_ms(lambda: gram_products(*gram_operands(
        torch, rank_library(torch, xt, rvt, grid), rvt, half5)), torch,
        device)
    # K5's function bound counts each product at the bf16 terms this
    # run's d = rank - 0.5 and d^2 need (at G = 256 a rank is a multiple
    # of 1/512: d is exact in one bf16 term, d^2 in two)
    d5 = torch.where(torch.isfinite(ranks), ranks - 0.5, 0.0)
    parts5 = (bf16_parts(torch, d5), bf16_parts(torch, d5 * d5))
    del d5
    b5, by5, b5r, b5f = gram_bounds(
        C5 * R * 4 + R + C5 * G * 4 + 16 * C5 * C5, C5, R, *parts5)
    xt, rvt, shift, grid = clean(CW)
    t3 = time_ms(lambda: k3(xt, rvt, shift), torch, device)
    t3s = time_ms(lambda: k3(xt, rvt, shift, skip_stats=True), torch,
                  device)
    p3 = time_ms(lambda: fused.tiles_wide_plain(xt, rvt, shift), torch,
                 device, reps=5)
    ops = gram_operands(torch, xt, rvt, shift)
    lib3 = time_ms(lambda: gram_products(*ops), torch, device, reps=5)
    del ops
    b3, by3, b3r, b3f = gram_bounds(
        CW * R * 4 + R + CW * 4 + CW * 64 + 16 * CW * CW, CW, R)
    half = CW // 2
    xh, sh = xt[:half], shift[:half].contiguous()
    t3h = time_ms(lambda: k3(xh, rvt, sh), torch, device)
    b3h, _, b3hr, b3hf = gram_bounds(
        half * R * 4 + R + half * 68 + 16 * half * half, half, R)
    t6 = time_ms(lambda: k6(xt, rvt, grid), torch, device)
    p6 = time_ms(lambda: fused.rank_transform_plain(xt, rvt, grid), torch,
                 device, warmup=1, reps=2)
    check_rank_library(xt, rvt, grid, k6(xt, rvt, grid))
    lib6 = time_ms(lambda: rank_library(torch, xt, rvt, grid), torch, device,
                   reps=5)
    b6, by6 = bound(2 * CW * R * 4 + R + CW * G * 4, 0)
    del xt, xh
    rows = [
        {"name": "fused_wide", "route": "cuda",
         "source": "tpuprof_torch/kernels/csrc/fused_wide.cu",
         "replaces": "tpuprof/kernels/fused.py:351",
         "shape": f"{CW}x{R}", "max_abs_err": max(err3, err3s),
         "max_scaled_err": max(scaled3, scaled3s), "ms": t3,
         "ms_skip_stats": t3s, f"ms_{half}_cols": t3h,
         f"bound_ms_{half}_cols": b3h,
         f"route_bound_ms_{half}_cols": b3hr,
         f"bound_f32_ms_{half}_cols": b3hf,
         "plain_ms": p3, "bound_ms": b3, "bound_by": by3,
         "route_bound_ms": b3r, "bound_f32_ms": b3f, "library_ms": lib3},
        {"name": "spear", "route": "cuda",
         "source": "tpuprof_torch/kernels/csrc/spear.cu",
         "replaces": "tpuprof/kernels/fused.py:688",
         "shape": f"{C5}x{R} G={G}", "max_abs_err": err5,
         "max_scaled_err": scaled5, "ms": t5, "plain_ms": p5,
         "bound_ms": b5, "bound_by": by5, "route_bound_ms": b5r,
         "bound_f32_ms": b5f, "library_ms": lib5,
         "bound_bf16_parts_d_d2": list(parts5),
         "ms_rank_stage": t5_rank, "ms_gram_stage": t5_gram},
        {"name": "rank", "route": "cuda",
         "source": "tpuprof_torch/kernels/csrc/rank.cu",
         "replaces": "tpuprof/kernels/fused.py:754",
         "shape": f"{CW}x{R} G={G}", "max_abs_err": 0.0,
         "max_scaled_err": 0.0, "ms": t6, "plain_ms": p6, "bound_ms": b6,
         "bound_by": by6, "library_ms": lib6},
    ]
    for r in rows:
        print_row(r)
    print(f"spear's stages at {C5}x{R}: ranks (K6) {t5_rank:.4f} ms, Gram "
          f"(K3 skip_stats over them) {t5_gram:.4f} ms; its function bound "
          f"counts d in {parts5[0]} and d^2 in {parts5[1]} bf16 terms",
          flush=True)
    print(f"fused_wide skip_stats at {CW}x{R}: {t3s:.4f} ms; at {half}x{R}:"
          f" {t3h:.4f} ms (bound {b3h:.4f} ms, route bound {b3hr:.4f} ms, "
          f"float32 bound {b3hf:.4f} ms)", flush=True)
    print("fused_wide library_ms covers the Gram only: torch.matmul of "
          "already materialized d, m, d^2; rank library_ms: two "
          "torch.searchsorted (left, right) on the grid, their sum times "
          "float32(0.5/G), torch.where (its ranks equal K6's on finite "
          "values); spear library_ms: that rank route, d and m formed, and "
          "the Gram-only torch.matmul of K1's row", flush=True)
    return rows


def phase_kernel_ab(torch, device, rehearsal: bool):
    """Phase 3 for K4: against its plain version and bit for bit against
    K1 then K2 on the same inputs (provisional bounds narrower than the
    data, so values fall outside [lo, hi]), reruns, the time.  Returns its
    kernel-line row."""
    from tpuprof_torch.kernels import corr, fused, hist, moments
    if rehearsal:
        k4, k1, k2 = fused.tiles_ab_plain, fused.tiles_plain, \
            hist.histogram_plain
        R, cols, C = 700, (5, 13), 13
        layouts = REHEARSAL_LAYOUTS
    else:
        k4, k1, k2 = fused.tiles_ab_cuda, fused.tiles_cuda, \
            hist.histogram_cuda
        R, cols, C = 65536, (37, 200, 512), 200
        layouts = LAYOUTS
    # (columns, rows, offset, bin counts)
    cases = [(Ck, R, False, (1, 10, 100, 8192)) for Ck in cols] + [
        (C, r, offset, (10,)) for r, offset in layouts]
    rng = np.random.default_rng(11)
    worst_abs = worst = 0.0
    for k, (Ck, Rk, offset, bins_list) in enumerate(cases):
        x0, rv = adversarial_batch(Ck, Rk, 80 + k)
        for nbins in bins_list:
            x, lo, hi, mean = hist_bounds(x0, rv, nbins, rng, narrow=0.1)
            t = [on_device(torch, device, a, offset and j < 2) for j, a in
                 enumerate((x, rv, finite_shift(x), lo, hi, mean))]
            at = f"K4 at {Ck}x{Rk} bins={nbins}" + (" offset" if offset
                                                    else "")
            got = k4(*t, nbins)
            two = k1(*t[:3]) + k2(t[0], t[1], *t[3:], nbins)
            if device.type == "cuda":
                torch.cuda.synchronize()
            require(all(torch.equal(u, v) for u, v in zip(got, two)),
                    f"{at}: not bit-identical to K1 then K2")
            ref = fused.tiles_ab_plain(*t, nbins)
            sums, counts, P, S1, S2, N, hc, dv = got
            rs, rc, rP, rS1, rS2, rN, rhc, rdv = ref
            require(torch.equal(counts, rc) and torch.equal(N, rN)
                    and torch.equal(sums[:, 4:], rs[:, 4:]),
                    f"{at}: counts, pair counts or min/max differ")
            require(torch.equal(hc, rhc), f"{at}: histogram counts differ")
            worst_abs = max([worst_abs] + [
                max_abs_diff(torch, u, v) for u, v in
                ((sums[:, :4], rs[:, :4]), (P, rP), (S1, rS1), (S2, rS2),
                 (dv, rdv))])
            m0 = moments.init(Ck, device)
            m0["shift"] = t[2]
            fg = moments.finalize(fused._fold_mom(m0, sums, counts))
            fr = moments.finalize(fused._fold_mom(m0, rs, rc))
            nf = np.maximum(fr["n"], 1)
            pairs = [(fg[key], fr[key]) for key in
                     ("mean", "variance", "skewness", "kurtosis", "sum")]
            pairs.append((dv.double().cpu().numpy() / nf,
                          rdv.double().cpu().numpy() / nf))
            for a, b in pairs:
                require(np.allclose(a, b, rtol=RTOL_MOM, atol=ATOL_MOM,
                                    equal_nan=True),
                        f"{at}: moments or MAD outside rtol {RTOL_MOM}")
                both = np.isfinite(a) & np.isfinite(b)
                if both.any():
                    worst = max(worst, float(np.max(
                        np.abs(a[both] - b[both])
                        / np.maximum(np.abs(b[both]), 1.0))))
            c0 = corr.init(Ck, device)
            c0["shift"] = t[2]
            c0["set"].fill_(1)
            rho_g = corr.finalize(fused._fold_corr(c0, P, S1, S2, N))
            rho_r = corr.finalize(fused._fold_corr(c0, rP, rS1, rS2, rN))
            require(np.allclose(rho_g, rho_r, rtol=0, atol=ATOL_RHO,
                                equal_nan=True),
                    f"{at}: rho outside atol {ATOL_RHO}")
            del got, two, ref, t
            print(f"{at}: bit-identical to K1 then K2; against the plain "
                  "version counts/N/min/max/histograms exact, moments, MAD "
                  "and rho within tolerance", flush=True)
    x, rv = adversarial_batch(C, R, 96)
    x, lo, hi, mean = hist_bounds(x, rv, 10, rng, narrow=0.1)
    t = [torch.from_numpy(a).to(device)
         for a in (x, rv, finite_shift(x), lo, hi, mean)]
    a, b = k4(*t, 10), k4(*t, 10)
    require(all(torch.equal(u, v) for u, v in zip(a, b)),
            "K4 rerun changed bits")
    print("K4 reruns: identical bits", flush=True)

    # the time at the bench shape (clean data: the common case)
    nbins = 10
    xb = np.random.default_rng(5).normal(50.0, 10.0, (C, R)).astype(
        np.float32)
    xt = torch.from_numpy(xb).to(device)
    rvt = torch.ones(R, dtype=torch.bool, device=device)
    shift = torch.from_numpy(finite_shift(xb)).to(device)
    lo, hi = xt.amin(1).contiguous(), xt.amax(1).contiguous()
    mean = xt.mean(1).contiguous()
    t4 = time_ms(lambda: k4(xt, rvt, shift, lo, hi, mean, nbins), torch,
                 device)
    p4 = time_ms(lambda: fused.tiles_ab_plain(xt, rvt, shift, lo, hi, mean,
                                              nbins), torch, device, reps=5)
    ops = gram_operands(torch, xt, rvt, shift)
    lib4 = time_ms(lambda: gram_products(*ops), torch, device)
    b4, by4, b4r, b4f = gram_bounds(
        C * R * 4 + R + 4 * C * 4 + C * 8 * 8 + 4 * C * C * 4
        + C * nbins * 4 + C * 4, C, R)
    row = {"name": "fused_ab", "route": "cuda",
           "source": "tpuprof_torch/kernels/csrc/fused_ab.cu",
           "replaces": "tpuprof/kernels/fused.py:529",
           "shape": f"{C}x{R} bins={nbins}", "max_abs_err": worst_abs,
           "max_scaled_err": worst, "ms": t4, "plain_ms": p4,
           "bound_ms": b4, "bound_by": by4, "route_bound_ms": b4r,
           "bound_f32_ms": b4f, "library_ms": lib4}
    print_row(row)
    print("fused_ab library_ms: the Gram-only torch.matmul of K1's row",
          flush=True)
    return [row]


def gram_batches(C: int, R: int, seed: int, layouts):
    """The float64 phase's batches, (label, x, row_valid, shift, offset)
    each: the adversarial batch, and again at each (rows, offset) of
    ``layouts``; all-positive columns with shift 0 (every term
    of P, S1 and S2 positive: the sums the tensor cores' truncating
    float32 accumulation drifts on, 65,536 rows at the main path's
    batch); and a batch of extremes: a column at +-1e20 with shift 0 (d^2
    overflows, the split's non-finite guard), a column whose mean (1e6)
    is far above its spread (0.1), centred by its shift as the main path
    centres it, a small partner column (finite products with the 1e20
    one) and 5% missing values against it."""
    x, rv = adversarial_batch(C, R, seed)
    yield "adversarial", x, rv, finite_shift(x), False
    for k, (rows, offset) in enumerate(layouts):
        x, rv = adversarial_batch(C, rows, seed + 10 + k)
        yield ("adversarial" + (" offset" if offset else ""), x, rv,
               finite_shift(x), offset)
    rng = np.random.default_rng(seed + 1)
    ones = np.ones(R, dtype=bool)
    yield ("all-positive", rng.uniform(1.0, 2.0, (C, R)).astype(np.float32),
           ones, np.zeros(C, dtype=np.float32), False)
    x = rng.normal(5.0, 2.0, (C, R)).astype(np.float32)
    x[0] = np.float32(1e20) * rng.choice([-1.0, 1.0], R)
    x[1] = 1e6 + rng.normal(0.0, 0.1, R)
    x[2] = rng.normal(0.0, 1e-3, R)
    x[3, rng.random(R) < 0.05] = np.nan
    shift = finite_shift(x)
    shift[[0, 2]] = 0.0
    yield "extremes", x, ones, shift, False


def gram_f64(torch, xt, rvt, shift):
    """(P, S1, S2) in float64 from the float32 d, d^2 and m every version
    forms, and each entry's scale sum_r |a_r b_r|."""
    fin = rvt[None, :] & torch.isfinite(xt)
    d = torch.where(fin, xt - shift[:, None], 0.0)
    d64, q64, m64 = d.double(), (d * d).double(), fin.double()
    del d, fin
    exact = (d64 @ d64.T, d64 @ m64.T, q64 @ m64.T)
    d64.abs_()
    q64.abs_()
    return exact, (d64 @ d64.T, d64 @ m64.T, q64 @ m64.T)


def scaled_err(torch, got, exact, scale) -> float:
    """max |G - G64| / sum_r |a_r b_r| over the entries finite in both."""
    g = got.double()
    ok = torch.isfinite(g) & torch.isfinite(exact) & (scale > 0)
    if not ok.any():
        return 0.0
    return float(((g - exact).abs() / scale)[ok].max())


def phase_gram_f64(torch, device, rehearsal: bool):
    """The tensor-core Gram of K1, K3 (with and without ``skip_stats``),
    K4 and K5 against float64 on :func:`gram_batches`, beside the plain
    (cuBLAS float32) version on the same batch (K5's over the plain
    version's ranks of the batch against its sampled grid, shift 0.5).
    Fails if a kernel's largest scaled error exceeds 4x the plain
    version's (or one float32 rounding, 2^-24, where the plain version is
    nearer than that), if its non-finite entries are not the plain
    version's, or if its rho is more than 5e-4 from the float64 rho.
    Returns {kernel name: (the kernel's largest scaled error, the plain
    version's)}."""
    from tpuprof_torch.kernels import corr, fused
    R = 300 if rehearsal else 65536
    c1, c3 = (13, 40) if rehearsal else (200, 1024)
    if rehearsal:
        k1, k3, k4, k5 = fused.tiles_plain, fused.tiles_wide_plain, \
            fused.tiles_ab_plain, fused.spear_tiles_plain
        layouts = REHEARSAL_LAYOUTS
    else:
        k1, k3, k4, k5 = fused.tiles_cuda, fused.tiles_wide_cuda, \
            fused.tiles_ab_cuda, fused.spear_tiles_cuda
        layouts = LAYOUTS

    def pass_a(fn):
        """(the Gram, the values it is of, their shift) of a pass-A
        kernel."""
        return lambda xt, rv, sh, x: (fn(xt, rv, sh)[2:6], xt, sh)

    def spear(xt, rv, sh, x):
        grid = torch.from_numpy(
            sample_grid(x, fused.MAX_SPEAR_GRID, 121)).to(device)
        return (k5(xt, rv, grid), fused.rank_transform_plain(xt, rv, grid),
                torch.full_like(sh, 0.5))

    cases = [
        ("fused_a", "K1", c1, pass_a(k1)),
        ("fused_wide", "K3", c3, pass_a(k3)),
        ("fused_wide", "K3 skip_stats", c3,
         pass_a(lambda *a: k3(*a, skip_stats=True))),
        ("fused_ab", "K4", c1,
         pass_a(lambda xt, rv, sh: k4(xt, rv, sh, sh, sh + 1, sh, 10))),
        ("spear", "K5", c1, spear),
    ]
    out = {}
    for name, label, C, fn in cases:
        for what, x, rv, shift, offset in gram_batches(C, R, 120, layouts):
            xt = on_device(torch, device, x, offset)
            rvt = on_device(torch, device, rv, offset)
            got, vt, sh = fn(xt, rvt, torch.from_numpy(shift).to(device), x)
            plain = fused.tiles_plain(vt, rvt, sh)[2:6]
            exact, scale = gram_f64(torch, vt, rvt, sh)
            if device.type == "cuda":
                torch.cuda.synchronize()
            at = f"{label} at {C}x{x.shape[1]} {what}"
            require(torch.equal(got[3], plain[3]), f"{at}: N differs")
            ek = ep = 0.0
            for g, p, e, sc, s_name in zip(got, plain, exact, scale,
                                           ("P", "S1", "S2")):
                require(torch.equal(torch.isfinite(g), torch.isfinite(p))
                        and torch.equal(torch.isnan(g), torch.isnan(p)),
                        f"{at}: {s_name} is not finite, inf and NaN where "
                        "the plain version is")
                ek = max(ek, scaled_err(torch, g, e, sc))
                ep = max(ep, scaled_err(torch, p, e, sc))
            require(ek <= max(4 * ep, 2.0 ** -24),
                    f"{at}: scaled error {ek:.3e} over 4x the plain "
                    f"version's {ep:.3e}")
            c0 = corr.init(C, device)
            c0["shift"] = sh
            c0["set"].fill_(1)
            rho = corr.finalize(fused._fold_corr(c0, *got))
            rho64 = corr.finalize({"N": got[3], "S1": exact[1],
                                   "S2": exact[2], "P": exact[0]})
            both = np.isfinite(rho) & np.isfinite(rho64)
            drho = float(np.max(np.abs(rho - rho64)[both])) \
                if both.any() else 0.0
            require(drho <= ATOL_RHO, f"{at}: rho {drho:.3e} from float64")
            del got, plain, exact, scale, xt, vt
            prev = out.get(name, (0.0, 0.0))
            out[name] = (max(prev[0], ek), max(prev[1], ep))
            print(f"{at}: scaled error vs float64 {ek:.3e} (plain float32 "
                  f"{ep:.3e}), rho within {drho:.3e} of float64", flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------

def wide_frame(rows: int, cols: int, seed: int, block=None,
               strength: float = 3.0):
    """Float32 columns of rising scale and offset, 2% NaN, the first
    ``block`` columns (a quarter by default) sharing ``strength`` times
    one common normal."""
    import pandas as pd
    rng = np.random.default_rng(seed)
    base = rng.standard_normal((rows, 1), dtype=np.float32)
    data = rng.standard_normal((rows, cols), dtype=np.float32)
    data *= np.linspace(1.0, 20.0, cols, dtype=np.float32)[None, :]
    data += np.linspace(-100.0, 100.0, cols, dtype=np.float32)[None, :]
    block = cols // 4 if block is None else block
    data[:, :block] += np.float32(strength) * base     # a correlated block
    data[rng.random((rows, cols), dtype=np.float32) < 0.02] = np.nan
    return pd.DataFrame(data, columns=[f"c{i:04d}" for i in range(cols)])


def mixed_frame(n: int, seed: int):
    """Shaped like the reference backend tests' fixture: NaN, bool,
    const, categorical with nulls, date and a unique id."""
    import pandas as pd
    rng = np.random.default_rng(seed)
    fare = rng.gamma(2.0, 7.5, n)
    df = pd.DataFrame({
        "fare_amount": fare,
        "tip_amount": fare * 0.2 + rng.normal(0, 0.5, n),
        "trip_distance": rng.exponential(2.5, n),
        "passenger_count": rng.integers(1, 7, n).astype(np.int64),
        "vendor_id": rng.choice(["CMT", "VTS", "DDS"], n, p=[0.5, 0.4, 0.1]),
        "pickup_datetime": pd.Timestamp("2019-01-01") + pd.to_timedelta(
            rng.integers(0, 31 * 24 * 3600, n), unit="s"),
        "store_and_fwd": rng.random(n) < 0.3,
        "const_col": 1.0,
        "record_id": [f"id_{i:08d}" for i in range(n)],
    })
    df.loc[rng.choice(n, n // 10, replace=False), "fare_amount"] = np.nan
    df.loc[rng.choice(n, n // 20, replace=False), "vendor_id"] = None
    return df


def compare_stats(a, b, what: str) -> None:
    """Card result ``a`` against CPU result ``b`` at the test tolerances."""
    from tpuprof_torch import schema
    va, vb = a["variables"], b["variables"]
    require(list(va) == list(vb), f"{what}: column sets differ")
    for name, x in vb.items():
        y = va[name]
        require(y["type"] == x["type"], f"{what}: {name} type "
                f"{y['type']} vs {x['type']}")
        for fld in ("count", "n_missing", "distinct_count"):
            require(y[fld] == x[fld], f"{what}: {name}.{fld}")
        if x["type"] != schema.NUM:
            continue
        for fld in ("n_zeros", "n_infinite", "min", "max"):
            require(y[fld] == x[fld], f"{what}: {name}.{fld}")
        for fld in ("mean", "std", "variance", "sum", "mad", "skewness",
                    "kurtosis"):
            require(np.isclose(y[fld], x[fld], rtol=RTOL_MOM, atol=ATOL_MOM,
                               equal_nan=True),
                    f"{what}: {name}.{fld} {y[fld]} vs {x[fld]}")
        if x["histogram"] is not None:
            require(np.array_equal(y["histogram"][0], x["histogram"][0]),
                    f"{what}: {name} histogram counts differ")
    require(set(a["correlations"]) == set(b["correlations"]),
            f"{what}: correlation matrices differ")
    for method, cb in b["correlations"].items():
        ca = a["correlations"][method]
        ra, rb = np.asarray(ca, dtype=float), np.asarray(cb, dtype=float)
        require(ra.shape == rb.shape and np.allclose(
            ra, rb, rtol=0, atol=ATOL_RHO, equal_nan=True),
            f"{what}: {method} outside atol {ATOL_RHO}")
        require(ca.attrs.get("approx") == cb.attrs.get("approx"),
                f"{what}: {method} approx flags differ")


# kernel -> (its wrapper's module in tpuprof_torch.kernels, launch count)
COUNTERS = {"fused_a": ("fused", "launches"), "hist_b": ("hist", "launches"),
            "fused_wide": ("fused", "launches_wide"),
            "spear": ("fused", "launches_spear"),
            "rank": ("fused", "launches_rank"),
            "fused_ab": ("fused", "launches_ab")}


def _kernel_module(name: str):
    import importlib
    return importlib.import_module(f"tpuprof_torch.kernels.{name}")


def read_counts():
    """{kernel: launches} of every kernel's wrapper."""
    return {k: getattr(_kernel_module(m), attr)
            for k, (m, attr) in COUNTERS.items()}


def zero_counts() -> None:
    for m, attr in COUNTERS.values():
        setattr(_kernel_module(m), attr, 0)


def exported(stats) -> str:
    """The stats dict as its ``tpuprof-stats-v1`` export, canonical text:
    two profiles are exactly equal when these are."""
    from tpuprof_torch.report.export import stats_to_json
    return json.dumps(stats_to_json(stats), sort_keys=True)


def phases_text(stats) -> str:
    """The host seconds of a profile's phases (``stats["_phases"]``)."""
    phases = stats.get("_phases") or {}
    return "phases: " + ", ".join(
        f"{k} {phases[k]:.4f} s" for k in ("scan_a", "merge", "scan_b")
        if k in phases)


def phase_main_path(torch, rehearsal: bool, card: str):
    """Returns {kernel: launches in the run that is its main path}."""
    import atexit
    import shutil
    import tempfile

    import tpuprof_torch
    from tpuprof_torch import native, schema
    from tpuprof_torch.artifact import read_artifact, write_artifact
    from tpuprof_torch.runtime import singlepass

    # the host-bound rows/s below depend on which hash path ran: on the
    # card it must be the C++ library, not the numpy fallback
    hash_path = "native" if native.available() else "numpy fallback"
    if not rehearsal:
        require(native.available(), "the native hash library did not "
                "build; the rows/s would measure the numpy fallback")

    if rehearsal:
        n_wide, n_cut, n_mixed, batch = 4096, 2048, 3000, 512
        n_sp, n_sp_cut, cols_w, n_w, n_w_cut = 4096, 1024, 520, 1024, 512
        cols_p, n_p = 520, 1024
        dev_kw = {"device": "cpu"}
    else:
        n_wide, n_cut, n_mixed, batch = 2_097_152, 262_144, 1_000_000, 65536
        n_sp, n_sp_cut = 1_048_576, 65_536
        cols_w, n_w, n_w_cut = 2048, 131_072, 8_192
        cols_p, n_p = 1024, 131_072
        dev_kw = {}                     # the default device: cuda:0
    cols = 200
    tmp = tempfile.mkdtemp(prefix="chip-smoke-")   # the seed artifacts
    atexit.register(shutil.rmtree, tmp, True)

    def run(df, label, need=(), exactly=(), **kw):
        """describe ``df`` with every launch count set to 0 just before
        and read just after; ``need`` = ((kernel, launches per batch),
        ...) that the run must reach, ``exactly`` = ((kernel, launches),
        ...) it must show.  Returns (stats, counts, seconds)."""
        zero_counts()
        if not rehearsal:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        kw.setdefault("batch_rows", batch)
        stats = tpuprof_torch.describe(df, **kw)
        secs = time.perf_counter() - t0
        counts = read_counts()
        n_batches = -(-len(df) // kw["batch_rows"])
        require(schema.validate_stats(stats) == [],
                f"{label}: validate_stats failed")
        if "device" not in kw:
            for name, per_batch in need:
                require(counts[name] >= per_batch * n_batches,
                        f"{label}: {name} launched {counts[name]} times "
                        f"for {n_batches} batches")
            for name, n in exactly:
                require(counts[name] == n, f"{label}: {name} launched "
                        f"{counts[name]} times, expected {n}")
        shown = ", ".join(f"{k} {v}" for k, v in counts.items())
        print(f"{label}: {len(df)} rows x {df.shape[1]} cols in "
              f"{secs:.3f} s = {len(df) / secs:.0f} rows/s on {card}; "
              f"hash path {hash_path}; launches: {shown}; "
              f"{phases_text(stats)}", flush=True)
        return stats, counts, secs

    def against_cpu(df, label, **kw):
        on_card, _, _ = run(df, label, **kw, **dev_kw)
        on_cpu, _, _ = run(df, f"{label} (cpu)", **kw, device="cpu")
        compare_stats(on_card, on_cpu, label)
        print(f"{label}: card result matches the CPU result", flush=True)
        return on_card

    def same(a, b, what: str) -> None:
        require(exported(a) == exported(b),
                f"{what}: the fused profile differs from two-pass")
        print(f"{what}: stats_to_json equal to the two-pass profile's",
              flush=True)

    def warm(df, two, label, expect_lanes, **kw):
        """A fused run seeded from an artifact of the two-pass stats
        ``two``: every lane must hit, and no re-bin run."""
        art = f"{tmp}/{label.replace(' ', '_')}.json"
        write_artifact(art, stats=two, config=tpuprof_torch.ProfilerConfig(
            batch_rows=batch))
        t0 = time.perf_counter()
        read_artifact(art)
        print(f"{label}: its seed artifact, {os.path.getsize(art)} bytes, "
              f"reads and checks in {time.perf_counter() - t0:.3f} s",
              flush=True)
        h0, m0 = singlepass.edge_hits, singlepass.edge_misses
        r0 = singlepass.rebins
        stats, counts, secs = run(df, label, profile_passes="fused",
                                  seed_edges=art, **kw)
        hits = singlepass.edge_hits - h0
        require(hits == expect_lanes and singlepass.edge_misses == m0
                and singlepass.rebins == r0,
                f"{label}: {hits} of {expect_lanes} lanes hit")
        print(f"{label}: all {hits} lanes hit, no re-bin", flush=True)
        return stats, counts, secs

    n_batches = -(-n_wide // batch)
    a_b = (("fused_a", 1), ("hist_b", 1))
    wide = headline_frame(n_wide, cols)     # phases 7 and 8 reuse it
    two_ab, main_ab, t_two = run(wide, f"describe {cols} cols", need=a_b,
                                 exactly=(("fused_ab", 0),),
                                 scan_batches=8, **dev_kw)
    # single-pass profiles of the same table: cold (edges sketched from
    # the first batch; missed lanes re-bin with K2), then warm (edges
    # seeded from an artifact of the two-pass profile: no second scan)
    r0 = singlepass.rebins
    cold, c_cold, t_cold = run(
        wide, f"describe {cols} cols fused cold",
        exactly=(("fused_ab", n_batches), ("fused_a", 0)),
        profile_passes="fused", scan_batches=8, **dev_kw)
    rebinned = singlepass.rebins - r0
    require(rehearsal or c_cold["hist_b"] == n_batches * rebinned,
            f"fused cold: {c_cold['hist_b']} K2 launches for {rebinned} "
            "re-bin scan(s)")
    print(f"fused cold: {rebinned} re-bin scan(s) of "
          f"{singlepass.rebin_lanes} missed lanes so far", flush=True)
    same(cold, two_ab, "fused cold")
    warm_st, main_fab, t_warm = warm(
        wide, two_ab, f"describe {cols} cols fused warm", cols,
        exactly=(("fused_ab", n_batches), ("fused_a", 0), ("hist_b", 0)),
        scan_batches=8, **dev_kw)
    same(warm_st, two_ab, "fused warm")
    # host times vary between machines and the first run of a call pays
    # warm-ups: a second two-pass and warm pair, in turn, on the same card
    _, _, t_two2 = run(wide, f"describe {cols} cols (again)",
                       exactly=(("fused_ab", 0),), scan_batches=8, **dev_kw)
    _, _, t_warm2 = warm(
        wide, two_ab, f"describe {cols} cols fused warm (again)", cols,
        exactly=(("fused_ab", n_batches), ("fused_a", 0), ("hist_b", 0)),
        scan_batches=8, **dev_kw)
    shown = ", ".join(f"{what} {t:.3f} s ({n_wide / t:.0f} rows/s)"
                      for what, t in (("two-pass", t_two), ("cold", t_cold),
                                      ("warm", t_warm),
                                      ("two-pass", t_two2),
                                      ("warm", t_warm2)))
    print(f"headline {n_wide} x {cols} in run order: {shown} on {card}",
          flush=True)
    del cold, warm_st
    cut = wide.iloc[:n_cut].reset_index(drop=True)
    del wide
    against_cpu(cut, "describe cut", scan_batches=8)
    against_cpu(cut, "describe cut fused", scan_batches=8,
                profile_passes="fused")
    del cut

    mixed = mixed_frame(n_mixed, seed=42)
    two_mixed = against_cpu(mixed, "describe mixed")
    # its categorical columns need the top-k recount: a second scan
    # whatever the edges
    fused_mixed, _, _ = run(mixed, "describe mixed fused",
                            profile_passes="fused", **dev_kw)
    same(fused_mixed, two_mixed, "mixed fused")
    del mixed

    # Spearman at 200 columns: K5 folds the batches pass B ships
    sp = wide_frame(n_sp, cols, seed=3)
    _, main_sp, _ = run(sp, f"describe {cols} cols spearman",
                        need=a_b + (("spear", 1),), spearman=True,
                        scan_batches=8, **dev_kw)
    cut = sp.iloc[:n_sp_cut].reset_index(drop=True)
    del sp
    against_cpu(cut, "describe spearman cut", spearman=True, scan_batches=8)
    del cut

    # past 512 columns a single-pass profile pairs K3 and K2 on each
    # shipped batch
    pt = wide_frame(n_p, cols_p, seed=5)
    n_pb = -(-n_p // batch)
    two_p, _, _ = run(pt, f"describe {cols_p} cols", **dev_kw)
    paired, _, _ = warm(pt, two_p, f"describe {cols_p} cols fused warm",
                        cols_p, exactly=(("fused_wide", n_pb),
                                         ("hist_b", n_pb), ("fused_ab", 0),
                                         ("fused_a", 0)), **dev_kw)
    same(paired, two_p, f"fused warm {cols_p} cols")
    del pt, two_p, paired

    # the widest table the kernels take: K3 for pass A and for the rank
    # Gram, K6 for the ranks, K2 for pass B
    wt = wide_frame(n_w, cols_w, seed=4, block=16, strength=30.0)
    _, main_w, _ = run(wt, f"describe {cols_w} cols spearman",
                       need=(("fused_wide", 2), ("hist_b", 1), ("rank", 1)),
                       spearman=True, **dev_kw)
    cut = wt.iloc[:n_w_cut].reset_index(drop=True)
    del wt
    # in batches of its own size: every batch is padded to batch_rows,
    # and the CPU's plain rank of a padded 65,536-row batch takes minutes
    against_cpu(cut, "describe wide spearman cut", spearman=True,
                batch_rows=n_w_cut)
    return {"fused_a": main_ab["fused_a"], "hist_b": main_ab["hist_b"],
            "spear": main_sp["spear"], "fused_wide": main_w["fused_wide"],
            "rank": main_w["rank"], "fused_ab": main_fab["fused_ab"]}


# ---------------------------------------------------------------------------
# phase 5: the command line on the card
# ---------------------------------------------------------------------------

# the last stderr line of a successful ``profile``
PROFILE_LINE = r"^tpuprof_torch: ([\d,]+) rows x (\d+) cols -> (.+) in " \
    r"[\d.]+s \(([\d,]+) rows/s\)$"
# the report footer's scan line (``report/render.py::_perf_line``)
FOOTER = r"([\d,]+) rows/s · ((?:\w+ [\d.]+s(?: · )?)+)"


def without_layout(stats) -> dict:
    """The export with ``memorysize`` dropped from the table and every
    column: the one field that measures the Arrow layout (a Parquet read's
    validity bitmaps and row-group dictionaries) and not the values."""
    from tpuprof_torch.report.export import stats_to_json
    doc = json.loads(json.dumps(stats_to_json(stats)))
    for section in (doc, doc["display"]):
        section["table"].pop("memorysize")
        for var in section["variables"].values():
            var.pop("memorysize")
    return doc


def from_artifact(path: str):
    """An artifact as the parts of a stats dict ``compare_stats`` reads:
    the exported columns (null as NaN), the sketches' histograms and the
    correlation matrices."""
    import pandas as pd
    from tpuprof_torch.artifact import read_artifact
    art = read_artifact(path)
    hists = art.sketches["histograms"]
    variables = {}
    for name, v in art.stats["variables"].items():
        v = {k: np.nan if x is None else x for k, x in v.items()}
        h = hists.get(name)
        v["histogram"] = None if h is None else (np.array(h["counts"]),
                                                 np.array(h["edges"]))
        variables[name] = v
    correlations = {}
    for method, e in art.stats["correlations"].items():
        m = pd.DataFrame([[e["matrix"][r][c] for c in e["columns"]]
                          for r in e["columns"]], index=e["columns"],
                         columns=e["columns"], dtype=float)
        if e["approx"]:         # as the stats dict: set only when True
            m.attrs["approx"] = True
        correlations[method] = m
    return {"variables": variables, "correlations": correlations}


def child(argv, timeout=600):
    """``python -X importtime -m tpuprof_torch ARGV`` from the checkout:
    (exit code, its stderr lines but the import times, the top-level
    names of every module it imported, seconds)."""
    import re
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-X", "importtime", "-m",
                          "tpuprof_torch", *argv], cwd=root, env=env,
                         capture_output=True, text=True, timeout=timeout)
    secs = time.perf_counter() - t0
    lines = out.stderr.splitlines()
    mods = {re.split(r"\s*\|\s*", ln)[-1].strip().split(".")[0]
            for ln in lines if ln.startswith("import time:")}
    rest = [ln for ln in lines if not ln.startswith("import time:")]
    return out.returncode, rest, mods, secs


def footer_phases(html_path: str) -> str:
    """The phases a child's report shows in its footer (to 0.01 s: the
    child's stats dict does not outlive it)."""
    import re
    with open(html_path, encoding="utf-8") as fh:
        m = re.search(FOOTER, fh.read())
    require(m is not None, f"{html_path}: no scan line in the footer")
    return f"footer {m.group(1)} rows/s, {m.group(2)}"


def drifted_frame(df):
    """``fare_amount`` shifted by one standard deviation, and the share of
    one-passenger trips raised from about 1/6 to 1/2 (an integer-coded
    category: the drift engine reads a string column only through its
    top-k set, distinct count and missing share)."""
    out = df.copy()
    out["fare_amount"] = out["fare_amount"] + out["fare_amount"].std()
    rng = np.random.default_rng(43)
    out.loc[rng.random(len(out)) < 0.4, "passenger_count"] = 1
    return out


def cli_profile(torch, rehearsal: bool, card: str, stem: str, argv,
                exactly=()):
    """``cli.main(["profile", *argv])`` with every launch count set to 0
    just before and read just after, writing ``stem``.html and ``--stats-json``
    ``stem``.json, both checked against its stats; ``exactly`` =
    ((kernel, launches), ...) the run must show (on the card).  Returns the
    stats."""
    from tpuprof_torch import cli
    from tpuprof_torch.obs.spans import get_phase_report
    from tpuprof_torch.report import render

    label = os.path.basename(stem).replace("_", " ")
    html, js = f"{stem}.html", f"{stem}.json"
    seen = {}
    real_page = render.to_standalone_html

    def capture(stats, config, **kw):
        seen["stats"], seen["config"] = stats, config
        return real_page(stats, config, **kw)

    render.to_standalone_html = capture
    try:
        zero_counts()
        if not rehearsal:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        rc = cli.main(["profile", *argv, "-o", html, "--stats-json", js])
        secs = time.perf_counter() - t0
    finally:
        render.to_standalone_html = real_page
    counts = read_counts()
    render_s = get_phase_report(reset=True).get("render")
    require(rc == 0, f"{label}: profile exited {rc}")
    stats = seen["stats"]
    if not rehearsal:
        for name, n in exactly:
            require(counts[name] == n, f"{label}: {name} launched "
                    f"{counts[name]} times, expected {n}")
    with open(html, encoding="utf-8") as fh:
        require(fh.read() == real_page(stats, seen["config"]),
                f"{label}: the HTML is not to_standalone_html of its stats")
    with open(js) as fh:
        require(json.load(fh) == json.loads(exported(stats)),
                f"{label}: --stats-json is not the stats' export")
    n = stats["table"]["n"]
    shown = ", ".join(f"{k} {v}" for k, v in counts.items())
    print(f"{label}: {n} rows x {stats['table']['nvar']} cols in "
          f"{secs:.3f} s = {n / secs:.0f} rows/s on {card}; "
          f"launches: {shown}; {phases_text(stats)}; render "
          f"{render_s:.4f} s", flush=True)
    return stats


def phase_cli(torch, rehearsal: bool, card: str) -> None:
    """``profile`` in process on a Parquet directory of the headline table
    (two-pass, then fused warm from its artifact), then ``python -m
    tpuprof_torch profile`` and ``diff`` as child processes on a mixed
    Parquet file and a drifted copy of it."""
    import atexit
    import re
    import shutil
    import tempfile

    import pyarrow as pa
    import pyarrow.parquet as pq

    import tpuprof_torch
    from tpuprof_torch.runtime import singlepass

    if rehearsal:
        n_head, batch, n_mixed = 4096, 256, 3000
        dev, dev_kw = ["--device", "cpu"], {"device": "cpu"}
    else:
        n_head, batch, n_mixed = 1_048_576, 65_536, 1_000_000
        dev, dev_kw = [], {}
    cols, files = 200, 4
    n_batches = n_head // batch
    tmp = tempfile.mkdtemp(prefix="chip-smoke-cli-")
    atexit.register(shutil.rmtree, tmp, True)

    wide = wide_frame(n_head, cols, seed=6)
    head_dir = f"{tmp}/headline"
    os.makedirs(head_dir)
    t0 = time.perf_counter()
    table = pa.Table.from_pandas(wide, preserve_index=False)
    per = n_head // files
    for i in range(files):
        pq.write_table(table.slice(i * per, per),
                       f"{head_dir}/part{i}.parquet", row_group_size=batch)
    del table
    print(f"cli: wrote {n_head} x {cols} float32 as {files} Parquet files, "
          f"row groups of {batch}, in {time.perf_counter() - t0:.3f} s",
          flush=True)

    def profile(label, argv, exactly):
        return cli_profile(torch, rehearsal, card,
                           f"{tmp}/{label.replace(' ', '_')}",
                           [*argv, "--batch-rows", str(batch), *dev],
                           exactly)

    art = f"{tmp}/headline.artifact.json"
    two = profile("cli headline", [head_dir, "--artifact", art],
                  (("fused_a", n_batches), ("hist_b", n_batches),
                   ("fused_ab", 0), ("fused_wide", 0)))
    h0, m0, r0 = (singlepass.edge_hits, singlepass.edge_misses,
                  singlepass.rebins)
    warm = profile("cli headline fused warm",
                   [head_dir, "--profile-passes", "fused",
                    "--seed-edges", art],
                   (("fused_ab", n_batches), ("fused_a", 0),
                    ("hist_b", 0), ("fused_wide", 0)))
    hits = singlepass.edge_hits - h0
    require(hits == cols and singlepass.edge_misses == m0
            and singlepass.rebins == r0,
            f"cli fused warm: {hits} of {cols} lanes hit")
    require(exported(warm) == exported(two),
            "cli fused warm: stats_to_json differs from two-pass")
    print(f"cli fused warm: all {hits} lanes hit, no re-bin, "
          "stats_to_json equal to the two-pass profile's", flush=True)
    t0 = time.perf_counter()
    on_df = tpuprof_torch.describe(wide, batch_rows=batch, **dev_kw)
    secs = time.perf_counter() - t0
    require(without_layout(two) == without_layout(on_df),
            "cli headline: the Parquet profile differs from describe(df) "
            "beyond memorysize")
    print(f"cli headline: equal to describe(df) of the same frame "
          f"({secs:.3f} s, {phases_text(on_df)}) except memorysize "
          f"(Parquet {two['table']['memorysize']:.0f} B, DataFrame "
          f"{on_df['table']['memorysize']:.0f} B)", flush=True)
    del wide, two, warm, on_df

    mixed = mixed_frame(n_mixed, seed=42)
    paths = {"a1": f"{tmp}/mixed.parquet", "a2": f"{tmp}/drifted.parquet"}
    t0 = time.perf_counter()
    for key, df in (("a1", mixed), ("a2", drifted_frame(mixed))):
        pq.write_table(pa.Table.from_pandas(df, preserve_index=False),
                       paths[key])
    del mixed
    print(f"cli: wrote the {n_mixed}-row mixed frame and its drifted copy "
          f"as Parquet in {time.perf_counter() - t0:.3f} s", flush=True)
    for key, path in paths.items():
        html, art = f"{tmp}/{key}.html", f"{tmp}/{key}.json"
        rc, err, mods, secs = child(["profile", path, "-o", html,
                                     "--artifact", art, *dev])
        require(rc == 0, f"python -m tpuprof_torch profile {key}: exit "
                f"{rc}: {err[-5:]}")
        require(len(err) == 1 and re.match(PROFILE_LINE, err[0]),
                f"profile {key}: stderr {err[-5:]}")
        bad = sorted(mods & {"jax", "jaxlib", "tpuprof"})
        require(not bad and "tpuprof_torch" in mods,
                f"profile {key}: the child loaded {bad}")
        print(f"python -m tpuprof_torch profile {key}: exit 0 in "
              f"{secs:.3f} s (process included) on {card}; no jax, no "
              f"tpuprof module; {err[0]}; {footer_phases(html)}",
              flush=True)
    t0 = time.perf_counter()
    on_cpu = tpuprof_torch.describe(paths["a1"], device="cpu",
                                    batch_rows=batch)
    compare_stats(from_artifact(f"{tmp}/a1.json"), on_cpu, "cli mixed")
    print(f"cli mixed: the child's artifact matches describe(path, "
          f"device='cpu') ({time.perf_counter() - t0:.3f} s)", flush=True)

    changed = {"fare_amount", "passenger_count"}
    dj = f"{tmp}/drift.json"
    argv = ["diff", f"{tmp}/a1.json", f"{tmp}/a2.json", "-o",
            f"{tmp}/drift.html", "--json", dj]
    rc, err, mods, secs = child(argv)
    require(rc == 0, f"diff: exit {rc}, expected 0: {err[-5:]}")
    require(not mods & {"jax", "jaxlib", "tpuprof"},
            "diff: the child loaded jax or tpuprof")
    print(f"python -m tpuprof_torch diff: exit 0 in {secs:.3f} s; "
          f"{err[-1]}", flush=True)
    # --fail-on-drift in process: a second child would only pay the
    # process start again
    from tpuprof_torch import cli
    rc = cli.main([*argv, "--fail-on-drift"])
    require(rc == 1, f"diff --fail-on-drift: exit {rc}, expected 1")
    print("tpuprof_torch diff --fail-on-drift: exit 1", flush=True)
    with open(dj) as fh:
        status = {c: e["status"] for c, e in json.load(fh)["columns"].items()}
    drifting = {c for c, st in status.items() if st == "drift"}
    require(drifting == changed and all(
        st == "ok" for c, st in status.items() if c not in changed),
        f"diff: statuses {status}")
    print(f"diff: {sorted(drifting)} at drift, the other "
          f"{len(status) - len(drifting)} columns ok", flush=True)
    return head_dir, f"{tmp}/headline.artifact.json", batch


# ---------------------------------------------------------------------------
# phase 6: the rest of host ingest
# ---------------------------------------------------------------------------

CITIES = ("ams", "ber", "cph", "dub", "hel", "lis", "osl", "vie")


def ingest_table(rows: int, cols: int, seed: int):
    """The headline's float32 columns (``wide_frame``) and four more:
    ``tags`` list<string> of 0-4 words of a 50-word vocabulary, ``meta``
    struct<a: int64, b: string>, ``uid`` (about one distinct value a row)
    and ``city`` (8 values); a tenth of ``tags`` and a twelfth of ``meta``
    null."""
    import pyarrow as pa
    import pyarrow.compute as pc
    rng = np.random.default_rng(seed)
    table = pa.Table.from_pandas(wide_frame(rows, cols, seed),
                                 preserve_index=False)
    vocab = pa.array([f"word{i:02d}" for i in range(50)])
    lens = rng.integers(0, 5, rows)
    null_tags = rng.random(rows) < 0.1
    lens[null_tags] = 0         # Parquet writes only empty null lists
    offsets = np.zeros(rows + 1, dtype=np.int32)
    np.cumsum(lens, out=offsets[1:])
    tags = pa.ListArray.from_arrays(
        pa.array(offsets), vocab.take(pa.array(
            rng.integers(0, 50, int(offsets[-1])))),
        mask=pa.array(null_tags))
    meta = pa.StructArray.from_arrays(
        [pa.array(rng.integers(0, 20, rows)),
         vocab.take(pa.array(rng.integers(0, 50, rows)))],
        names=["a", "b"], mask=pa.array(rng.random(rows) < 1 / 12))
    uid = pc.cast(pa.array(rng.integers(0, 10 ** 12, rows)), pa.string())
    city = pa.array(np.array(CITIES)[rng.integers(0, len(CITIES), rows)])
    for name, arr in (("tags", tags), ("meta", meta), ("uid", uid),
                      ("city", city)):
        table = table.append_column(name, arr)
    return table


def phase_ingest(torch, rehearsal: bool, card: str, seed: int) -> None:
    """The ingest slice on the card: nested columns, the prep pools, the
    row-hash path and the ingest guard, on one frame in memory and as a
    Parquet directory."""
    import atexit
    import collections
    import shutil
    import tempfile

    import pyarrow.parquet as pq

    import tpuprof_torch
    from tpuprof_torch import native
    from tpuprof_torch.config import resolve_prepare_workers
    from tpuprof_torch.errors import WatchdogTimeout
    from tpuprof_torch.ingest import arrow as ingest_arrow
    from tpuprof_torch.report.render import to_standalone_html
    from tpuprof_torch.runtime import singlepass
    from tpuprof_torch.testing import faults

    if rehearsal:
        # batches above ROWHASH_MIN_DISTINCT rows: the row-hash path runs
        rows, batch, cols = 4 * 20_000, 20_000, 8
        dev, dev_kw = ["--device", "cpu"], {"device": "cpu"}
    else:
        # 8 batches: a depth cut to keep the script inside its time limit
        # with phases 7 and 8
        rows, batch, cols = 524_288, 65_536, 200
        dev, dev_kw = [], {}
        require(native.available(), "the native hash library did not "
                "build: the row-hash path needs it")
    n_batches = rows // batch
    tmp = tempfile.mkdtemp(prefix="chip-smoke-ingest-")
    atexit.register(shutil.rmtree, tmp, True)
    t0 = time.perf_counter()
    table = ingest_table(rows, cols, seed)
    print(f"ingest: made {rows} rows x {table.num_columns} cols (seed "
          f"{seed}) in {time.perf_counter() - t0:.3f} s", flush=True)

    # which path each string column took, batch by batch, in pass A
    paths = collections.Counter()
    real_prepare = ingest_arrow.prepare_batch

    def counting(rb, plan, *a, **kw):
        hb = real_prepare(rb, plan, *a, **kw)
        if hb.cat_hashes is not None:
            for spec in plan.by_role("cat"):
                path = "opaque" if spec.opaque else "row-hash" \
                    if spec.name in hb.cat_hashed else "dictionary"
                paths[spec.name, path] += 1
        return hb

    walls = {}

    def run(label, exactly=(), **kw):
        """describe the table with every launch count set to 0 just before
        and read just after; returns the stats."""
        zero_counts()
        if not rehearsal:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        stats = tpuprof_torch.describe(table, batch_rows=batch, **dev_kw,
                                       **kw)
        walls[label] = secs = time.perf_counter() - t0
        counts = read_counts()
        if not rehearsal:
            for name, n in exactly:
                require(counts[name] == n, f"{label}: {name} launched "
                        f"{counts[name]} times, expected {n}")
        shown = ", ".join(f"{k} {v}" for k, v in counts.items())
        n = stats["table"]["n"]
        print(f"{label}: {n} rows x {stats['table']['nvar']} cols in "
              f"{secs:.3f} s = {n / secs:.0f} rows/s on {card}; launches: "
              f"{shown}; {phases_text(stats)}", flush=True)
        return stats

    # 6.1 in memory: the prep pools at three widths, the row-hash path
    two_pass = (("fused_a", n_batches), ("hist_b", n_batches),
                ("fused_ab", 0))
    ingest_arrow.prepare_batch = counting
    try:
        serial = run("ingest prep_workers=1", two_pass, prep_workers=1)
        took = dict(paths)
        base = run("ingest prep_workers default", two_pass)
        wide = run("ingest prep_workers=8", two_pass, prep_workers=8)
    finally:
        ingest_arrow.prepare_batch = real_prepare
    require(exported(serial) == exported(base) == exported(wide),
            "ingest: the profile differs between prep widths")
    print("ingest: stats_to_json equal at prep_workers 1, default and 8",
          flush=True)
    for name in ("tags", "meta", "uid", "city"):
        shown = ", ".join(f"{p} {took[name, p]}"
                          for p in ("dictionary", "row-hash")
                          if (name, p) in took)
        print(f"ingest: {name} took, of {n_batches} batches: {shown}",
              flush=True)
    # a batch takes the row-hash path once an earlier batch's distinct
    # count is known: the prepares in flight with the first one cannot
    in_flight = resolve_prepare_workers(None)
    require(1 <= took.get(("uid", "dictionary"), 0) <= in_flight
            and took.get(("uid", "row-hash"), 0) >= n_batches - in_flight,
            "ingest: uid did not leave the dictionary path after its "
            "first batches")
    require(took.get(("city", "dictionary")) == n_batches,
            "ingest: city left the dictionary path")
    for name in ("tags", "meta"):
        v = base["variables"][name]
        require(v["type"] == "CAT" and v["distinct_count"] > 1
                and name in base["freq"], f"ingest: {name} not profiled "
                "through its str() form")

    # 6.2 the Parquet directory through the command line
    pdir = f"{tmp}/ingest"
    os.makedirs(pdir)
    per = rows // 4
    for i in range(4):
        pq.write_table(table.slice(i * per, per), f"{pdir}/part{i}.parquet",
                       row_group_size=batch)
    art = f"{tmp}/ingest.artifact.json"
    flags = ["--batch-rows", str(batch), *dev]
    two = cli_profile(torch, rehearsal, card, f"{tmp}/cli_ingest",
                      [pdir, "--nested", "stringify", "--artifact", art,
                       *flags], two_pass)
    require(without_layout(two) == without_layout(base),
            "cli ingest: the Parquet profile differs from describe(table) "
            "beyond memorysize")
    print("cli ingest: equal to describe(table) except memorysize",
          flush=True)
    h0, m0 = singlepass.edge_hits, singlepass.edge_misses
    warm = cli_profile(torch, rehearsal, card,
                       f"{tmp}/cli_ingest_fused_warm",
                       [pdir, "--profile-passes", "fused", "--seed-edges",
                        art, *flags],
                       (("fused_ab", n_batches), ("fused_a", 0),
                        ("hist_b", 0)))
    require(singlepass.edge_hits - h0 == cols
            and singlepass.edge_misses == m0,
            "cli ingest fused warm: not every lane hit")
    require(exported(warm) == exported(two),
            "cli ingest fused warm: stats_to_json differs from two-pass")
    print(f"cli ingest fused warm: all {cols} lanes hit, stats_to_json "
          "equal to two-pass", flush=True)
    opaque = cli_profile(torch, rehearsal, card, f"{tmp}/cli_ingest_opaque",
                         [pdir, "--nested", "opaque", *flags], two_pass)
    for name in ("tags", "meta"):
        v, w = opaque["variables"][name], two["variables"][name]
        require(v["distinct_count"] is None and v["mode"] is None
                and v["freq"] == 0 and name not in opaque["freq"]
                and (v["count"], v["n_missing"], v["memorysize"])
                == (w["count"], w["n_missing"], w["memorysize"]),
                f"cli ingest opaque: {name} is not count/missing/memory "
                "only")
    print("cli ingest opaque: tags and meta carry count, missing and "
          "memory only", flush=True)

    # 6.3 the ingest guard at the same size (nested="opaque": the fault
    # paths do not need the str() loop)
    clean = run("guard clean", two_pass, nested="opaque")
    run("guard clean prep_workers=1", nested="opaque", prep_workers=1)
    try:
        faults.configure("prep:2@3")
        got = run("guard transient x2", nested="opaque", ingest_retries=2)
        require(faults.injected("prep") == 2 and "_quarantine" not in got
                and exported(got) == exported(clean),
                "guard: two retried transients changed the profile")
        print("guard: 2 transient prepare faults retried, profile equal to "
              "the clean run", flush=True)
        log = f"{tmp}/quarantine.jsonl"
        faults.configure("prep:fatal@3")
        got = run("guard poison", nested="opaque", max_quarantined=1,
                  quarantine_log=log)
        entries = got.get("_quarantine") or []
        with open(log) as fh:
            logged = [json.loads(ln) for ln in fh]
        require(len(entries) == 1 and logged == entries
                and got["table"]["n"] == rows - batch
                and "Degraded run" in to_standalone_html(
                    got, tpuprof_torch.ProfilerConfig()),
                f"guard: poison batch: {entries}, n {got['table']['n']}")
        print(f"guard: one poison batch quarantined ({entries[0]}), n "
              f"{got['table']['n']}, degraded banner, one log line",
              flush=True)
        faults.configure("prep:fatal@3")
        try:
            run("guard poison, no budget", nested="opaque")
            fail("guard: a poison batch with max_quarantined=0 did not "
                 "raise")
        except RuntimeError as exc:
            require("injected fatal" in str(exc), f"guard: {exc}")
        print("guard: with max_quarantined=0 the poison batch fails the "
              "profile", flush=True)
        faults.configure("device_wait:sleep=3")
        t0 = time.perf_counter()
        try:
            run("guard drain", nested="opaque", drain_timeout_s=1.0)
            fail("guard: a 3 s drain under a 1 s watchdog did not raise")
        except WatchdogTimeout as exc:
            require(exc.site == "device_wait"
                    and exc.heartbeat["rows"] == rows, f"guard: {exc}")
            print(f"guard: WatchdogTimeout after "
                  f"{time.perf_counter() - t0:.3f} s: {exc}", flush=True)
    finally:
        faults.reset()
    print("ingest walls on " + card + ": " + ", ".join(
        f"{k} {v:.3f} s" for k, v in walls.items()), flush=True)


# ---------------------------------------------------------------------------
# phases 7 and 8: past the kernels' limits, durable profiles
# ---------------------------------------------------------------------------

_HEADLINE = {}


def headline_frame(rows: int, cols: int):
    """The headline table (``wide_frame``, seed 1), made once a process."""
    key = (rows, cols)
    if key not in _HEADLINE:
        _HEADLINE.clear()
        _HEADLINE[key] = wide_frame(rows, cols, seed=1)
    return _HEADLINE[key]


def counted(torch, rehearsal: bool, card: str, df, label: str,
            exactly=(), **kw):
    """``describe(df, **kw)`` with every launch count set to 0 just before
    and read just after; ``exactly`` = ((kernel, launches), ...) the run
    must show on the card.  Prints its wall time, rows/s, launches and
    phase seconds; returns (stats, seconds)."""
    import tpuprof_torch
    zero_counts()
    if not rehearsal:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    stats = tpuprof_torch.describe(df, **kw)
    secs = time.perf_counter() - t0
    counts = read_counts()
    if not rehearsal and kw.get("device") != "cpu":
        for name, n in exactly:
            require(counts[name] == n, f"{label}: {name} launched "
                    f"{counts[name]} times, expected {n}")
    shown = ", ".join(f"{k} {v}" for k, v in counts.items())
    n = stats["table"]["n"]
    print(f"{label}: {n} rows x {stats['table']['nvar']} cols in "
          f"{secs:.3f} s = {n / secs:.0f} rows/s on {card}; launches: "
          f"{shown}; {phases_text(stats)}", flush=True)
    return stats, secs


def _without_matrices(stats):
    """``stats`` with empty correlation matrices: what an export of a
    wide table spends most of its bytes and seconds on."""
    import pandas as pd
    return dict(stats, correlations={"pearson": pd.DataFrame()})


def _no_kernels_but_k2(n_batches: int):
    """Past 2,048 columns only K2 launches: the twin and the exact tier
    are PyTorch calls."""
    return (("fused_a", 0), ("fused_wide", 0), ("spear", 0), ("rank", 0),
            ("fused_ab", 0), ("hist_b", n_batches))


def phase_limits(torch, rehearsal: bool, card: str) -> None:
    """2,112 columns against the CPU; 4,096 x 131,072 two-pass with
    Spearman and fused warm, with peak device memory and the times of the
    routes that are not kernels; the headline at 16,384 bins, two-pass and
    fused warm, each histogram held against the 8,192-bin one."""
    import atexit
    import shutil
    import tempfile

    import tpuprof_torch
    from tpuprof_torch.artifact import write_artifact
    from tpuprof_torch.kernels import corr, fused, moments
    from tpuprof_torch.runtime import singlepass

    if rehearsal:
        c1, n1, c2, n2, batch2 = 2056, 1024, 2060, 2048, 1024
        cols_h, n_head, batch, big = 20, 4096, 512, 2 * 1024
        dev_kw = {"device": "cpu"}
    else:
        c1, n1, c2, n2, batch2 = 2112, 32_768, 4096, 131_072, 65_536
        cols_h, n_head, batch, big = 200, 2_097_152, 65_536, 16_384
        dev_kw = {}
    tmp = tempfile.mkdtemp(prefix="chip-smoke-limits-")
    atexit.register(shutil.rmtree, tmp, True)

    # 7.1 past 2,048 columns, held against the port's CPU run
    w1 = wide_frame(n1, c1, seed=11, block=16, strength=30.0)
    for extra in ({}, {"spearman": True}):
        tag = "spearman" if extra else "two-pass"
        on_card, _ = counted(torch, rehearsal, card, w1,
                             f"describe {c1} cols {tag}",
                             _no_kernels_but_k2(1), batch_rows=n1,
                             **extra, **dev_kw)
        on_cpu, _ = counted(torch, True, card, w1,
                            f"describe {c1} cols {tag} (cpu)",
                            batch_rows=n1, device="cpu", **extra)
        compare_stats(on_card, on_cpu, f"{c1} cols {tag}")
        print(f"{c1} cols {tag}: the card's result matches the CPU's",
              flush=True)
    del w1, on_card, on_cpu

    # 7.2 4,096 columns in two device batches
    w2 = wide_frame(n2, c2, seed=12, block=16, strength=30.0)
    nb2 = -(-n2 // batch2)
    if not rehearsal:
        torch.cuda.reset_peak_memory_stats()
    two, secs = counted(torch, rehearsal, card, w2,
                        f"describe {c2} cols spearman",
                        _no_kernels_but_k2(nb2), batch_rows=batch2,
                        spearman=True, **dev_kw)
    peak = torch.cuda.max_memory_allocated() if not rehearsal else None
    # the seed artifact without the correlation matrix: at 4,096 columns
    # its 16.8M entries would be most of the JSON, and the seed reads only
    # the sketches' bin_seeds
    art = f"{tmp}/w2.json"
    write_artifact(art, stats=_without_matrices(two),
                   config=tpuprof_torch.ProfilerConfig(batch_rows=batch2))
    h0, m0, r0 = (singlepass.edge_hits, singlepass.edge_misses,
                  singlepass.rebins)
    if not rehearsal:
        torch.cuda.reset_peak_memory_stats()
    warm, secs_w = counted(torch, rehearsal, card, w2,
                           f"describe {c2} cols fused warm",
                           _no_kernels_but_k2(nb2), batch_rows=batch2,
                           profile_passes="fused", seed_edges=art, **dev_kw)
    peak_w = torch.cuda.max_memory_allocated() if not rehearsal else None
    require(singlepass.edge_hits - h0 == c2
            and singlepass.edge_misses == m0 and singlepass.rebins == r0,
            f"{c2} cols fused warm: not every lane hit")
    pearson_only = dict(two, correlations={
        "pearson": two["correlations"]["pearson"]})
    compare_stats(warm, pearson_only, f"{c2} cols fused warm")
    require(exported(_without_matrices(warm))
            == exported(_without_matrices(two)) and np.array_equal(
                warm["correlations"]["pearson"].to_numpy(),
                two["correlations"]["pearson"].to_numpy(), equal_nan=True),
            f"{c2} cols fused warm: differs from two-pass")
    print(f"{c2} x {n2} on {card}: two-pass with spearman {secs:.3f} s, "
          f"peak device memory {peak} B; fused warm {secs_w:.3f} s (all "
          f"{c2} lanes hit, equal to two-pass), peak {peak_w} B",
          flush=True)

    # the routes past the kernels' columns, one batch at the main path's
    # shape: the XLA twin, its Gram alone, the exact rank tier
    x = torch.from_numpy(np.ascontiguousarray(
        w2.iloc[:batch2].to_numpy(np.float32).T)).to(
        "cpu" if rehearsal else "cuda:0")
    del w2, two, warm, pearson_only
    dev = x.device
    rv = torch.ones(x.shape[1], dtype=torch.bool, device=dev)
    mom, co = moments.init(c2, dev), corr.init(c2, dev)
    sampler_vals = x[:, : min(4096, x.shape[1])]
    srt = torch.sort(torch.where(torch.isfinite(sampler_vals),
                                 sampler_vals, float("inf")), dim=1)[0]
    kept = torch.isfinite(sampler_vals).sum(1, dtype=torch.int32)
    spear = corr.init(c2, dev)
    routes = {
        "shape": f"{c2}x{x.shape[1]}",
        "update_xla_ms": time_ms(
            lambda: fused.update_xla(mom, co, x, rv), torch, dev,
            warmup=1, reps=3),
        "gram_matmul_ms": time_ms(
            lambda: corr.update(co, x.T, rv), torch, dev, warmup=1,
            reps=3),
        "exact_ranks_ms": time_ms(
            lambda: fused.exact_ranks(x, rv, srt, kept), torch, dev,
            warmup=1, reps=3),
        "spearman_exact_ms": time_ms(
            lambda: fused.spearman_update_exact(spear, x, rv, srt, kept),
            torch, dev, warmup=1, reps=3),
    }
    routes["gram_f32_bound_ms"] = bound(
        x.numel() * 4 + x.shape[1] + 4 * c2 * c2 * 4,
        4 * 2 * c2 * c2 * x.shape[1])[0]
    print(f"routes past the kernels' columns on {card}: "
          f"{json.dumps(routes)}", flush=True)
    del x, mom, co, spear, srt

    # 7.3 the headline at 16,384 bins (K2's device-memory body)
    head = headline_frame(n_head, cols_h)
    nbh = -(-n_head // batch)
    paired = (("fused_a", nbh), ("hist_b", nbh), ("fused_ab", 0),
              ("fused_wide", 0))
    t16, _ = counted(torch, rehearsal, card, head,
                     f"describe {cols_h} cols bins={big}", paired,
                     batch_rows=batch, bins=big, **dev_kw)
    art16 = f"{tmp}/h16.json"
    write_artifact(art16, stats=t16, config=tpuprof_torch.ProfilerConfig(
        batch_rows=batch, bins=big))
    h0, m0 = singlepass.edge_hits, singlepass.edge_misses
    w16, _ = counted(torch, rehearsal, card, head,
                     f"describe {cols_h} cols bins={big} fused warm",
                     paired, batch_rows=batch, bins=big,
                     profile_passes="fused", seed_edges=art16, **dev_kw)
    require(singlepass.edge_hits - h0 == cols_h
            and singlepass.edge_misses == m0,
            f"bins={big} fused warm: not every lane hit")
    require(exported(w16) == exported(t16),
            f"bins={big} fused warm: differs from two-pass")
    t8, _ = counted(torch, rehearsal, card, head,
                    f"describe {cols_h} cols bins={big // 2}", paired,
                    batch_rows=batch, bins=big // 2, **dev_kw)
    held = 0
    for name, v in t16["variables"].items():
        h = v.get("histogram")
        h8 = t8["variables"][name].get("histogram")
        if h is None or h8 is None:
            continue
        pairs = np.asarray(h[0]).reshape(-1, 2).sum(1)
        require(np.array_equal(pairs, np.asarray(h8[0])),
                f"bins={big}: {name}'s bin pairs do not sum to the "
                f"{big // 2}-bin histogram")
        held += 1
    require(held > 0, f"bins={big}: no histogram to hold")
    print(f"bins={big}: fused warm (K1 then K2) equal to two-pass; the "
          f"bin pairs of all {held} histograms sum to the {big // 2}-bin "
          "histograms exactly", flush=True)


def json_diff(a, b, path=""):
    """The paths at which two JSON documents differ."""
    if isinstance(a, dict) and isinstance(b, dict):
        return [p for k in sorted(set(a) | set(b), key=str)
                for p in json_diff(a.get(k), b.get(k), f"{path}/{k}")]
    return [] if a == b else [path]


def _child_python(args, timeout=900):
    """``python chip_smoke.py ARGS`` from the checkout: (exit code, stdout
    lines, stderr lines, seconds)."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, os.path.abspath(__file__),
                          *args], cwd=root, env=env, capture_output=True,
                         text=True, timeout=timeout)
    return (out.returncode, out.stdout.splitlines(),
            out.stderr.splitlines(), time.perf_counter() - t0)


def resume_child(spec_path: str) -> int:
    """``--resume-child SPEC``: in a fresh process, for each stream of
    the spec restore its checkpoint and feed it the rows after it, then
    ``resume_profiler`` its fold-state artifact and feed it the rows after
    that; write each result's ``stats_to_json`` and print one JSON line of
    timings."""
    import pyarrow as pa

    import tpuprof_torch
    from tpuprof_torch.report.export import stats_to_json
    with open(spec_path) as fh:
        spec = json.load(fh)
    dev = spec["device"]
    with pa.memory_map(spec["rest"]) as src:
        rest = pa.ipc.open_file(src).read_all()
    base = spec["rest_from"]
    out = {}
    for stream in spec["streams"]:
        config = tpuprof_torch.ProfilerConfig(
            batch_rows=spec["batch"], profile_passes=stream["passes"])
        for kind in ("checkpoint", "artifact"):
            key = f"{stream['passes']}_{kind}"
            t0 = time.perf_counter()
            if kind == "checkpoint":
                prof = tpuprof_torch.StreamingProfiler.restore(
                    stream["checkpoint"], config=config, device=dev)
            else:
                prof = tpuprof_torch.resume_profiler(stream["artifact"],
                                                     device=dev)
            out[f"{key}_resume_s"] = time.perf_counter() - t0
            start = int(prof.hostagg.n_rows)
            t0 = time.perf_counter()
            for lo in range(start - base, rest.num_rows, spec["micro"]):
                prof.update(rest.slice(lo, spec["micro"]))
            stats = prof.stats()
            out[f"{key}_rows"] = rest.num_rows + base - start
            out[f"{key}_feed_s"] = time.perf_counter() - t0
            with open(stream[f"{kind}_out"], "w") as fh:
                json.dump(stats_to_json(stats), fh, sort_keys=True)
    print(json.dumps(out), flush=True)
    return 0


def phase_durable(torch, rehearsal: bool, card: str, cli=None) -> None:
    """Streams with a checkpoint, a child's restore and a child's
    ``resume_profiler`` on the headline table, two-pass (K1) and fused
    (K4); then the ``profile`` verb's checkpoints on a Parquet directory:
    a child killed by a ``fold`` fault and a child that resumes."""
    import atexit
    import re
    import shutil
    import tempfile

    import pyarrow as pa
    import pyarrow.parquet as pq

    import tpuprof_torch
    from tpuprof_torch.artifact import read_artifact, write_artifact
    from tpuprof_torch.report.export import stats_to_json

    if rehearsal:
        cols, n, batch, micro = 20, 4096, 512, 128
        dev, dev_kw = "cpu", {"device": "cpu"}
    else:
        cols, n, batch, micro = 200, 2_097_152, 65_536, 16_384
        dev, dev_kw = "cuda:0", {}
    ck_rows, art_rows = n // 2, 3 * n // 4
    nb = n // batch
    tmp = tempfile.mkdtemp(prefix="chip-smoke-durable-")
    atexit.register(shutil.rmtree, tmp, True)
    table = pa.Table.from_pandas(headline_frame(n, cols),
                                 preserve_index=False)
    rest = f"{tmp}/rest.arrow"
    with pa.OSFile(rest, "wb") as sink:
        with pa.ipc.new_file(sink, table.schema) as writer:
            writer.write_table(table.slice(ck_rows))
    exact = ("count", "n_missing", "n_zeros", "n_infinite", "min", "max",
             "mean", "std", "variance", "sum", "skewness", "kurtosis")

    streams, fulls = [], {}
    for passes, kernel in (("two_pass", "fused_a"), ("fused", "fused_ab")):
        config = tpuprof_torch.ProfilerConfig(batch_rows=batch,
                                              profile_passes=passes)
        ck, art = f"{tmp}/{passes}.ckpt", f"{tmp}/{passes}.json"
        zero_counts()
        prof = tpuprof_torch.StreamingProfiler(table.schema, config=config,
                                               **dev_kw)
        saves = 0.0
        t0 = time.perf_counter()
        for lo in range(0, n, micro):
            prof.update(table.slice(lo, micro))
            if lo + micro == ck_rows:
                t1 = time.perf_counter()
                ck_bytes = prof.checkpoint(ck)
                ck_s = time.perf_counter() - t1
                saves += ck_s
            elif lo + micro == art_rows:
                t1 = time.perf_counter()
                write_artifact(art, profiler=prof)
                art_s = time.perf_counter() - t1
                saves += art_s
        fulls[passes] = full = prof.stats()
        feed = time.perf_counter() - t0 - saves
        counts = read_counts()
        if not rehearsal:
            require(counts[kernel] == nb and all(
                v == 0 for k, v in counts.items() if k != kernel),
                f"stream {passes}: launches {counts}")
        print(f"stream {passes}: {n} rows x {cols} cols in {micro}-row "
              f"micro-batches, {feed:.3f} s of feed and snapshot = "
              f"{n / feed:.0f} rows/s on {card}; launches: {counts}; "
              f"checkpoint at {ck_rows} rows {ck_s:.3f} s, {ck_bytes} B; "
              f"fold-state artifact at {art_rows} rows {art_s:.3f} s, "
              f"{os.path.getsize(art)} B", flush=True)
        streams.append({"passes": passes, "checkpoint": ck,
                        "artifact": art,
                        "checkpoint_out": f"{tmp}/{passes}.ck.json",
                        "artifact_out": f"{tmp}/{passes}.art.json"})
        one, _ = counted(torch, rehearsal, card, headline_frame(n, cols),
                         f"describe {cols} cols {passes}", batch_rows=batch,
                         profile_passes=passes, **dev_kw)
        for name, v in one["variables"].items():
            mine = full["variables"][name]
            for fld in exact:
                # a correlation-rejected column carries no moments
                require(mine.get(fld) == v.get(fld),
                        f"stream {passes}: {name}.{fld} {mine.get(fld)} "
                        f"vs describe's {v.get(fld)}")
        print(f"stream {passes}: {', '.join(exact)} equal to describe's",
              flush=True)
    # one child restores both streams' checkpoints and artifacts
    spec = {"device": dev, "batch": batch, "micro": micro, "rest": rest,
            "rest_from": ck_rows, "streams": streams}
    spec_path = f"{tmp}/resume.spec.json"
    with open(spec_path, "w") as fh:
        json.dump(spec, fh)
    rc, out, err, secs = _child_python(["--resume-child", spec_path])
    require(rc == 0, f"stream: the resume child exited {rc}: {err[-8:]}")
    timings = json.loads(out[-1])
    for stream in streams:
        want = json.dumps(stats_to_json(fulls[stream["passes"]]),
                          sort_keys=True)
        for kind in ("checkpoint", "artifact"):
            with open(stream[f"{kind}_out"]) as fh:
                require(fh.read() == want, f"stream {stream['passes']}: "
                        f"the child's {kind} resume differs from the "
                        "uninterrupted stream")
    print(f"streams: a child ({secs:.3f} s, process included) restored "
          "each stream's checkpoint and resumed its fold-state artifact; "
          "all four finished equal to the uninterrupted streams' "
          f"stats_to_json; seconds: {json.dumps(timings)}", flush=True)
    del table

    # the profile verb's checkpoints on phase 5's Parquet directory (made
    # here when phase 5 did not run): a child killed on its 9th fold
    cdev = ["--device", "cpu"] if rehearsal else []
    if cli is not None:
        cli_dir, cli_art, cbatch = cli
    else:
        cbatch = batch if not rehearsal else 128     # 16 batches
        cli_dir = f"{tmp}/cli"
        os.makedirs(cli_dir)
        wide = wide_frame(n // 2, cols, seed=6)
        per = len(wide) // 4
        t = pa.Table.from_pandas(wide, preserve_index=False)
        for i in range(4):
            pq.write_table(t.slice(i * per, per),
                           f"{cli_dir}/part{i}.parquet",
                           row_group_size=cbatch)
        del wide, t
        cli_art = f"{tmp}/cli_control.json"
        rc, err, _, _ = child(["profile", cli_dir, "-o", f"{tmp}/c.html",
                               "--batch-rows", str(cbatch), "--artifact",
                               cli_art, *cdev])
        require(rc == 0, f"cli control: exit {rc}: {err[-5:]}")
    ck = f"{tmp}/cli.ckpt"
    argv = ["profile", cli_dir, "--batch-rows", str(cbatch),
            "--checkpoint", ck, "--checkpoint-every", "4", *cdev]
    os.environ["TPUPROF_FAULTS"] = "fold:1@9"
    try:
        rc, err, _, secs = child([*argv, "-o", f"{tmp}/dead.html"])
    finally:
        del os.environ["TPUPROF_FAULTS"]
    require(rc != 0 and any("injected" in ln for ln in err)
            and os.path.exists(ck), f"cli checkpoint: the faulted child "
            f"exited {rc}: {err[-3:]}")
    print(f"cli checkpoint: the child died on its 9th fold (exit {rc}, "
          f"{secs:.3f} s), {ck} holds {os.path.getsize(ck)} B", flush=True)
    art = f"{tmp}/cli_resumed.json"
    rc, err, mods, secs = child([*argv, "-o", f"{tmp}/resumed.html",
                                 "--artifact", art])
    require(rc == 0 and re.match(PROFILE_LINE, err[-1]),
            f"cli checkpoint: the resuming child exited {rc}: {err[-5:]}")
    require(not os.path.exists(ck), "cli checkpoint: the resumed run left "
            "its checkpoint")
    got, want = read_artifact(art).stats, read_artifact(cli_art).stats
    require(got == want, "cli checkpoint: the resumed profile differs from "
            f"the uninterrupted one at {json_diff(got, want)[:5]}")
    require(not mods & {"jax", "jaxlib", "tpuprof"},
            "cli checkpoint: the child loaded jax or tpuprof")
    print(f"cli checkpoint: the resuming child exited 0 in {secs:.3f} s; "
          f"{err[-1]}; {footer_phases(f'{tmp}/resumed.html')}; its "
          "artifact's stats equal the uninterrupted profile's", flush=True)


PHASES = ("kernels", "main", "cli", "ingest", "limits", "durable")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu-rehearsal", action="store_true",
                    help="tiny sizes on the CPU with the plain versions")
    ap.add_argument("--only", metavar="PHASE[,PHASE]",
                    help="after the build run only these phases, of "
                    + ", ".join(PHASES) + " (3 to 8), and k2big (phase "
                    "3's check of K2's device-memory body alone); the "
                    "kernels line is printed only when phase 3 runs")
    ap.add_argument("--kernels-only", action="store_true",
                    help="the same as --only kernels")
    ap.add_argument("--k2-probe", action="store_true",
                    help="stop after the build and K2's SASS counts and "
                    "times (k2_probe)")
    ap.add_argument("--ingest-only", action="store_true",
                    help="the same as --only ingest")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of phase 6's frame")
    ap.add_argument("--resume-child", metavar="SPEC",
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.resume_child:
        # phase 8's child process: restore, feed, write its stats
        return resume_child(args.resume_child)
    only = set(PHASES)
    if args.only:
        only = {p.strip() for p in args.only.split(",") if p.strip()}
        unknown = only - set(PHASES) - {"k2big"}
        if unknown:
            ap.error(f"unknown phases {sorted(unknown)}; use {PHASES}")
    if args.kernels_only:
        only = {"kernels"}
    if args.ingest_only:
        only = {"ingest"}

    import torch
    if not args.cpu_rehearsal and not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py checks the port on a GPU "
              "(use --cpu-rehearsal for the CPU walk-through)",
              file=sys.stderr)
        return 2
    import tpuprof_torch            # fails outside a checkout of the repo
    from tpuprof_torch import kernels

    if args.cpu_rehearsal:
        device = torch.device("cpu")
        card = "cpu rehearsal"
        print(f"torch {torch.__version__} (cpu rehearsal)", flush=True)
    else:
        device = torch.device("cuda:0")
        card = card_line()
        print(f"card: {torch.cuda.get_device_name(0)} | nvidia-smi: {card}"
              f" | torch {torch.__version__} | CUDA {torch.version.cuda}",
              flush=True)
        took = kernels.build_all()
        for name, secs in took.items():
            print(f"built {name} in {secs:.1f} s", flush=True)
        for name, log in kernels.build_logs.items():
            print(f"ptxas {name}: " + " / ".join(
                ln.strip() for ln in log.splitlines()
                if "registers" in ln or "Compiling entry" in ln
                or "spill" in ln),
                flush=True)
    del tpuprof_torch
    if args.k2_probe and not args.cpu_rehearsal:
        k2_probe(torch, device)
        return 0

    def timed(phase, *a):
        """``phase(*a)``, printing its seconds (the script has a time
        limit: this says which phase to cut when it grows)."""
        t0 = time.perf_counter()
        out = phase(*a)
        print(f"{phase.__name__} took {time.perf_counter() - t0:.1f} s",
              flush=True)
        return out

    rehearsal = args.cpu_rehearsal
    rows = []
    if "k2big" in only:
        from tpuprof_torch.kernels import hist
        k2 = hist.histogram_cuda if not rehearsal else \
            (lambda *a, split_cols=None: hist.histogram_plain(*a))
        timed(check_k2_global, torch, device, k2, rehearsal)
    if "kernels" in only:
        rows = timed(phase_kernels, torch, device, rehearsal)
        rows += timed(phase_kernels_wide_and_rank, torch, device, rehearsal)
        rows += timed(phase_kernel_ab, torch, device, rehearsal)
        f64 = timed(phase_gram_f64, torch, device, rehearsal)
        for r in rows:
            if r["name"] in f64:
                r["f64_scaled_err"], r["f64_plain_scaled_err"] = \
                    f64[r["name"]]
    # null when the main path did not run: no count was read
    launches = dict.fromkeys(COUNTERS)
    if "main" in only:
        launches = timed(phase_main_path, torch, rehearsal, card)
    cli = timed(phase_cli, torch, rehearsal, card) if "cli" in only \
        else None
    if "ingest" in only:
        timed(phase_ingest, torch, rehearsal, card, args.seed)
    if "limits" in only:
        timed(phase_limits, torch, rehearsal, card)
    if "durable" in only:
        timed(phase_durable, torch, rehearsal, card, cli)
    if rows:
        for r in rows:
            r["launches"] = launches[r["name"]]
            r["matched"] = True     # phase 3 exits before here otherwise
        first = ("name", "route", "source", "replaces", "launches")
        print(json.dumps({"kernels": [
            {**{k: r[k] for k in first},
             **{k: v for k, v in r.items() if k not in first}}
            for r in rows]}))
    print(card)
    kind = torch.cuda.get_device_name(0) if not rehearsal else "cpu"
    count = torch.cuda.device_count() if not rehearsal else 0
    platform = "gpu" if not rehearsal else "cpu"
    print(json.dumps({"ok": True, "device": {"platform": platform,
                                             "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
