#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``tpuprof_torch``) once on one NVIDIA GPU.

Run from the repository root:

    python3 chip_smoke.py                  # the full check on the card
    python3 chip_smoke.py --kernels-only   # build + kernel checks only
    python3 chip_smoke.py --cpu-rehearsal  # tiny sizes, plain versions, CPU

Phases, each fatal on failure:

1. the card's name, power limit, torch and CUDA versions;
2. build every kernel from ``tpuprof_torch/kernels/csrc`` with nvcc (one
   process per source, all started together) and print the build time;
3. each kernel against its plain PyTorch version on the same inputs on the
   card (exact counts/min/max, moments at rtol 5e-4, rho at atol 5e-4),
   determinism of K1, then the time of each kernel at the bench shape
   (200 float32 columns x 65,536 rows) beside its bound, its plain
   version's time and one library call's time;
4. the main path: ``tpuprof_torch.describe(df)`` at its default device on a
   200-column x 2,097,152-row float32 table and on a 1,000,000-row mixed
   frame, with the launch counters set to 0 just before and read just
   after, held against ``describe(..., device="cpu")`` on a 262,144-row
   cut of the wide table and on the mixed frame;
5. one JSON line of per-kernel numbers, the card's name and power limit,
   and as the last line ``{"ok": true, "device": {...}}``.

Without a CUDA device (and without ``--cpu-rehearsal``) it exits 2 and
prints no result.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
import warnings

import numpy as np

# H100 SXM peaks the bounds are computed against (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12

RTOL_MOM, ATOL_MOM, ATOL_RHO = 5e-4, 1e-5, 5e-4


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
    x = rng.normal(50.0, 10.0, (C, R)).astype(np.float32)
    x[rng.random((C, R)) < 0.07] = np.nan
    x[rng.random((C, R)) < 0.01] = np.inf
    x[rng.random((C, R)) < 0.01] = -np.inf
    x[rng.random((C, R)) < 0.03] = 0.0
    x[rng.random((C, R)) < 0.01] = np.float32(1e-40)     # denormal
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


def hist_bounds(x: np.ndarray, rv: np.ndarray, nbins: int, rng):
    """Pass-A style (lo, hi, mean) plus values placed exactly on bin
    edges, so the boundary rounding is exercised."""
    v = np.where(rv[None, :] & np.isfinite(x), x, np.nan)
    with warnings.catch_warnings():       # the all-NaN column warns
        warnings.simplefilter("ignore", RuntimeWarning)
        lo = np.nan_to_num(np.nanmin(v, axis=1), nan=0.0)
        hi = np.nan_to_num(np.nanmax(v, axis=1), nan=0.0)
        mean = np.nan_to_num(np.nanmean(v, axis=1), nan=0.0)
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


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def max_abs_diff(torch, a, b) -> float:
    """Largest |a - b| over the entries finite in both (0.0 if none)."""
    a, b = a.double(), b.double()
    both = torch.isfinite(a) & torch.isfinite(b)
    return float((a - b).abs()[both].max()) if both.any() else 0.0


def check_k1(torch, device, kernel_fn, shapes, seed0=0):
    """K1 against tiles_plain at ``shapes``.  Returns (the largest absolute
    error of K1's float outputs s1..s4, P, S1, S2; the largest error of the
    finalized moments scaled by max(|ref|, 1) and of rho) over all
    shapes."""
    from tpuprof_torch.kernels import corr, fused, moments
    worst_abs = worst = 0.0
    for k, (C, R) in enumerate(shapes):
        x, rv = adversarial_batch(C, R, seed0 + k)
        xt = torch.from_numpy(x).to(device)
        rvt = torch.from_numpy(rv).to(device)
        shift = torch.from_numpy(finite_shift(x)).to(device)
        got = kernel_fn(xt, rvt, shift)
        ref = fused.tiles_plain(xt, rvt, shift)
        if device.type == "cuda":
            torch.cuda.synchronize()
        sums, counts, P, S1, S2, N = got
        rs, rc, rP, rS1, rS2, rN = ref
        require(torch.equal(counts, rc), f"K1 counts differ at {C}x{R}")
        require(torch.equal(N, rN), f"K1 pair counts N differ at {C}x{R}")
        require(torch.equal(sums[:, 4:], rs[:, 4:]),
                f"K1 min/max differ at {C}x{R}")
        worst_abs = max([worst_abs, max_abs_diff(torch, sums[:, :4],
                                                 rs[:, :4])]
                        + [max_abs_diff(torch, u, v) for u, v in
                           ((P, rP), (S1, rS1), (S2, rS2))])
        m0 = moments.init(C, device)
        m0["shift"] = shift
        c0 = corr.init(C, device)
        c0["shift"] = shift
        c0["set"].fill_(1)
        fg = moments.finalize(fused._fold_mom(m0, sums, counts))
        fr = moments.finalize(fused._fold_mom(m0, rs, rc))
        for key in ("mean", "variance", "skewness", "kurtosis", "sum"):
            ok = np.allclose(fg[key], fr[key], rtol=RTOL_MOM, atol=ATOL_MOM,
                             equal_nan=True)
            require(ok, f"K1 {key} outside rtol {RTOL_MOM} at {C}x{R}")
            both = np.isfinite(fg[key]) & np.isfinite(fr[key])
            if both.any():
                worst = max(worst, float(np.max(np.abs(
                    fg[key][both] - fr[key][both]) / np.maximum(
                    np.abs(fr[key][both]), 1.0))))
        rho_g = corr.finalize(fused._fold_corr(c0, P, S1, S2, N))
        rho_r = corr.finalize(fused._fold_corr(c0, rP, rS1, rS2, rN))
        require(np.allclose(rho_g, rho_r, rtol=0, atol=ATOL_RHO,
                            equal_nan=True),
                f"K1 rho outside atol {ATOL_RHO} at {C}x{R}")
        both = np.isfinite(rho_g) & np.isfinite(rho_r)
        if both.any():
            worst = max(worst, float(np.max(np.abs(rho_g - rho_r)[both])))
        print(f"K1 {C}x{R}: counts/N/min/max exact, moments and rho "
              f"within tolerance", flush=True)
    return worst_abs, worst


def check_k2(torch, device, kernel_fn, C, R, bins_list, seed=7):
    """K2 against histogram_plain.  Returns (the largest absolute error of
    K2's sum |x - mean| output; the largest MAD error scaled by
    max(|ref|, 1))."""
    from tpuprof_torch.kernels import hist
    rng = np.random.default_rng(seed)
    worst_abs = worst = 0.0
    for nbins in bins_list:
        x, rv = adversarial_batch(C, R, seed + nbins)
        x, lo, hi, mean = hist_bounds(x, rv, nbins, rng)
        t = [torch.from_numpy(a).to(device) for a in (x, rv, lo, hi, mean)]
        cnt, dev = kernel_fn(*t, nbins)
        rc, rd = hist.histogram_plain(*t, nbins)
        require(torch.equal(cnt, rc), f"K2 counts differ at bins={nbins}")
        n = t[1][None, :] & torch.isfinite(t[0])
        nf = n.sum(1).clamp_min(1).double()
        mad_g = (dev.double() / nf).cpu().numpy()
        mad_r = (rd.double() / nf).cpu().numpy()
        require(np.allclose(mad_g, mad_r, rtol=RTOL_MOM, atol=0),
                f"K2 MAD outside rtol {RTOL_MOM} at bins={nbins}")
        worst_abs = max(worst_abs, max_abs_diff(torch, dev, rd))
        worst = max(worst, float(np.max(np.abs(mad_g - mad_r)
                                        / np.maximum(np.abs(mad_r), 1.0))))
        for kernel in hist.KERNELS:
            c2, _ = hist.histogram_batch(*t, nbins, kernel=kernel)
            require(torch.equal(c2, rc),
                    f"K2 kernel={kernel} counts differ at bins={nbins}")
        print(f"K2 {C}x{R} bins={nbins}: counts exact, MAD within "
              "tolerance", flush=True)
    return worst_abs, worst


def phase_kernels(torch, device, rehearsal: bool):
    from tpuprof_torch.kernels import fused, hist
    if rehearsal:
        k1, k2 = fused.tiles_plain, hist.histogram_plain
        shapes, C, R = [(5, 300), (13, 700)], 13, 700
    else:
        k1, k2 = fused.tiles_cuda, hist.histogram_cuda
        R = 65536
        shapes, C = [(37, R), (200, R), (512, R)], 200
    err1, scaled1 = check_k1(torch, device, k1, shapes)
    err2, scaled2 = check_k2(torch, device, k2, C, R, (10, 128))

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
    fin = torch.isfinite(xt) & rvt[None, :]
    m = fin.float()
    d = torch.where(fin, xt - shift[:, None], 0.0)
    d2 = d * d
    dm, d2m = torch.cat([d, m]), torch.cat([d2, m])
    lib1 = time_ms(lambda: (d @ dm.T, d2m @ m.T), torch, device)
    t2 = time_ms(lambda: k2(xt, rvt, lo, hi, mean, nbins), torch, device)
    p2 = time_ms(lambda: hist.histogram_plain(xt, rvt, lo, hi, mean, nbins),
                 torch, device, reps=5)
    by1 = C * R * 4 + R + C * 4 + C * 8 * 8 + 4 * C * C * 4
    # the Gram work the function needs: P = d d^T and N = m m^T are
    # symmetric (one triangle, diagonal included, at 2 flops a row each);
    # S1 = d m^T and S2 = d^2 m^T are not (2 C^2 R flops each)
    ops1 = 2 * C * (C + 1) * R + 4 * C * C * R
    by2 = C * R * 4 + R + 3 * C * 4 + C * nbins * 4 + C * 4
    ops2 = 8 * C * R
    b1 = 1e3 * max(by1 / HBM_BYTES_PER_S, ops1 / F32_FLOPS)
    b2 = 1e3 * max(by2 / HBM_BYTES_PER_S, ops2 / F32_FLOPS)
    rows = [
        {"name": "fused_a", "route": "cuda",
         "source": "tpuprof_torch/kernels/csrc/fused_a.cu",
         "replaces": "tpuprof/kernels/fused.py:245",
         "max_abs_err": err1, "max_scaled_err": scaled1,
         "ms": t1, "plain_ms": p1, "bound_ms": b1,
         "bound_by": "operations" if ops1 / F32_FLOPS > by1 / HBM_BYTES_PER_S
         else "bytes", "library_ms": lib1},
        {"name": "hist_b", "route": "cuda",
         "source": "tpuprof_torch/kernels/csrc/hist_b.cu",
         "replaces": "tpuprof/kernels/pallas_hist.py:202",
         "max_abs_err": err2, "max_scaled_err": scaled2,
         "ms": t2, "plain_ms": p2, "bound_ms": b2,
         "bound_by": "operations" if ops2 / F32_FLOPS > by2 / HBM_BYTES_PER_S
         else "bytes", "library_ms": None},
    ]
    for r in rows:
        print(f"{r['name']} at {C}x{R}: {r['ms']:.4f} ms (bound "
              f"{r['bound_ms']:.4f} ms by {r['bound_by']}; plain "
              f"{r['plain_ms']:.4f} ms; library {r['library_ms']})",
              flush=True)
    print("K1 library_ms covers the Gram only: torch.matmul of already "
          "materialized d, m, d^2", flush=True)
    return rows


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------

def wide_frame(rows: int, cols: int, seed: int):
    import pandas as pd
    rng = np.random.default_rng(seed)
    base = rng.normal(0.0, 1.0, (rows, 1)).astype(np.float32)
    data = rng.normal(0.0, 1.0, (rows, cols)).astype(np.float32)
    data *= np.linspace(1.0, 20.0, cols, dtype=np.float32)[None, :]
    data += np.linspace(-100.0, 100.0, cols, dtype=np.float32)[None, :]
    data[:, : cols // 4] += 3.0 * base       # a correlated block
    data[rng.random((rows, cols)) < 0.02] = np.nan
    return pd.DataFrame(data, columns=[f"c{i:03d}" for i in range(cols)])


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
    ra = np.asarray(a["correlations"]["pearson"], dtype=float)
    rb = np.asarray(b["correlations"]["pearson"], dtype=float)
    require(ra.shape == rb.shape and np.allclose(ra, rb, rtol=0,
                                                 atol=ATOL_RHO,
                                                 equal_nan=True),
            f"{what}: pearson outside atol {ATOL_RHO}")


def phase_main_path(torch, rehearsal: bool, card: str):
    import tpuprof_torch
    from tpuprof_torch import native, schema
    from tpuprof_torch.kernels import fused, hist

    # the host-bound rows/s below depend on which hash path ran: on the
    # card it must be the C++ library, not the numpy fallback
    hash_path = "native" if native.available() else "numpy fallback"
    if not rehearsal:
        require(native.available(), "the native hash library did not "
                "build; the rows/s would measure the numpy fallback")

    if rehearsal:
        n_wide, n_cut, n_mixed, batch = 4096, 2048, 3000, 512
        dev_kw = {"device": "cpu"}
    else:
        n_wide, n_cut, n_mixed, batch = 2_097_152, 262_144, 1_000_000, 65536
        dev_kw = {}                     # the default device: cuda:0
    cols = 200

    def run(df, label, **kw):
        fused.launches = hist.launches = 0
        if not rehearsal:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        stats = tpuprof_torch.describe(df, batch_rows=batch, **kw)
        secs = time.perf_counter() - t0
        la, lb = fused.launches, hist.launches
        n_batches = -(-len(df) // batch)
        require(schema.validate_stats(stats) == [],
                f"{label}: validate_stats failed")
        if "device" not in kw:
            require(la >= n_batches and lb >= n_batches,
                    f"{label}: K1/K2 launched {la}/{lb} times for "
                    f"{n_batches} batches")
        print(f"{label}: {len(df)} rows in {secs:.3f} s = "
              f"{len(df) / secs:.0f} rows/s on {card}; hash path "
              f"{hash_path}; K1 launches {la}, K2 launches {lb}", flush=True)
        return stats, la, lb

    wide = wide_frame(n_wide, cols, seed=1)
    _, wide_k1, wide_k2 = run(wide, f"describe wide {cols} cols",
                              scan_batches=8, **dev_kw)
    cut = wide.iloc[:n_cut].reset_index(drop=True)
    del wide
    card_cut, _, _ = run(cut, "describe wide cut", scan_batches=8, **dev_kw)
    cpu_cut, _, _ = run(cut, "describe wide cut (cpu)", scan_batches=8,
                        device="cpu")
    compare_stats(card_cut, cpu_cut, "wide cut")
    print("wide cut: card result matches the CPU result", flush=True)

    mixed = mixed_frame(n_mixed, seed=42)
    card_mixed, _, _ = run(mixed, "describe mixed", **dev_kw)
    cpu_mixed, _, _ = run(mixed, "describe mixed (cpu)", device="cpu")
    compare_stats(card_mixed, cpu_mixed, "mixed")
    print("mixed: card result matches the CPU result", flush=True)
    return {"fused_a": wide_k1, "hist_b": wide_k2}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu-rehearsal", action="store_true",
                    help="tiny sizes on the CPU with the plain versions")
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after the kernel checks and timings")
    args = ap.parse_args(argv)

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
                if "registers" in ln or "Compiling entry" in ln),
                flush=True)
    del tpuprof_torch

    rows = phase_kernels(torch, device, args.cpu_rehearsal)
    # null when the main path did not run: no count was read
    launches = {"fused_a": None, "hist_b": None}
    if not args.kernels_only:
        launches = phase_main_path(torch, args.cpu_rehearsal, card)
    for r in rows:
        r["launches"] = launches[r["name"]]
        r["matched"] = True         # phase 3 exits before here otherwise
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "max_scaled_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "matched")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    print(card)
    kind = torch.cuda.get_device_name(0) if not args.cpu_rehearsal \
        else "cpu"
    count = torch.cuda.device_count() if not args.cpu_rehearsal else 0
    platform = "gpu" if not args.cpu_rehearsal else "cpu"
    print(json.dumps({"ok": True, "device": {"platform": platform,
                                             "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
