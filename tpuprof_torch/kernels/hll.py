"""HyperLogLog distinct-count registers.

Counterpart of ``tpuprof/kernels/hll.py``.  Hashes are computed on the host
during ingest and packed one uint16 per cell, ``(register_index << 5) | rho``,
0 meaning null or padding; except that in pass A of a GPU profile on a CUDA
runner without ``exact_distinct`` (and with the native hash library, so the
host's hashes are splitmix64's), the float32 lanes are hashed and folded on
the card from the batch kernel K1 reads (``fused.hll_regs``), with the same
key, hash, pack and fold.  Registers are (cols, 2^p) int32 and merge by
elementwise max; a lane's registers are the reference's bit for bit
whichever route made them, so host and device registers (one profile's,
or another process's) combine by max with no remapping.  ``pack``,
``HostRegisters`` and ``finalize`` are numpy copies of the reference
(bit-identical registers and estimates); ``update`` is the device
scatter-max, used when the native host fold is unavailable.

:func:`record_routes` counts the lanes each profile routes each way
(``lanes_device``, ``lanes_host``, and ``tpuprof_hll_lanes_total{route}``
with metrics on).
"""

from __future__ import annotations

import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from tpuprof_torch.obs import metrics as _obs_metrics

RHO_BITS = 5
RHO_MAX = 31          # 5-bit field; 0 is the invalid marker
MAX_PRECISION = 11    # idx (11) + rho (5) = 16 bits

_LANES = _obs_metrics.counter(
    "tpuprof_hll_lanes_total",
    "hash lanes whose pass-A HyperLogLog observations a profile made, by "
    "route: device (float32 lanes hashed on the card, fused.hll_regs) or "
    "host (the prepare pool)")
lanes_device = 0        # lanes profiles in this process hashed on the card
lanes_host = 0          # ... and on the host
_count_lock = threading.Lock()


def record_routes(device: int, host: int) -> None:
    """Count one profile's lanes by route (once a profile)."""
    global lanes_device, lanes_host
    with _count_lock:
        lanes_device += device
        lanes_host += host
    for route, n in (("device", device), ("host", host)):
        if n:
            _LANES.inc(n, route=route)


def lane_runs(n_hash: int, skip: Sequence[int]) -> List[Tuple[int, int]]:
    """The ``[lo, hi)`` runs of hash lanes ``0..n_hash`` not in
    ``skip``: the lanes a host fold covers when ``skip`` hash on the
    device."""
    skip = set(skip)
    runs: List[Tuple[int, int]] = []
    for lane in range(n_hash):
        if lane in skip:
            continue
        if runs and runs[-1][1] == lane:
            runs[-1] = (runs[-1][0], lane + 1)
        else:
            runs.append((lane, lane + 1))
    return runs


def init(n_cols: int, precision: int, device="cpu") -> torch.Tensor:
    return torch.zeros((n_cols, 1 << precision), dtype=torch.int32,
                       device=device)


def pack(h64: np.ndarray, valid: Optional[np.ndarray],
         precision: int) -> np.ndarray:
    """64-bit hashes -> packed uint16 observations: idx = top ``precision``
    bits, rho = leading zeros of the next 32 bits + 1, capped at 31 and
    floored at 1 so packed == 0 iff invalid.  ``valid=None`` means every
    row is valid."""
    if precision > MAX_PRECISION:
        raise ValueError(f"hll precision > {MAX_PRECISION} cannot pack "
                         f"into uint16")
    idx = (h64 >> np.uint64(64 - precision)).astype(np.uint32)
    b = ((h64 >> np.uint64(64 - precision - 32))
         & np.uint64(0xFFFFFFFF)).astype(np.uint64)
    # clz32 via exact f64 log2 (uint32 is exact in f64)
    bl = np.floor(np.log2((b | np.uint64(1)).astype(np.float64))).astype(
        np.uint32) + 1
    rho = np.clip(33 - bl, 1, RHO_MAX).astype(np.uint32)
    packed = ((idx << RHO_BITS) | rho).astype(np.uint16)
    if valid is None:
        return packed
    return np.where(valid, packed, np.uint16(0))


def update(regs: torch.Tensor, packed: torch.Tensor) -> torch.Tensor:
    """Fold a (rows, cols) packed-observation plane into (cols, m)
    registers by scatter-max.  The plane holds the uint16 observations'
    16 bits in any integer dtype (the runner ships them as int16).
    Observations whose index does not fit the register count go to a
    discarded spill slot instead of a neighbouring column."""
    n_cols, m = regs.shape
    if n_cols == 0 or packed.shape[1] == 0:
        return regs
    p32 = packed.to(torch.int32) & 0xFFFF
    idx = p32 >> RHO_BITS
    rho = p32 & RHO_MAX
    valid = (p32 != 0) & (idx < m)
    col_ids = torch.arange(n_cols, dtype=torch.int32,
                           device=regs.device)[None, :]
    flat_ids = torch.where(valid, col_ids * m + idx, n_cols * m)
    flat = torch.zeros((n_cols * m + 1,), dtype=torch.int32,
                       device=regs.device)
    flat = flat.scatter_reduce(0, flat_ids.reshape(-1).to(torch.int64),
                               rho.reshape(-1), reduce="amax")
    return torch.maximum(regs, flat[: n_cols * m].reshape(n_cols, m))


def merge(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.maximum(a, b)


class HostRegisters:
    """HLL registers kept in host memory and folded by the native C++ pass
    while the packed observations are still there, so the packed plane is
    never shipped to the device.  Bit-identical to the device fold."""

    def __init__(self, n_cols: int, precision: int):
        self.regs = np.zeros((n_cols, 1 << precision), dtype=np.int32)

    def update(self, packed: np.ndarray, nrows: int,
               runs: Optional[Sequence[Tuple[int, int]]] = None) -> None:
        """Fold the first ``nrows`` rows of a (rows, n_hash) packed plane;
        ``runs`` (:func:`lane_runs`) limits the fold to those lanes (the
        others hash on the device and stay 0 in the plane)."""
        from tpuprof_torch import native
        if runs is None:
            runs = [(0, self.regs.shape[0])]
        for lo, hi in runs:
            obs = packed[:nrows, lo:hi]
            if obs.size == 0:
                continue
            regs = self.regs[lo:hi]
            if not native.hll_update(regs, obs):
                p32 = obs.astype(np.int32)
                idx = p32 >> RHO_BITS
                rho = p32 & RHO_MAX
                m = regs.shape[1]
                for c in range(regs.shape[0]):
                    ok = (p32[:, c] != 0) & (idx[:, c] < m)
                    np.maximum.at(regs[c], idx[ok, c], rho[ok, c])

    def merge(self, other: "HostRegisters") -> "HostRegisters":
        np.maximum(self.regs, other.regs, out=self.regs)
        return self


def finalize(regs) -> np.ndarray:
    """Host-side estimator with the small-range (linear counting)
    correction; float64 estimates per column."""
    if isinstance(regs, torch.Tensor):
        regs = regs.detach().cpu().numpy()
    regs = np.asarray(regs)
    n_cols, m = regs.shape
    alpha = {16: 0.673, 32: 0.697, 64: 0.709}.get(
        m, 0.7213 / (1.0 + 1.079 / m))
    with np.errstate(divide="ignore"):
        raw = alpha * m * m / np.sum(np.exp2(-regs.astype(np.float64)),
                                     axis=1)
    zeros = (regs == 0).sum(axis=1)
    linear = np.where(zeros > 0, m * np.log(m / np.maximum(zeros, 1)), raw)
    return np.where((raw <= 2.5 * m) & (zeros > 0), linear, raw)
