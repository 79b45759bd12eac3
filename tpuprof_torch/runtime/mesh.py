"""Row-sharded scans over the devices one process sees.

Counterpart of ``tpuprof/runtime/mesh.py``'s ``MeshRunner``.  The reference
row-shards each batch ``P("data")`` over a 1-D device mesh, folds each
device's block into that device's own state (no communication per step)
and merges the per-device states once, at finalize, with one collective
program: ``psum`` of the additive sums after an exact rebase onto a
collectively agreed shift, ``pmin``/``pmax`` of the bounds and the HLL
registers.  Here each device is a :class:`~tpuprof_torch.runtime.runner.Runner`
and a batch of ``rows`` rows (``batch_rows`` padded up to a multiple of the
device count) splits into the same contiguous row blocks ``P("data")``
gives; every shard runs the kernels on its block.  The per-device states
fold at finalize with the reference's merge law, which
:func:`~tpuprof_torch.runtime.runner.state_from_numpy` applies to a stack of
per-device states (the weighted common shift, sums, min/max), so every
shard's shift is the one the backend agreed.

The devices are a list of torch devices, by default the CUDA devices the
process sees cut to ``mesh_devices`` (the counterpart of
``jax.local_devices()``); any list works, the same card twice or ``cpu``
twice included.  States are lists with one state per device; small
constants (:meth:`MeshRunner.put_replicated`) are one copy per device.
A checkpoint saves the merged state; a restore puts it on the first shard
and starts the others empty on the same shift.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from tpuprof_torch.kernels import fused
from tpuprof_torch.runtime.runner import (DeviceBatch, Runner, StackedBatch,
                                          bounds_from_state,
                                          state_from_numpy, state_to_numpy)


def local_devices(mesh_devices: Optional[int] = None) -> List[torch.device]:
    """The CUDA devices this process sees (``CUDA_VISIBLE_DEVICES`` picks
    them), the first ``mesh_devices`` of them when that is set."""
    devs = [torch.device(f"cuda:{i}")
            for i in range(torch.cuda.device_count())]
    return devs[:mesh_devices] if mesh_devices else devs


class Replicated(list):
    """One copy of a small constant on each device of a mesh."""


class MeshRunner:
    """The per-pass folds of one profile, row-sharded over ``devices``."""

    # a mesh profile hashes every lane on the host: its batches carry no
    # lane map for ``fused.hll_regs``
    hashes_on_device = False

    def __init__(self, config, n_num: int, n_hash: int,
                 devices: Sequence[Any]):
        devs = [torch.device(d) for d in devices]
        if config.mesh_devices:
            devs = devs[: config.mesh_devices]
        if not devs:
            raise ValueError("a mesh needs at least one device")
        self.runners = [Runner(config, n_num, n_hash, d) for d in devs]
        self.n_dev = len(devs)
        self.devices = [r.device for r in self.runners]
        self.device = self.devices[0]
        # host batches pad to a row count the devices divide
        self.rows = -(-int(config.batch_rows) // self.n_dev) * self.n_dev
        self.shard_rows = self.rows // self.n_dev
        for r in self.runners:
            r.rows = self.shard_rows
        first = self.runners[0]
        self.n_num, self.n_hash = n_num, n_hash
        self.pass_b_kernel = first.pass_b_kernel
        self.use_fused = first.use_fused
        self.spear_grid = first.spear_grid
        self.ab_combined = first.ab_combined

    # -- host -> device ------------------------------------------------------

    def _blocks(self, arr: np.ndarray) -> List[np.ndarray]:
        """The row blocks of a (..., rows) plane, one a device."""
        r = self.shard_rows
        return [arr[..., d * r:(d + 1) * r] for d in range(self.n_dev)]

    @staticmethod
    def _no_lanes(hll_lanes) -> None:
        if hll_lanes is not None:
            raise ValueError("a mesh profile hashes every lane on the host "
                             "(hashes_on_device is False)")

    def put_batch(self, hb, with_hll: bool = True,
                  hll_lanes=None) -> List[DeviceBatch]:
        self._no_lanes(hll_lanes)
        xt, rv, ht = self.runners[0]._host_views(hb, with_hll)
        return [DeviceBatch(r._ship(x), r._ship(v), r._ship(h))
                for r, x, v, h in zip(self.runners, self._blocks(xt),
                                      self._blocks(rv), self._blocks(ht))]

    def stage_batches(self, hbs: List, with_hll: bool = True,
                      hll_lanes=None) -> List[StackedBatch]:
        self._no_lanes(hll_lanes)
        views = [self.runners[0]._host_views(hb, with_hll) for hb in hbs]
        planes = [np.stack([v[i] for v in views]) for i in range(3)]
        blocks = [self._blocks(p) for p in planes]
        return [StackedBatch(r._ship(blocks[0][d]), r._ship(blocks[1][d]),
                             r._ship(blocks[2][d]), len(hbs))
                for d, r in enumerate(self.runners)]

    def put_replicated(self, arr, dtype=np.float32) -> Replicated:
        return Replicated(r.put_replicated(arr, dtype)
                          for r in self.runners)

    def _on(self, value, d: int):
        """A constant's copy on device ``d``: a :class:`Replicated` entry,
        or a tensor moved there (a no-op on its own device)."""
        if isinstance(value, Replicated):
            return value[d]
        if isinstance(value, torch.Tensor):
            return value.to(self.devices[d])
        return value

    # -- state ---------------------------------------------------------------

    def init_pass_a(self, shift=None) -> List[Dict[str, Any]]:
        return [r.init_pass_a(shift) for r in self.runners]

    def init_pass_b(self, n_cols: Optional[int] = None) -> List:
        return [r.init_pass_b(n_cols) for r in self.runners]

    def init_spearman(self) -> List:
        return [r.init_spearman() for r in self.runners]

    def place_state(self, state: Dict[str, Any]) -> List[Dict[str, Any]]:
        """A mesh state holding ``state`` (one merged state, numpy or
        tensors): on the first shard, the other shards empty on its
        shift."""
        host = state_to_numpy(state)
        first = state_from_numpy(host, self.device)
        if "counts" in host:
            rest = self.init_pass_b(host["counts"].shape[0])[1:]
        else:
            shift = host["mom"]["shift"] \
                if int(np.asarray(host["corr"]["set"]).max(initial=0)) \
                else None
            rest = self.init_pass_a(shift)[1:]
        return [first] + rest

    def host_state(self, state: List) -> Dict[str, Any]:
        """The merged state as numpy arrays (what a checkpoint saves)."""
        return self._merge(state)

    # -- folds ---------------------------------------------------------------

    def step_a(self, state, db):
        with fused.observe_dispatch("step_a", self.device):
            return [r._fold_a(s, b.xt, b.row_valid, b.hllt)
                    for r, s, b in zip(self.runners, state, db)]

    def scan_a(self, state, sb):
        with fused.observe_dispatch("scan_a", self.device,
                                    batches=sb[0].n_batches):
            out = []
            for r, s, b in zip(self.runners, state, sb):
                for i in range(b.n_batches):
                    s = r._fold_a(s, b.xts[i], b.row_valids[i], b.hllts[i])
                out.append(s)
        return out

    def _fold_b_all(self, state, planes, lo, hi, mean, lanes):
        out = []
        for d, (r, s) in enumerate(zip(self.runners, state)):
            for xt, rv in planes[d]:
                s = r._fold_b(s, xt, rv, self._on(lo, d), self._on(hi, d),
                              self._on(mean, d), self._on(lanes, d))
            out.append(s)
        return out

    def step_b(self, state, db, lo, hi, mean, lanes=None):
        with fused.observe_dispatch("step_b", self.device,
                                    kernel=self.pass_b_kernel):
            return self._fold_b_all(state, [[(b.xt, b.row_valid)]
                                            for b in db],
                                    lo, hi, mean, lanes)

    def scan_b(self, state, sb, lo, hi, mean, lanes=None):
        with fused.observe_dispatch("scan_b", self.device,
                                    batches=sb[0].n_batches,
                                    kernel=self.pass_b_kernel):
            return self._fold_b_all(
                state, [[(b.xts[i], b.row_valids[i])
                         for i in range(b.n_batches)] for b in sb],
                lo, hi, mean, lanes)

    def _fold_ab_all(self, state, state_h, planes, lo, hi, mean):
        out_a, out_h = [], []
        for d, (r, s, h) in enumerate(zip(self.runners, state, state_h)):
            for xt, rv, ht in planes[d]:
                s, h = r._fold_ab(s, h, xt, rv, ht, self._on(lo, d),
                                  self._on(hi, d), self._on(mean, d))
            out_a.append(s)
            out_h.append(h)
        return out_a, out_h

    def step_ab(self, state, state_h, db, lo, hi, mean):
        with fused.observe_dispatch("step_ab", self.device,
                                    kernel=self.pass_b_kernel):
            return self._fold_ab_all(
                state, state_h, [[(b.xt, b.row_valid, b.hllt)] for b in db],
                lo, hi, mean)

    def scan_ab(self, state, state_h, sb, lo, hi, mean):
        with fused.observe_dispatch("scan_ab", self.device,
                                    batches=sb[0].n_batches,
                                    kernel=self.pass_b_kernel):
            return self._fold_ab_all(
                state, state_h,
                [[(b.xts[i], b.row_valids[i], b.hllts[i])
                  for i in range(b.n_batches)] for b in sb],
                lo, hi, mean)

    def _spear_all(self, state, planes, fold, consts):
        out = []
        for d, (r, s) in enumerate(zip(self.runners, state)):
            for xt, rv in planes[d]:
                s = fold(r, s, xt, rv, *(self._on(c, d) for c in consts))
            out.append(s)
        return out

    @staticmethod
    def _grid_fold(r, s, xt, rv, grid):
        return r._fold_spearman(s, xt, rv, grid)

    @staticmethod
    def _exact_fold(r, s, xt, rv, sorted_sample, kept):
        return fused.spearman_update_exact(s, xt, rv, sorted_sample, kept)

    def step_spearman(self, state, db, sorted_sample, kept):
        return self._spear_all(state, [[(b.xt, b.row_valid)] for b in db],
                               self._exact_fold, (sorted_sample, kept))

    def scan_spearman(self, state, sb, sorted_sample, kept):
        return self._spear_all(
            state, [[(b.xts[i], b.row_valids[i])
                     for i in range(b.n_batches)] for b in sb],
            self._exact_fold, (sorted_sample, kept))

    def step_spearman_grid(self, state, db, grid):
        return self._spear_all(state, [[(b.xt, b.row_valid)] for b in db],
                               self._grid_fold, (grid,))

    def scan_spearman_grid(self, state, sb, grid):
        return self._spear_all(
            state, [[(b.xts[i], b.row_valids[i])
                     for i in range(b.n_batches)] for b in sb],
            self._grid_fold, (grid,))

    # -- finalize ------------------------------------------------------------

    def _merge(self, state: List) -> Dict[str, Any]:
        """The per-device states folded into one (numpy), by the
        reference's merge law on their stack."""
        parts = [state_to_numpy(s) for s in state]

        def stack(*leaves):
            if isinstance(leaves[0], dict):
                return {k: stack(*(lf[k] for lf in leaves))
                        for k in leaves[0]}
            return np.stack(leaves)
        return state_to_numpy(state_from_numpy(stack(*parts), "cpu"))

    def bounds_b_device(self, state):
        """(lo, hi, mean) on the first device from the merged pass-A
        state (:func:`bounds_from_state`); a merged state passes
        through."""
        merged = self._merge(state) if isinstance(state, list) else state
        return bounds_from_state(state_from_numpy(merged, self.device))

    def wait_ready(self, state, timeout_s=None, heartbeat=None):
        for r, s in zip(self.runners, state):
            r.wait_ready(s, timeout_s, heartbeat)
        return state

    def finalize_a(self, state) -> Dict[str, Any]:
        return self._merge(state)

    def finalize_b(self, state) -> Dict[str, Any]:
        return self._merge(state)

    def finalize_spearman(self, state) -> Dict[str, Any]:
        return self._merge(state)
