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

from tpuprof_torch.runtime.runner import (DeviceGroup, Runner,
                                          bounds_from_state, host_planes,
                                          observe_fold, state_from_numpy,
                                          state_to_numpy)


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
        self.precision = first.precision
        self.pass_b_kernel = first.pass_b_kernel
        self.use_fused = first.use_fused
        self.spear_grid = first.spear_grid
        self.ab_combined = first.ab_combined

    # -- host -> device ------------------------------------------------------

    def ship(self, hbs: List, with_hll: bool = True,
             hll_lanes=None) -> List[DeviceGroup]:
        """One group a device: the row blocks ``P("data")`` of the group's
        planes (:func:`host_planes`), each copied to its shard."""
        if hll_lanes is not None:
            raise ValueError("a mesh profile hashes every lane on the host "
                             "(hashes_on_device is False)")
        planes = host_planes(hbs, with_hll, self.precision)
        r = self.shard_rows
        return [run.put_planes([p[..., d * r:(d + 1) * r] for p in planes])
                for d, run in enumerate(self.runners)]

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

    # -- folds ---------------------------------------------------------------

    def _shards(self, state, groups, *consts):
        """Each shard's runner, state, group and ``consts`` on its device."""
        for d, (r, s, g) in enumerate(zip(self.runners, state, groups)):
            yield r, s, g, [self._on(c, d) for c in consts]

    def fold_a(self, state, groups):
        with observe_fold("a", groups[0].n_batches, self.device):
            out = []
            for r, s, g, _ in self._shards(state, groups):
                for xt, rv, ht in g.batches():
                    s = r._fold_a(s, xt, rv, ht)
                out.append(s)
        return out

    def fold_b(self, state, groups, lo, hi, mean, lanes=None):
        with observe_fold("b", groups[0].n_batches, self.device,
                          kernel=self.pass_b_kernel):
            out = []
            for r, s, g, c in self._shards(state, groups, lo, hi, mean,
                                           lanes):
                for xt, rv, _ in g.batches():
                    s = r._fold_b(s, xt, rv, *c)
                out.append(s)
        return out

    def fold_ab(self, state, state_h, groups, lo, hi, mean):
        with observe_fold("ab", groups[0].n_batches, self.device,
                          kernel=self.pass_b_kernel):
            out_a, out_h = [], []
            for (r, s, g, c), h in zip(
                    self._shards(state, groups, lo, hi, mean), state_h):
                for xt, rv, ht in g.batches():
                    s, h = r._fold_ab(s, h, xt, rv, ht, *c)
                out_a.append(s)
                out_h.append(h)
        return out_a, out_h

    def fold_spearman(self, state, groups, inputs):
        out = []
        for r, s, g, c in self._shards(state, groups, *inputs):
            for xt, rv, _ in g.batches():
                s = r._fold_spearman(s, xt, rv, *c)
            out.append(s)
        return out

    # the runner's tier choice; put_replicated copies to every shard
    spearman_inputs = Runner.spearman_inputs

    # -- finalize ------------------------------------------------------------

    def bounds_b_device(self, state):
        """(lo, hi, mean) on the first device from the merged pass-A
        state (:func:`bounds_from_state`); a merged state passes
        through."""
        merged = self.finalize(state) if isinstance(state, list) \
            else state
        return bounds_from_state(state_from_numpy(merged, self.device))

    def wait_ready(self, state, timeout_s=None, heartbeat=None):
        for r, s in zip(self.runners, state):
            r.wait_ready(s, timeout_s, heartbeat)
        return state

    def finalize(self, state: List) -> Dict[str, Any]:
        """The per-device states folded into one (numpy), by the
        reference's merge law on their stack (what a checkpoint saves and
        the finalizers read)."""
        parts = [state_to_numpy(s) for s in state]

        def stack(*leaves):
            if isinstance(leaves[0], dict):
                return {k: stack(*(lf[k] for lf in leaves))
                        for k in leaves[0]}
            return np.stack(leaves)
        return state_to_numpy(state_from_numpy(stack(*parts), "cpu"))
