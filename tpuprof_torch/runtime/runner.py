"""Single-device execution of the profile passes.

Counterpart of ``tpuprof/runtime/mesh.py`` for one device.  The runner owns
the device, ships host batches to it, and folds them into the pass-A state
``{"mom", "corr", "hll"}`` (kernel K1, K3 past 512 numeric columns, and
past 2,048 the reference's XLA twin ``fused.update_xla``, PyTorch calls),
the pass-B state ``{"counts", "abs_dev"}`` (kernel K2, any bin count) and,
with Spearman on, the rank-correlation state: on the grid tier up to 2,048
columns (a corr state about 0.5: kernel K5, or K6 then K3 past 512
columns), past that on the reference's exact tier (``searchsorted`` ranks in
the sorted row sample, then ``corr.update``); :meth:`Runner.spearman_inputs`
gives the device inputs of the runner's tier.  A single-pass profile folds
the pass-A and pass-B states from one shipped batch (:meth:`fold_ab`):
kernel K4 up to 512 columns and 8,192 bins, else pass A's route then K2 on
the same batch (the reference's paired dispatch).  A batch shipped with a
lane map (``hll_lanes``) also has those float32 lanes' HyperLogLog
observations hashed into the pass-A registers on the device, after the
pass-A kernel (``fused.hll_regs``, in place): the lanes the host ingest
left unhashed (``ingest/arrow.py``).  The tiers are the reference's
(``mesh.py``: ``use_fused``, ``spear_grid``, ``_ab_combined_kernel``).
States are dicts of tensors with the reference's keys, so the merge laws
and finalizers carry over.

Shipping: :meth:`Runner.ship` copies a group of S host batches as ONE
host-to-device transfer a plane (:func:`host_planes`): a group of one from
views of the batch's planes, several stacked once.  Each ``fold_*`` folds
the group's batches in order with the same per-batch calls, so a group of
S gives the same bits as S groups of one.  Each pass-A or pass-B fold is
one dispatch to the telemetry (``kernels/fused.observe_dispatch``), under
the reference's program names: ``step_*`` for a group of one, ``scan_*``
for a staged group.

:func:`state_from_numpy` / :func:`state_to_numpy` carry states in and out of
the port, including the reference's per-device stacked states, which are
folded with its merge law (``mesh.py`` ``local_merge_a`` and, for the
Spearman state, ``merge_corr_local``).
"""

from __future__ import annotations

import logging
from typing import Any, Dict, NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

from tpuprof_torch.config import MAX_SPEAR_GRID
from tpuprof_torch.kernels import corr, fused, hist, histogram, hll, moments

State = Dict[str, Any]

logger = logging.getLogger("tpuprof_torch")


def resolve_device(device: Union[str, torch.device, None] = None
                   ) -> torch.device:
    """The device the port runs on: ``None`` means the first CUDA device,
    and raises when there is none.  The CPU only when asked for."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: tpuprof_torch runs on cuda:0 by default "
                "and none is available; pass device='cpu' to run the "
                "plain PyTorch versions of its kernels on the CPU")
        return torch.device("cuda:0")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not "
                           "available")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


class DeviceGroup(NamedTuple):
    """S shipped batches, each plane with a leading batch axis."""
    xts: torch.Tensor         # (S, n_num, rows) float32
    row_valids: torch.Tensor  # (S, rows) bool
    hllts: torch.Tensor       # (S, n_hash, rows) int16 bits of uint16
    n_batches: int
    # (K, 2) int32 (numeric lane, hash lane) on the device: the float32
    # lanes whose observations hash on the device (None: none)
    hll_lanes: Optional[torch.Tensor] = None

    def batches(self):
        """Each batch's ``(xt, row_valid, hllt)``, in order."""
        for i in range(self.n_batches):
            yield self.xts[i], self.row_valids[i], self.hllts[i]


def host_planes(hbs: Sequence, with_hll: bool, precision: int):
    """The ``(xts, row_valids, hllts)`` host planes of HostBatches ``hbs``,
    each with a leading batch axis: of one batch, views of its planes (an
    F-ordered ``x`` transposes without a copy); of several, one stacked
    copy a plane.  ``with_hll=False`` leaves the packed plane out (pass B
    and host-side register folds never read it)."""
    views = []
    for hb in hbs:
        h = hb.hll if with_hll else hb.hll[:, :0]
        if h.shape[1] and hb.hll_precision != precision:
            raise ValueError(
                f"batch packed with hll_precision={hb.hll_precision} but "
                f"the registers use precision={precision}")
        x = hb.x
        xt = x.T if x.flags.f_contiguous else np.ascontiguousarray(x.T)
        ht = h.T if h.flags.f_contiguous else np.ascontiguousarray(h.T)
        views.append((xt, hb.row_valid, ht.view(np.int16)))
    if len(views) == 1:
        return tuple(v[None] for v in views[0])
    return tuple(np.stack(plane) for plane in zip(*views))


def observe_fold(pass_name: str, n_batches: int, device, kernel=None):
    """A fold's dispatch telemetry: ``step_<pass>`` for a group of one,
    ``scan_<pass>`` (with ``{program}_batches``) for a staged group."""
    program = ("step_" if n_batches == 1 else "scan_") + pass_name
    return fused.observe_dispatch(program, device, batches=n_batches,
                                  kernel=kernel)


def spearman_grid(sampler, n_grid: int) -> np.ndarray:
    """The (n_num, G) CDF grid of the Spearman rank pass, G clamped to
    ``MAX_SPEAR_GRID`` with a warning.  Raises ``ValueError`` unless every
    row is nondecreasing and free of NaN: the kernels rank by binary search,
    which equals the reference's dense compare only on such a grid."""
    g = min(n_grid, MAX_SPEAR_GRID)
    if g < n_grid:
        logger.warning("spearman_grid=%d clamped to %d: the rank kernels "
                       "hold each column's grid in shared memory",
                       n_grid, g)
    grid = sampler.cdf_grid(g)
    if np.isnan(grid).any() or (grid[:, 1:] < grid[:, :-1]).any():
        raise ValueError("the Spearman CDF grid is not sorted or holds NaN")
    return grid


class Runner:
    """Owns the device and the per-pass folds of one profile."""

    def __init__(self, config, n_num: int, n_hash: int, device=None):
        self.device = resolve_device(device)
        self.rows = int(config.batch_rows)
        self.n_num = n_num
        self.n_hash = n_hash
        self.precision = config.hll_precision
        self.bins = config.bins
        self.pass_b_kernel = config.pass_b
        # the pass-A kernels (K1, K3) and the grid rank kernels (K5, K6)
        # take up to MAX_FUSED_COLS_WIDE columns; wider tables fold with
        # the reference's XLA twin and rank on its exact tier
        self.use_fused = n_num <= fused.MAX_FUSED_COLS_WIDE
        self.spear_grid = self.use_fused
        # K4 holds K1's statistics and a shared-memory histogram
        self.ab_combined = n_num <= fused.MAX_FUSED_AB_COLS \
            and self.bins <= hist.SHARED_MAX_BINS
        self._pin = self.device.type == "cuda"

    @property
    def hashes_on_device(self) -> bool:
        """Whether a profile hashes its float32 lanes into the registers
        on this runner's device (``fused.hll_regs``): on a CUDA device."""
        return self.device.type == "cuda"

    # -- host -> device ------------------------------------------------------

    def put_planes(self, planes, hll_lanes: Optional[torch.Tensor] = None
                   ) -> DeviceGroup:
        """Copy host planes (:func:`host_planes`, or row blocks of them) to
        this runner's device: from pinned memory on a CUDA device, as they
        are on the CPU."""
        out = []
        for arr in planes:
            t = torch.from_numpy(np.ascontiguousarray(arr))
            if self.device.type != "cpu":
                if self._pin:
                    t = t.pin_memory()
                t = t.to(self.device, non_blocking=True)
            out.append(t)
        return DeviceGroup(*out, out[0].shape[0], hll_lanes)

    def ship(self, hbs: Sequence, with_hll: bool = True,
             hll_lanes: Optional[torch.Tensor] = None) -> DeviceGroup:
        """Ship HostBatches ``hbs`` as one group (``with_hll=False`` skips
        the packed plane).  ``hll_lanes`` (:meth:`put_hll_lanes`) names
        the float32 lanes the pass-A folds hash on the device."""
        return self.put_planes(host_planes(hbs, with_hll, self.precision),
                               hll_lanes)

    def put_hll_lanes(self, pairs) -> torch.Tensor:
        """The (K, 2) int32 map of (numeric lane, hash lane) pairs on the
        device, once a profile, after checking each lane is in range."""
        arr = np.asarray(pairs, dtype=np.int32).reshape(-1, 2)
        if ((arr < 0) | (arr >= np.array([self.n_num, self.n_hash]))).any():
            raise ValueError(f"hll lane pairs {arr.tolist()} out of range "
                             f"for {self.n_num} numeric and {self.n_hash} "
                             "hash lanes")
        return self.put_replicated(arr, dtype=np.int32)

    def put_replicated(self, arr, dtype=np.float32) -> torch.Tensor:
        """A small per-column constant (shift, bounds, the exact rank
        tier's sorted sample and kept counts) on the device, float32
        unless ``dtype`` says otherwise."""
        return torch.as_tensor(np.ascontiguousarray(arr, dtype=dtype)).to(
            self.device)

    # -- state ---------------------------------------------------------------

    def init_pass_a(self, shift=None) -> State:
        """Pass-A state.  ``shift`` (n_num,) is the shared centering the
        K1 fold needs; without one the shift stays 0 and unset."""
        mom = moments.init(self.n_num, self.device)
        co = corr.init(self.n_num, self.device)
        if shift is not None:
            s = self.put_replicated(shift)
            mom["shift"] = s
            co["shift"] = s.clone()
            co["set"].fill_(1)
        return {"mom": mom, "corr": co,
                "hll": hll.init(self.n_hash, self.precision, self.device)}

    def init_pass_b(self, n_cols: Optional[int] = None) -> State:
        """Pass-B state for all numeric columns, or for ``n_cols`` of them
        (a single-pass profile's re-bin of its missed lanes)."""
        return histogram.init(self.n_num if n_cols is None else n_cols,
                              self.bins, self.device)

    def init_spearman(self) -> State:
        """The Spearman state: on the grid tier a corr state whose shift
        is the constant 0.5, the perfectly conditioned centre of grid
        ranks in [0, 1]; on the exact tier an unset one, which adopts the
        first batch's rank means (the reference's)."""
        co = corr.init(self.n_num, self.device)
        if self.spear_grid:
            co["shift"].fill_(0.5)
            co["set"].fill_(1)
        return co

    # -- folds ---------------------------------------------------------------

    def _fold_a(self, state: State, xt, row_valid, hllt) -> State:
        fold = fused.update if self.use_fused else fused.update_xla
        mom, co = fold(state["mom"], state["corr"], xt, row_valid)
        return {"mom": mom, "corr": co,
                "hll": hll.update(state["hll"], hllt.T)}

    @staticmethod
    def _hash_a(state: State, xt, row_valid, hll_lanes) -> State:
        """After a batch's pass-A fold: the lanes ``hll_lanes`` hashed
        into the state's registers on the device (``fused.hll_regs``, in
        place); no launch without a lane map."""
        if hll_lanes is not None:
            fused.hll_regs(state["hll"], xt, row_valid, hll_lanes)
        return state

    def _fold_b(self, state: State, xt, row_valid, lo, hi, mean,
                lanes=None) -> State:
        """K2 over ``xt``, or over its rows ``lanes`` (a device index
        tensor: a re-bin of some columns of a batch that shipped whole).
        The rows split as in the full-width pass, so the MAD of every
        column folds in one order whatever subset runs."""
        if lanes is not None:
            xt = xt.index_select(0, lanes)
        counts, abs_dev = hist.histogram_batch(
            xt, row_valid, lo, hi, mean, state["counts"].shape[1],
            kernel=self.pass_b_kernel, split_cols=self.n_num)
        return {"counts": state["counts"] + counts,
                "abs_dev": state["abs_dev"] + abs_dev}

    def _fold_ab(self, state: State, state_h: State, xt, row_valid, hllt,
                 lo, hi, mean):
        if self.ab_combined:
            mom, co, h = fused.update_with_hist(
                state["mom"], state["corr"], state_h, xt, row_valid, lo, hi,
                mean, kernel=self.pass_b_kernel)
            return ({"mom": mom, "corr": co,
                     "hll": hll.update(state["hll"], hllt.T)}, h)
        # past K4's columns or bins: pass A's route (K1, K3 or the twin)
        # then K2 on the same shipped batch (the reference's paired
        # dispatch)
        return (self._fold_a(state, xt, row_valid, hllt),
                self._fold_b(state_h, xt, row_valid, lo, hi, mean))

    def _fold_spearman(self, state: State, xt, row_valid, *inputs) -> State:
        """One batch into the Spearman state on the runner's tier
        (``inputs``: :meth:`spearman_inputs`).  The grid tier: K5 (its
        ranks, then their Gram) up to 512 columns, else ranks (K6) then
        their Gram (K3).  The exact tier: ranks in the sorted padded row
        sample."""
        if not self.spear_grid:
            return fused.spearman_update_exact(state, xt, row_valid, *inputs)
        if self.n_num <= fused.MAX_FUSED_COLS:
            return fused.spearman_update(state, xt, row_valid, *inputs)
        ranks = fused.rank_transform(xt, row_valid, *inputs)
        return fused.spearman_update_wide(state, ranks, row_valid)

    def fold_a(self, state: State, g: DeviceGroup) -> State:
        """Fold the group's batches into the pass-A state, in order."""
        with observe_fold("a", g.n_batches, self.device):
            for xt, rv, ht in g.batches():
                state = self._fold_a(state, xt, rv, ht)
                state = self._hash_a(state, xt, rv, g.hll_lanes)
        return state

    def fold_b(self, state: State, g: DeviceGroup, lo, hi, mean,
               lanes=None) -> State:
        """Fold the group's batches into the pass-B state, in order (see
        :meth:`_fold_b` for ``lanes``)."""
        with observe_fold("b", g.n_batches, self.device,
                          kernel=self.pass_b_kernel):
            for xt, rv, _ in g.batches():
                state = self._fold_b(state, xt, rv, lo, hi, mean, lanes)
        return state

    def fold_ab(self, state: State, state_h: State, g: DeviceGroup, lo, hi,
                mean):
        """Fold the group's batches into the pass-A state AND the
        histogram state on the provisional ``lo``/``hi``/``mean`` (a
        single-pass profile).  Returns ``(state, state_h)``."""
        with observe_fold("ab", g.n_batches, self.device,
                          kernel=self.pass_b_kernel):
            for xt, rv, ht in g.batches():
                state, state_h = self._fold_ab(state, state_h, xt, rv, ht,
                                               lo, hi, mean)
                state = self._hash_a(state, xt, rv, g.hll_lanes)
        return state, state_h

    def fold_spearman(self, state: State, g: DeviceGroup, inputs) -> State:
        """Fold the group's batches into the Spearman state, in order,
        re-reading the planes pass B shipped."""
        for xt, rv, _ in g.batches():
            state = self._fold_spearman(state, xt, rv, *inputs)
        return state

    def spearman_inputs(self, sampler, n_grid: int, n_rows: int):
        """The device inputs of the runner's Spearman tier from the row
        sample: the CDF grid (:func:`spearman_grid`) of ``n_grid`` points,
        or past the rank kernels' columns the sorted padded sample and its
        kept counts (+inf pads the unkept slots), with the reference's
        warning past 1,000,000 rows (``n_rows``)."""
        if self.spear_grid:
            return (self.put_replicated(spearman_grid(sampler, n_grid)),)
        if n_rows > 1_000_000:
            # the card's time is chip_smoke.py phase 7's (PERF.md)
            logger.warning(
                "spearman: %d numeric columns exceed the rank kernels' %d, "
                "so %d rows rank on the exact tier (searchsorted, then a "
                "float32 Gram): 198 ms a 65,536-row batch of 4,096 columns "
                "on an NVIDIA H100 80GB HBM3 at 700 W", self.n_num,
                fused.MAX_FUSED_COLS_WIDE, n_rows)
        srt, kept = sampler.sorted_padded()
        return (self.put_replicated(srt),
                self.put_replicated(kept, np.int32))

    # -- finalize ------------------------------------------------------------

    def bounds_b_device(self, state: State):
        """(lo, hi, mean) float32 pass-B inputs computed on the device from
        the pass-A state (:func:`bounds_from_state`)."""
        return bounds_from_state(state)

    def place_state(self, state) -> State:
        """A state (numpy or tensors, e.g. a merged or restored one) on
        this runner's device."""
        return state_from_numpy(state_to_numpy(state), self.device)

    def wait_ready(self, state: State, timeout_s=None, heartbeat=None):
        """Wait for the device work that ``state`` depends on, under the
        ``device_drain`` watchdog when ``timeout_s`` is set (the
        reference's ``wait_ready``; the fault hook is ``device_wait``)."""
        from tpuprof_torch.runtime import guard
        from tpuprof_torch.testing import faults

        def wait():
            faults.hit("device_wait")
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            return state
        return guard.watched(wait, timeout_s, site="device_drain",
                             heartbeat=heartbeat)

    def finalize(self, state: State) -> Dict[str, Any]:
        """The state as numpy arrays (what a checkpoint saves and the
        finalizers read); the copy waits on the device."""
        return state_to_numpy(state)


def bounds_from_state(state: State):
    """(lo, hi, mean) float32 pass-B inputs from a pass-A state, on its
    device, the reference's device recipe: finite min/max and shift +
    s1/n, non-finite entries set to 0."""
    mom = state["mom"]
    n = mom["n"].to(torch.float32)
    lo = torch.where(torch.isfinite(mom["fmin"]), mom["fmin"], 0.0)
    hi = torch.where(torch.isfinite(mom["fmax"]), mom["fmax"], 0.0)
    mean = torch.where(n > 0, mom["shift"] + mom["s1"]
                       / torch.clamp_min(n, 1.0), 0.0)
    mean = torch.where(torch.isfinite(mean), mean, 0.0)
    return lo.contiguous(), hi.contiguous(), mean.contiguous()


def state_to_numpy(state):
    """A state (nested dicts of tensors) as nested dicts of numpy arrays."""
    if isinstance(state, dict):
        return {k: state_to_numpy(v) for k, v in state.items()}
    if isinstance(state, torch.Tensor):
        return state.detach().cpu().numpy()
    return state


def _tensor(a, device) -> torch.Tensor:
    # a copy: device_get hands back read-only arrays
    return torch.from_numpy(np.array(a, copy=True, order="C")).to(device)


def _common_shift(shift: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """The weighted mean of per-device shifts (axis 0) — the reference's
    collectively agreed centering."""
    return (shift * weight).sum(0) / torch.clamp_min(weight.sum(0), 1.0)


def state_from_numpy(tree, device="cpu") -> State:
    """A pass-A ``{"mom", "corr", "hll"}``, pass-B ``{"counts",
    "abs_dev"}`` or Spearman (a corr state: ``{"shift", "set", "N", "S1",
    "S2", "P"}``) state from numpy leaves (as ``jax.device_get`` gives the
    reference's states) to tensors on ``device``.  Leaves with the
    reference runner's leading per-device axis are folded into one state
    by its merge law: rebase onto the weighted common shift, sum the
    additive leaves, min/max the bounds, max the HLL registers."""
    device = torch.device(device)
    if "P" in tree:
        co = {k: _tensor(v, device) for k, v in tree.items()}
        return _merge_stacked_corr(co) if co["N"].dim() == 3 else co
    if "counts" in tree:
        counts = _tensor(tree["counts"], device).to(torch.int32)
        abs_dev = _tensor(tree["abs_dev"], device).to(torch.float32)
        if counts.dim() == 3:
            counts, abs_dev = counts.sum(0, dtype=torch.int32), abs_dev.sum(0)
        return {"counts": counts, "abs_dev": abs_dev}
    mom = {k: _tensor(v, device) for k, v in tree["mom"].items()}
    co = {k: _tensor(v, device) for k, v in tree["corr"].items()}
    regs = _tensor(tree["hll"], device).to(torch.int32)
    if mom["n"].dim() == 2:
        w = (mom["n"] > 0).to(torch.float32)
        target = _common_shift(mom["shift"], w)
        mom = moments.rebase(mom, target)
        merged = {"shift": target}
        for k in ("n", "s1", "s2", "s3", "s4", "n_zeros", "n_inf",
                  "n_missing"):
            merged[k] = mom[k].sum(0, dtype=mom[k].dtype)
        merged["minv"] = mom["minv"].amin(0)
        merged["maxv"] = mom["maxv"].amax(0)
        merged["fmin"] = mom["fmin"].amin(0)
        merged["fmax"] = mom["fmax"].amax(0)
        mom = merged
        co = _merge_stacked_corr(co)
        regs = regs.amax(0)
    return {"mom": mom, "corr": co, "hll": regs}


def _merge_stacked_corr(co):
    """One corr state from a stacked per-device one: every slice rebased
    onto the weighted mean of the set shifts, then summed (the
    reference's ``merge_corr_local``)."""
    wc = (co["set"] > 0).to(torch.float32)[:, None].expand_as(co["shift"])
    target = _common_shift(co["shift"], wc)
    parts = [corr.rebase({k: v[d] for k, v in co.items()}, target)
             for d in range(co["N"].shape[0])]
    return {"shift": target, "set": co["set"].amax(0),
            "N": torch.stack([p["N"] for p in parts]).sum(
                0, dtype=torch.int32),
            "S1": torch.stack([p["S1"] for p in parts]).sum(0),
            "S2": torch.stack([p["S2"] for p in parts]).sum(0),
            "P": torch.stack([p["P"] for p in parts]).sum(0)}
