"""Single-device execution of the profile passes.

Counterpart of ``tpuprof/runtime/mesh.py`` for one device.  The runner owns
the device, ships host batches to it, and folds them into the pass-A state
``{"mom", "corr", "hll"}`` (kernel K1, K3 past 512 numeric columns, and
past 2,048 the reference's XLA twin ``fused.update_xla``, PyTorch calls),
the pass-B state ``{"counts", "abs_dev"}`` (kernel K2, any bin count) and,
with Spearman on, the rank-correlation state: on the grid tier up to 2,048
columns (a corr state about 0.5: kernel K5, or K6 then K3 past 512
columns), past that on the reference's exact tier (``searchsorted`` ranks in
the sorted row sample, then ``corr.update``).  A single-pass profile folds
the pass-A and pass-B states from one shipped batch (``step_ab`` /
``scan_ab``): kernel K4 up to 512 columns and 8,192 bins, else pass A's
route then K2 on the same batch (the reference's paired dispatch).  A
batch shipped with a lane map (``hll_lanes``) also has those float32
lanes' HyperLogLog observations hashed into the pass-A registers on the
device, after the pass-A kernel (``fused.hll_regs``, in place): the lanes
the host ingest left unhashed (``ingest/arrow.py``).  The
tiers are the reference's (``mesh.py``: ``use_fused``, ``spear_grid``,
``_ab_combined_kernel``).  States are dicts of tensors with the
reference's keys, so the merge laws and finalizers carry over.

Shipping: :meth:`Runner.put_batch` copies one batch; :meth:`stage_batches`
copies S batches as ONE host-to-device transfer from pinned memory, and the
``scan_*`` forms fold the staged slices in order with the same per-batch
calls, so a staged run gives the same bits as a per-batch run.  Each
``step_*``/``scan_*`` of the two passes is one dispatch to the telemetry
(``kernels/fused.observe_dispatch``), under the reference's program names.

:func:`state_from_numpy` / :func:`state_to_numpy` carry states in and out of
the port, including the reference's per-device stacked states, which are
folded with its merge law (``mesh.py`` ``local_merge_a`` and, for the
Spearman state, ``merge_corr_local``).
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Union

import numpy as np
import torch

from tpuprof_torch.kernels import corr, fused, hist, histogram, hll, moments

State = Dict[str, Any]


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


class DeviceBatch(NamedTuple):
    xt: torch.Tensor          # (n_num, rows) float32, contiguous
    row_valid: torch.Tensor   # (rows,) bool
    hllt: torch.Tensor        # (n_hash, rows) int16 bits of the uint16 plane
    # (K, 2) int32 (numeric lane, hash lane) on the device: the float32
    # lanes whose observations hash on the device (None: none)
    hll_lanes: Optional[torch.Tensor] = None


class StackedBatch(NamedTuple):
    xts: torch.Tensor         # (S, n_num, rows)
    row_valids: torch.Tensor  # (S, rows)
    hllts: torch.Tensor       # (S, n_hash, rows)
    n_batches: int
    hll_lanes: Optional[torch.Tensor] = None    # as DeviceBatch's


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

    def _host_views(self, hb, with_hll: bool):
        if with_hll and self.n_hash and hb.hll_precision != self.precision:
            raise ValueError(
                f"batch packed with hll_precision={hb.hll_precision} but "
                f"the registers use precision={self.precision}")
        x = hb.x
        xt = x.T if x.flags.f_contiguous else np.ascontiguousarray(x.T)
        h = hb.hll if with_hll else hb.hll[:, :0]
        ht = h.T if h.flags.f_contiguous else np.ascontiguousarray(h.T)
        return xt, hb.row_valid, ht.view(np.int16)

    def _ship(self, arr: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if self.device.type == "cpu":
            return t
        if self._pin:
            t = t.pin_memory()
        return t.to(self.device, non_blocking=True)

    def put_batch(self, hb, with_hll: bool = True,
                  hll_lanes: Optional[torch.Tensor] = None) -> DeviceBatch:
        """Ship one HostBatch (``with_hll=False`` skips the packed plane:
        pass B and host-side register folds never read it).  ``hll_lanes``
        (:meth:`put_hll_lanes`) names the float32 lanes the pass-A fold
        hashes on the device."""
        xt, rv, ht = self._host_views(hb, with_hll)
        return DeviceBatch(self._ship(xt), self._ship(rv), self._ship(ht),
                           hll_lanes)

    def stage_batches(self, hbs: List, with_hll: bool = True,
                      hll_lanes: Optional[torch.Tensor] = None
                      ) -> StackedBatch:
        """Ship several HostBatches as one stacked copy per plane."""
        views = [self._host_views(hb, with_hll) for hb in hbs]
        return StackedBatch(
            self._ship(np.stack([v[0] for v in views])),
            self._ship(np.stack([v[1] for v in views])),
            self._ship(np.stack([v[2] for v in views])),
            len(hbs), hll_lanes)

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

    def step_a(self, state: State, db: DeviceBatch) -> State:
        with fused.observe_dispatch("step_a", self.device):
            state = self._fold_a(state, db.xt, db.row_valid, db.hllt)
            return self._hash_a(state, db.xt, db.row_valid, db.hll_lanes)

    def scan_a(self, state: State, sb: StackedBatch) -> State:
        with fused.observe_dispatch("scan_a", self.device,
                                    batches=sb.n_batches):
            for i in range(sb.n_batches):
                state = self._fold_a(state, sb.xts[i], sb.row_valids[i],
                                     sb.hllts[i])
                state = self._hash_a(state, sb.xts[i], sb.row_valids[i],
                                     sb.hll_lanes)
        return state

    def step_b(self, state: State, db: DeviceBatch, lo, hi, mean,
               lanes=None) -> State:
        with fused.observe_dispatch("step_b", self.device,
                                    kernel=self.pass_b_kernel):
            return self._fold_b(state, db.xt, db.row_valid, lo, hi, mean,
                                lanes)

    def scan_b(self, state: State, sb: StackedBatch, lo, hi, mean,
               lanes=None) -> State:
        with fused.observe_dispatch("scan_b", self.device,
                                    batches=sb.n_batches,
                                    kernel=self.pass_b_kernel):
            for i in range(sb.n_batches):
                state = self._fold_b(state, sb.xts[i], sb.row_valids[i],
                                     lo, hi, mean, lanes)
        return state

    def step_ab(self, state: State, state_h: State, db: DeviceBatch, lo, hi,
                mean):
        """Fold one shipped batch into the pass-A state AND the histogram
        state on the provisional ``lo``/``hi``/``mean`` (a single-pass
        profile).  Returns ``(state, state_h)``."""
        with fused.observe_dispatch("step_ab", self.device,
                                    kernel=self.pass_b_kernel):
            state, state_h = self._fold_ab(state, state_h, db.xt,
                                           db.row_valid, db.hllt, lo, hi,
                                           mean)
            return (self._hash_a(state, db.xt, db.row_valid, db.hll_lanes),
                    state_h)

    def scan_ab(self, state: State, state_h: State, sb: StackedBatch, lo,
                hi, mean):
        """:meth:`step_ab` over the staged batches, in order."""
        with fused.observe_dispatch("scan_ab", self.device,
                                    batches=sb.n_batches,
                                    kernel=self.pass_b_kernel):
            for i in range(sb.n_batches):
                state, state_h = self._fold_ab(
                    state, state_h, sb.xts[i], sb.row_valids[i],
                    sb.hllts[i], lo, hi, mean)
                state = self._hash_a(state, sb.xts[i], sb.row_valids[i],
                                     sb.hll_lanes)
        return state, state_h

    def _fold_spearman(self, state: State, xt, row_valid, grid) -> State:
        if self.n_num <= fused.MAX_FUSED_COLS:
            return fused.spearman_update(state, xt, row_valid, grid)
        ranks = fused.rank_transform(xt, row_valid, grid)
        return fused.spearman_update_wide(state, ranks, row_valid)

    def step_spearman(self, state: State, db: DeviceBatch,
                      sorted_sample: torch.Tensor, kept: torch.Tensor
                      ) -> State:
        """The exact tier (past the rank kernels' columns): fold one
        batch's ranks in the sorted padded row sample (``sorted_sample``
        (n_num, K) float32, ``kept`` (n_num,) int32 on the device)."""
        return fused.spearman_update_exact(state, db.xt, db.row_valid,
                                           sorted_sample, kept)

    def scan_spearman(self, state: State, sb: StackedBatch,
                      sorted_sample: torch.Tensor, kept: torch.Tensor
                      ) -> State:
        """:meth:`step_spearman` over the staged slices, in order."""
        for i in range(sb.n_batches):
            state = fused.spearman_update_exact(
                state, sb.xts[i], sb.row_valids[i], sorted_sample, kept)
        return state

    def step_spearman_grid(self, state: State, db: DeviceBatch,
                           grid: torch.Tensor) -> State:
        """Fold one batch into the Spearman state against ``grid``, the
        (n_num, G) CDF grid on the device: K5 (its ranks, then their
        Gram) up to 512 columns, else ranks (K6) then their Gram (K3)."""
        return self._fold_spearman(state, db.xt, db.row_valid, grid)

    def scan_spearman_grid(self, state: State, sb: StackedBatch,
                           grid: torch.Tensor) -> State:
        """Fold the staged batches in order, re-reading the slices pass B
        already shipped."""
        for i in range(sb.n_batches):
            state = self._fold_spearman(state, sb.xts[i], sb.row_valids[i],
                                        grid)
        return state

    # -- finalize ------------------------------------------------------------

    def bounds_b_device(self, state: State):
        """(lo, hi, mean) float32 pass-B inputs computed on the device from
        the pass-A state (:func:`bounds_from_state`)."""
        return bounds_from_state(state)

    def place_state(self, state) -> State:
        """A state (numpy or tensors, e.g. a merged or restored one) on
        this runner's device."""
        return state_from_numpy(state_to_numpy(state), self.device)

    def host_state(self, state: State) -> Dict[str, Any]:
        """The state as numpy arrays (what a checkpoint saves)."""
        return state_to_numpy(state)

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

    def finalize_a(self, state: State) -> Dict[str, Any]:
        return state_to_numpy(state)

    def finalize_b(self, state: State) -> Dict[str, Any]:
        return state_to_numpy(state)

    def finalize_spearman(self, state: State) -> Dict[str, Any]:
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
