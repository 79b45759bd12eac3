"""Profiler configuration of the port (counterpart of ``tpuprof/config.py``).

Every field of the reference's ``ProfilerConfig`` exists here under the same
name and default, so a reference configuration carries over.  The fields
this slice of the port runs are validated as the reference validates them;
every other field is accepted only at its default and raises
``NotImplementedError`` naming the later slice otherwise — never silently
ignored.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
from typing import Optional, Sequence

PASS_B_KERNELS = ("cumulative", "legacy")
PROFILE_PASSES = ("two_pass", "fused")
NESTED_POLICIES = ("stringify", "opaque")

# the exact-unique tracker's global row budget when none is given (the
# reference's historical default)
UNIQUE_BUDGET_DEFAULT_ROWS = 1 << 25

_FLEET = "multi-GPU and fleet"
_SERVE = "serve"
_TELEMETRY = "telemetry"

# field -> the later slice that ports it
_LATER = {
    "parity": "exact distinct counting and Spearman",
    "backend": "a CPU oracle backend",
    "unique_partitions": "spilled exact-unique tracking",
    "unique_spill_workers": "spilled exact-unique tracking",
    "unique_spill_dir": "spilled exact-unique tracking",
    "spill_dir_auto": "spilled exact-unique tracking",
    "exact_distinct": "exact distinct counting",
    "mesh_devices": _FLEET,
    "compile_cache_dir": _SERVE,
    "barrier_timeout_s": _FLEET,
    "elastic": _FLEET,
    "fleet_dir": _FLEET,
    "fleet_host_id": _FLEET,
    "liveness_timeout_s": _FLEET,
    "serve_workers": _SERVE,
    "serve_queue_depth": _SERVE,
    "serve_tenant_quota": _SERVE,
    "serve_http_port": _SERVE,
    "serve_auth_file": _SERVE,
    "serve_backlog": _SERVE,
    "serve_drain_timeout_s": _SERVE,
    "breaker_threshold": _SERVE,
    "breaker_cooldown_s": _SERVE,
    "serve_max_connections": _SERVE,
    "serve_conn_timeout_s": _SERVE,
    "serve_max_header_bytes": _SERVE,
    "serve_max_body_bytes": _SERVE,
    "job_timeout_s": _SERVE,
    "watch_every_s": _SERVE,
    "warehouse_dir": _SERVE,
    "warehouse_format": _SERVE,
    "aot_cache_dir": _SERVE,
    "aot_cache": _SERVE,
    "aot_prewarm": _SERVE,
    "read_cache": _SERVE,
    "read_cache_entries": _SERVE,
    "read_cache_bytes": _SERVE,
    "artifact_keep": _SERVE,
    "metrics_enabled": _TELEMETRY,
    "metrics_path": _TELEMETRY,
    "metrics_interval": _TELEMETRY,
    "metrics_max_bytes": _TELEMETRY,
    "metrics_block_sample": _TELEMETRY,
    "use_pallas": "none: the port always runs its kernels on CUDA",
    "use_fused": "none: the port always runs its kernels on CUDA",
}

# the largest Spearman CDF grid (G) the kernels K5/K6 take: each column's
# grid sits in shared memory.  The backend clamps ``spearman_grid`` to it,
# with a warning, on every device (the CPU runs the kernels' plain versions)
MAX_SPEAR_GRID = 256


@dataclasses.dataclass
class ProfilerConfig:
    # ---- parity knobs (reference constructor kwargs) ----------------------
    bins: int = 10                  # histogram bin count
    corr_reject: float = 0.9        # |Pearson| above this vs an earlier
                                    # column rejects the later one (CORR)
    sample_rows: int = 5            # head rows shown in the report
    top_freq: int = 10              # value-count rows shown per CAT column
    correlation_overrides: Optional[Sequence[str]] = None  # never reject
    columns: Optional[Sequence[str]] = None  # profile only these, in order

    # ---- warning thresholds -----------------------------------------------
    high_cardinality_threshold: int = 50
    missing_threshold: float = 0.19
    zeros_threshold: float = 0.5
    skewness_threshold: float = 20.0

    # ---- scan knobs -------------------------------------------------------
    batch_rows: int = 1 << 16       # rows per batch shipped to the device
    scan_batches: int = 8           # S: full groups of S batches ship as one
                                    # host-to-device copy and fold in one
                                    # call; partial groups fold per batch
    quantile_sketch_size: int = 4096  # K: uniform row-sample size
    hll_precision: int = 11         # p: 2^p registers per column
    topk_capacity: int = 4096       # Misra-Gries capacity per CAT column
    unique_track_rows: int = 1 << 22        # exact duplicate detection:
    unique_track_total_rows: Optional[object] = None  # per column / total
    exact_passes: bool = True       # second scan: exact histograms, exact
                                    # MAD and exact top-k recounts
    prepare_workers: Optional[int] = None   # batches prepared concurrently
    seed: int = 0                   # seed of the row sample
    pass_b_kernel: Optional[str] = None     # "cumulative" | "legacy": the
                                            # reference's two pass-B
                                            # formulations (same counts)
    profile_passes: Optional[str] = None    # "two_pass" | "fused" (see
                                            # resolve_profile_passes)
    seed_edges: Optional[str] = None        # artifact seeding a fused
                                            # profile's bin edges
    quantile_probes: Sequence[float] = (0.05, 0.25, 0.5, 0.75, 0.95)
    artifact_path: Optional[str] = None     # the artifact the CLI writes
                                            # after a profile (inert in
                                            # the library, as in the
                                            # reference)

    # ---- nested columns, intra-batch prep, the ingest guard --------------
    nested: str = "stringify"       # "stringify": profile a list/struct/
                                    # map column through str() of each
                                    # value; "opaque": count, missing and
                                    # memory only
    prep_workers: Optional[int] = None      # leaf tasks of one batch's
                                            # prepare run at once
    ingest_retries: Optional[int] = None    # transient prepare failures
                                            # retried (resolve_*)
    retry_backoff_s: Optional[float] = None
    max_quarantined: Optional[int] = None   # poison batches skipped
                                            # before giving up (0: fail)
    quarantine_log: Optional[str] = None    # JSONL of skipped batches
    drain_timeout_s: Optional[float] = None  # watchdog on the device drain

    # ---- durable profiles (runtime/checkpoint.py, runtime/stream.py) -----
    stream_flush_rows: Optional[int] = None  # a stream folds once this
                                             # many rows are buffered
                                             # (None: batch_rows)
    checkpoint_path: Optional[str] = None   # the scan's fold state is
                                            # saved here every
                                            # checkpoint_every_batches
                                            # batches; a rerun resumes
    checkpoint_every_batches: int = 64
    checkpoint_keep: Optional[int] = None   # generations kept (path,
                                            # path.1, ...; resolve_*)

    # ---- reference fields a later slice ports (see _LATER) ----------------
    parity: bool = False
    backend: str = "auto"
    unique_partitions: Optional[int] = None
    unique_spill_workers: Optional[int] = None
    unique_spill_dir: Optional[str] = None
    spill_dir_auto: bool = False
    exact_distinct: bool = False
    mesh_devices: Optional[int] = None
    compile_cache_dir: Optional[str] = None
    barrier_timeout_s: Optional[float] = None
    elastic: Optional[bool] = None
    fleet_dir: Optional[str] = None
    fleet_host_id: Optional[str] = None
    liveness_timeout_s: Optional[float] = None
    serve_workers: Optional[int] = None
    serve_queue_depth: Optional[int] = None
    serve_tenant_quota: Optional[int] = None
    serve_http_port: Optional[int] = None
    serve_auth_file: Optional[str] = None
    serve_backlog: Optional[int] = None
    serve_drain_timeout_s: Optional[float] = None
    breaker_threshold: Optional[int] = None
    breaker_cooldown_s: Optional[float] = None
    serve_max_connections: Optional[int] = None
    serve_conn_timeout_s: Optional[float] = None
    serve_max_header_bytes: Optional[int] = None
    serve_max_body_bytes: Optional[int] = None
    job_timeout_s: Optional[float] = None
    watch_every_s: Optional[float] = None
    warehouse_dir: Optional[str] = None
    warehouse_format: Optional[str] = None
    aot_cache_dir: Optional[str] = None
    aot_cache: Optional[str] = None
    aot_prewarm: Optional[int] = None
    read_cache: Optional[str] = None
    read_cache_entries: Optional[int] = None
    read_cache_bytes: Optional[int] = None
    artifact_keep: Optional[int] = None
    metrics_enabled: Optional[bool] = None
    metrics_path: Optional[str] = None
    metrics_interval: float = 0.0
    metrics_max_bytes: Optional[int] = None
    metrics_block_sample: int = 0
    use_pallas: Optional[bool] = None
    use_fused: Optional[bool] = None

    # ---- Spearman rank correlation (pass B, kernels K5/K6/K3) -------------
    spearman: bool = False
    spearman_grid: int = 256        # G: CDF-grid points of the rank pass,
                                    # clamped to MAX_SPEAR_GRID

    def __post_init__(self) -> None:
        defaults = {f.name: f.default for f in dataclasses.fields(self)}
        for name, slice_name in _LATER.items():
            value = getattr(self, name)
            if value != defaults[name]:
                raise NotImplementedError(
                    f"{name}={value!r} is not in the PyTorch port yet "
                    f"(later slice: {slice_name}); leave it at "
                    f"{defaults[name]!r}")
        if self.profile_passes not in (None,) + PROFILE_PASSES:
            raise ValueError(f"profile_passes={self.profile_passes!r} — "
                             f"use one of {PROFILE_PASSES} (or None for "
                             "the TPUPROF_PROFILE_PASSES/default "
                             "resolution)")
        if self.pass_b_kernel not in (None,) + PASS_B_KERNELS:
            raise ValueError(f"pass_b_kernel={self.pass_b_kernel!r} — use "
                             f"one of {PASS_B_KERNELS} (or None)")
        if self.bins < 1:
            raise ValueError("bins must be >= 1")
        if self.batch_rows < 1:
            raise ValueError("batch_rows must be >= 1")
        if self.scan_batches < 1:
            raise ValueError("scan_batches must be >= 1")
        if self.prepare_workers is not None and self.prepare_workers < 1:
            raise ValueError("prepare_workers must be >= 1 (or None)")
        if self.stream_flush_rows is not None and self.stream_flush_rows < 1:
            raise ValueError("stream_flush_rows must be >= 1 (or None)")
        if self.checkpoint_keep is not None and self.checkpoint_keep < 1:
            raise ValueError("checkpoint_keep must be >= 1 (or None)")
        if self.nested not in NESTED_POLICIES:
            raise ValueError(
                f"nested={self.nested!r} — use 'stringify' (profile the "
                "str() form) or 'opaque' (count/missing only)")
        if self.prep_workers is not None and self.prep_workers < 1:
            raise ValueError("prep_workers must be >= 1 (or None)")
        if self.ingest_retries is not None and self.ingest_retries < 0:
            raise ValueError("ingest_retries must be >= 0 (or None)")
        if self.retry_backoff_s is not None and self.retry_backoff_s < 0:
            raise ValueError("retry_backoff_s must be >= 0 (or None)")
        if self.max_quarantined is not None and self.max_quarantined < 0:
            raise ValueError("max_quarantined must be >= 0 (or None)")
        if self.drain_timeout_s is not None and self.drain_timeout_s <= 0:
            raise ValueError("drain_timeout_s must be > 0 (or None = off)")
        if not 0.0 < self.corr_reject <= 1.0:
            raise ValueError("corr_reject must be in (0, 1]")
        if not 2 <= self.spearman_grid <= 4096:
            raise ValueError("spearman_grid must be in [2, 4096]")
        if self.columns is not None:
            cols = tuple(self.columns)
            if not cols:
                raise ValueError(
                    "columns must name at least one column (or be None "
                    "to profile every column)")
            if not all(isinstance(c, str) and c for c in cols):
                raise ValueError("columns must be non-empty strings")
            dupes = sorted({c for c in cols if cols.count(c) > 1})
            if dupes:
                raise ValueError(f"columns lists duplicates: {dupes}")
            self.columns = cols
        if isinstance(self.unique_track_total_rows, str) \
                and self.unique_track_total_rows.strip().lower() != "auto":
            int(self.unique_track_total_rows)      # raises ValueError
        from tpuprof_torch.kernels.hll import MAX_PRECISION
        if not 4 <= self.hll_precision <= MAX_PRECISION:
            raise ValueError(
                f"hll_precision must be in [4, {MAX_PRECISION}]")

    def fingerprint(self) -> str:
        """Short stable digest of every config field (an artifact's
        ``meta["config"]`` carries it)."""
        items = sorted(
            (f.name, repr(getattr(self, f.name, None)))
            for f in dataclasses.fields(self))
        return hashlib.sha1(repr(items).encode()).hexdigest()[:12]

    @property
    def pass_b(self) -> str:
        """The pass-B formulation name (None means the default)."""
        return self.pass_b_kernel or "cumulative"

    @classmethod
    def from_kwargs(cls, **kwargs) -> "ProfilerConfig":
        """Build a config from ``ProfileReport(**kwargs)``, ignoring
        names that are no field, as the reference does."""
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in kwargs.items() if k in fields})


def resolve_unique_budget(value=None) -> int:
    """Global exact-unique tracking budget in rows: an int wins; "auto"
    takes a quarter of available RAM at 8 bytes a row (floored at the
    default, capped at 2**28 rows); None is the default."""
    if value is None:
        return UNIQUE_BUDGET_DEFAULT_ROWS
    if isinstance(value, str):
        v = value.strip().lower()
        if v != "auto":
            return int(v)
        try:
            avail = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_AVPHYS_PAGES")
        except (AttributeError, ValueError, OSError):
            avail = 2 << 30
        return max(UNIQUE_BUDGET_DEFAULT_ROWS,
                   min(int(avail * 0.25) // 8, 1 << 28))
    return int(value)


def _env_int(var: str) -> Optional[int]:
    env = os.environ.get(var)
    return int(env) if env not in (None, "") else None


def _env_float(var: str) -> Optional[float]:
    env = os.environ.get(var)
    return float(env) if env not in (None, "") else None


def resolve_prep_workers(value: Optional[int] = None,
                         batch_workers: int = 1) -> int:
    """Leaf tasks of one batch's prepare run at once (``ingest/prep.py``):
    the config value, else ``TPUPROF_PREP_WORKERS``, else
    ``TPUPROF_DECODE_THREADS`` (the reference's older name), else 1 when
    ``batch_workers`` prepares already run at once, else every core,
    capped at 16 (the reference's default).  The leaf tasks of a 65,536-row
    batch are about as short as their Python around them, so a column pool
    beside several prepares trades cores for GIL hand-offs: on an 8-core
    H100 host the reference's default made the 200-column headline's
    ``scan_a`` 3x longer (PERF.md, "Findings")."""
    if value is not None:
        return max(int(value), 1)
    for var in ("TPUPROF_PREP_WORKERS", "TPUPROF_DECODE_THREADS"):
        env = os.environ.get(var)
        if env:
            return max(int(env), 1)
    if batch_workers > 1:
        return 1
    return min(os.cpu_count() or 1, 16)


def resolve_prepare_workers(value: Optional[int] = None) -> int:
    """Batches prepared concurrently: the config value, else
    ``TPUPROF_PREPARE_WORKERS``, else half the cores capped at 4."""
    if value is not None:
        return max(int(value), 1)
    env = os.environ.get("TPUPROF_PREPARE_WORKERS")
    if env:
        return max(int(env), 1)
    return max(1, min(4, (os.cpu_count() or 1) // 2))


def resolve_ingest_retries(value: Optional[int] = None) -> int:
    """Retries of a transient prepare failure: the config value, else
    ``TPUPROF_INGEST_RETRIES``, else 2; 0 escalates the first failure."""
    if value is not None:
        return max(int(value), 0)
    env = _env_int("TPUPROF_INGEST_RETRIES")
    return max(env, 0) if env is not None else 2


def resolve_retry_backoff(value: Optional[float] = None) -> float:
    """The first retry's sleep, doubled for each further attempt: the
    config value, else ``TPUPROF_RETRY_BACKOFF_S``, else 0.05."""
    if value is not None:
        return max(float(value), 0.0)
    env = _env_float("TPUPROF_RETRY_BACKOFF_S")
    return max(env, 0.0) if env is not None else 0.05


def resolve_quarantine_log(value: Optional[str] = None) -> Optional[str]:
    """The JSONL side log of quarantined batches: the config value, else
    ``TPUPROF_QUARANTINE_LOG``, else none."""
    if value:
        return str(value)
    return os.environ.get("TPUPROF_QUARANTINE_LOG") or None


def resolve_max_quarantined(value: Optional[int] = None) -> int:
    """The poison-batch budget: the config value, else
    ``TPUPROF_MAX_QUARANTINED``, else 0 (a failing batch fails the
    profile)."""
    if value is not None:
        return max(int(value), 0)
    env = _env_int("TPUPROF_MAX_QUARANTINED")
    return max(env, 0) if env is not None else 0


def resolve_checkpoint_keep(value: Optional[int] = None) -> int:
    """Checkpoint generations kept (the head plus rotated ``path.N``): an
    explicit value, else ``TPUPROF_CHECKPOINT_KEEP``, else 2 — one
    fallback generation behind the head (the reference's)."""
    if value is not None:
        return max(int(value), 1)
    env = _env_int("TPUPROF_CHECKPOINT_KEEP")
    return max(env, 1) if env is not None else 2


def resolve_watchdog_timeout(value: Optional[float], var: str
                             ) -> Optional[float]:
    """A watchdog deadline (``drain_timeout_s``): the config value, else
    the env var ``var``, else None (the call runs unwatched)."""
    if value is not None:
        return float(value) if value > 0 else None
    env = _env_float(var)
    return env if env and env > 0 else None


def resolve_profile_passes(value: Optional[str] = None) -> str:
    """The profile's pass structure: the config value, else
    ``TPUPROF_PROFILE_PASSES``, else ``two_pass``.  ``fused`` folds the
    moments and the histograms in one read of every batch, binning on
    provisional per-column edges (from ``seed_edges`` or the first batch);
    lanes whose edges match the exact pass-A bounds keep their counts, the
    rest re-bin in a second scan of those columns only
    (``tpuprof_torch/runtime/singlepass.py``)."""
    for cand, origin in ((value, "profile_passes"),
                         (os.environ.get("TPUPROF_PROFILE_PASSES"),
                          "TPUPROF_PROFILE_PASSES")):
        if cand:
            if cand not in PROFILE_PASSES:
                raise ValueError(
                    f"{origin}={cand!r} — use one of {PROFILE_PASSES}")
            return cand
    return "two_pass"


def resolve_seed_edges(value: Optional[str] = None) -> Optional[str]:
    """The ``tpuprof-stats-v1`` artifact whose bin seeds give a fused
    profile its provisional edges: the config value, else
    ``TPUPROF_SEED_EDGES``, else None (the first batch's sketch).  A seed
    that cannot be used warns and falls back to the sketch."""
    if value:
        return str(value)
    return os.environ.get("TPUPROF_SEED_EDGES") or None
