"""Profiler configuration of the port (counterpart of ``tpuprof/config.py``).

Every field of the reference's ``ProfilerConfig`` exists here under the same
name and default, so a reference configuration carries over, and each is
validated as the reference validates it.  The two that choose between the
reference's Pallas kernels and XLA twins (``use_pallas``, ``use_fused``)
mean nothing on CUDA: they are accepted only at their default and raise
``NotImplementedError`` otherwise — never silently ignored.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
from typing import Optional, Sequence

PASS_B_KERNELS = ("cumulative", "legacy")
PROFILE_PASSES = ("two_pass", "fused")
NESTED_POLICIES = ("stringify", "opaque")

# resolve_unique_budget's "auto" sizing: a quarter of available RAM at 8
# bytes a row, floored at the historical default (auto never tracks less
# than the default) and capped at 2 GB of buffers
UNIQUE_BUDGET_DEFAULT_ROWS = 1 << 25
UNIQUE_BUDGET_RAM_SHARE = 0.25
UNIQUE_BUDGET_CAP_ROWS = 1 << 28

# field -> why it does nothing in the port: the reference's switches between
# Pallas kernels and XLA twins; the port always runs its CUDA kernels
_LATER = {
    "use_pallas": "the port always runs its kernels on CUDA",
    "use_fused": "the port always runs its kernels on CUDA",
}

# "auto" and "tpu" name the port's engine (the card, or the kernels' plain
# versions with device="cpu"); "cpu" names the exact pandas oracle
BACKENDS = ("auto", "cpu", "tpu")
WAREHOUSE_FORMATS = ("parquet", "off")
AOT_CACHE_MODES = ("on", "off")
READ_CACHE_MODES = ("on", "off")

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

    # ---- exact distinct (kernels/unique.py) -------------------------------
    parity: bool = False            # the reference's answers in one switch:
                                    # exact_distinct and spearman, with a
                                    # per-user spill dir under the temp dir
                                    # when none is given (removed after
                                    # the profile)
    unique_partitions: Optional[int] = None  # hash partitions of the
                                             # tracker (resolve_*); the
                                             # results are the same at
                                             # every count
    unique_spill_workers: Optional[int] = None  # spill writes in flight on
                                                # the io tier (resolve_*;
                                                # 0: synchronous)
    unique_spill_dir: Optional[str] = None  # columns past the budgets spill
                                            # sorted hash runs here (8 B a
                                            # row) and stay exact; None:
                                            # the HLL estimate past them
    spill_dir_auto: bool = False    # unique_spill_dir was derived by parity:
                                    # cleanup may remove the directory too
    exact_distinct: bool = False    # every column's distinct count exact at
                                    # any size (needs unique_spill_dir)

    # ---- telemetry (tpuprof_torch/obs) -----------------------------------
    metrics_enabled: Optional[bool] = None  # counters, gauges and span
                                            # histograms on the process
                                            # registry (resolve_*: None =
                                            # TPUPROF_METRICS, else on iff
                                            # metrics_path is set)
    metrics_path: Optional[str] = None      # JSONL event sink (span events
                                            # as they close, metric
                                            # snapshots); also
                                            # TPUPROF_METRICS_PATH
    metrics_interval: float = 0.0           # seconds between snapshot
                                            # events of the CLI's ticker
                                            # (0: the final one only)
    metrics_max_bytes: Optional[int] = None  # the sink rotates PATH ->
                                             # PATH.1 once past this many
                                             # bytes (resolve_*)
    metrics_block_sample: int = 0           # time every Nth device
                                            # dispatch with CUDA events
                                            # (kernels/fused.py); 0 never
                                            # synchronizes for telemetry

    # ---- devices, processes, the elastic fleet ----------------------------
    mesh_devices: Optional[int] = None      # CUDA devices one process
                                            # shards a scan over (None:
                                            # every device it sees)
    barrier_timeout_s: Optional[float] = None  # watchdog on the cross-
                                               # process barriers and the
                                               # gloo group's timeout
    elastic: Optional[bool] = None          # elastic fleet membership
                                            # (runtime/fleet.py; resolve_*)
    fleet_dir: Optional[str] = None         # the fleet's shared directory
    fleet_host_id: Optional[str] = None     # this member's stable id
    liveness_timeout_s: Optional[float] = None  # heartbeat staleness after
                                                # which a member is dead

    # ---- the serve daemon (tpuprof_torch/serve, runtime/aot.py) -----------
    compile_cache_dir: Optional[str] = None  # where nvcc builds the kernel
                                             # libraries (resolve_*)
    serve_workers: Optional[int] = None     # concurrent jobs (resolve_*)
    serve_queue_depth: Optional[int] = None  # jobs queued before submits
                                             # reject
    serve_tenant_quota: Optional[int] = None  # per-tenant queued+running
                                              # cap (0: unlimited)
    serve_backlog: Optional[int] = None     # queued compute jobs past which
                                            # uncacheable submits shed
                                            # (0: off)
    serve_drain_timeout_s: Optional[float] = None  # SIGTERM drain budget
    job_timeout_s: Optional[float] = None   # per-job watchdog of a served
                                            # profile (None: off)
    aot_cache_dir: Optional[str] = None     # the store of built kernel
                                            # libraries (runtime/aot.py)
    aot_cache: Optional[str] = None         # "on" | "off" (resolve_*)
    aot_prewarm: Optional[int] = None       # hottest store keys a daemon
                                            # warms at start
    read_cache: Optional[str] = None        # "on" | "off": the read tier
    read_cache_entries: Optional[int] = None  # its LRU entry cap
    read_cache_bytes: Optional[int] = None  # its LRU payload-bytes cap

    # ---- the HTTP edge, its breaker, the watch, the warehouse -------------
    serve_http_port: Optional[int] = None   # the edge's port (0:
                                            # ephemeral; None: no edge)
    serve_auth_file: Optional[str] = None   # '<token> <tenant>' lines
    breaker_threshold: Optional[int] = None  # corrupt warehouse reads a
                                             # source before /v1/query
                                             # skips its warehouse tier
    breaker_cooldown_s: Optional[float] = None  # open -> half-open
    serve_max_connections: Optional[int] = None  # open-socket ceiling
    serve_conn_timeout_s: Optional[float] = None  # per-connection I/O
                                                  # deadline (slow loris)
    serve_max_header_bytes: Optional[int] = None  # request head cap
    serve_max_body_bytes: Optional[int] = None  # request body cap
    watch_every_s: Optional[float] = None   # seconds between watch cycles
    warehouse_dir: Optional[str] = None     # columnar warehouse root
    warehouse_format: Optional[str] = None  # "parquet" | "off"
    artifact_keep: Optional[int] = None     # watch-cycle artifacts kept

    # ---- engine selection -------------------------------------------------
    backend: str = "auto"                   # "auto" | "tpu": the port's
                                            # engine; "cpu": the exact
                                            # pandas oracle (backends/cpu)

    # ---- the reference's kernel switches (see _LATER) ---------------------
    use_pallas: Optional[bool] = None
    use_fused: Optional[bool] = None

    # ---- Spearman rank correlation (pass B, kernels K5/K6/K3) -------------
    spearman: bool = False
    spearman_grid: int = 256        # G: CDF-grid points of the rank pass,
                                    # clamped to MAX_SPEAR_GRID

    def __post_init__(self) -> None:
        defaults = {f.name: f.default for f in dataclasses.fields(self)}
        for name, reason in _LATER.items():
            value = getattr(self, name)
            if value != defaults[name]:
                raise NotImplementedError(
                    f"{name}={value!r} has no meaning in the PyTorch port "
                    f"({reason}); leave it at {defaults[name]!r}")
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
        if self.barrier_timeout_s is not None \
                and self.barrier_timeout_s <= 0:
            raise ValueError(
                "barrier_timeout_s must be > 0 (or None = off)")
        if self.liveness_timeout_s is not None \
                and self.liveness_timeout_s <= 0:
            raise ValueError("liveness_timeout_s must be > 0 (or None)")
        if self.mesh_devices is not None and self.mesh_devices < 1:
            raise ValueError("mesh_devices must be >= 1 (or None = every "
                             "device the process sees)")
        if self.job_timeout_s is not None and self.job_timeout_s <= 0:
            raise ValueError("job_timeout_s must be > 0 (or None = off)")
        if self.aot_cache is not None \
                and self.aot_cache not in AOT_CACHE_MODES:
            raise ValueError(
                f"aot_cache={self.aot_cache!r} — use one of "
                f"{AOT_CACHE_MODES} (or None for the "
                "TPUPROF_AOT_CACHE/default resolution)")
        if self.aot_prewarm is not None and self.aot_prewarm < 0:
            raise ValueError("aot_prewarm must be >= 0 (0 = no "
                             "prewarm; or None)")
        if self.serve_workers is not None and self.serve_workers < 1:
            raise ValueError("serve_workers must be >= 1 (or None)")
        if self.serve_queue_depth is not None \
                and self.serve_queue_depth < 1:
            raise ValueError("serve_queue_depth must be >= 1 (or None)")
        if self.serve_tenant_quota is not None \
                and self.serve_tenant_quota < 0:
            raise ValueError(
                "serve_tenant_quota must be >= 0 (0 = unlimited; or "
                "None)")
        if self.serve_backlog is not None and self.serve_backlog < 0:
            raise ValueError(
                "serve_backlog must be >= 0 (0 = shedding off; or None)")
        if self.serve_drain_timeout_s is not None \
                and self.serve_drain_timeout_s < 0:
            raise ValueError(
                "serve_drain_timeout_s must be >= 0 (or None)")
        if self.read_cache is not None \
                and self.read_cache not in READ_CACHE_MODES:
            raise ValueError(
                f"read_cache={self.read_cache!r} — use one of "
                f"{READ_CACHE_MODES} (or None for the "
                "TPUPROF_READ_CACHE/default resolution)")
        if self.read_cache_entries is not None \
                and self.read_cache_entries < 1:
            raise ValueError("read_cache_entries must be >= 1 (or None)")
        if self.read_cache_bytes is not None \
                and self.read_cache_bytes < 1:
            raise ValueError("read_cache_bytes must be >= 1 (or None)")
        if self.metrics_interval < 0:
            raise ValueError("metrics_interval must be >= 0")
        if self.metrics_max_bytes is not None \
                and self.metrics_max_bytes < 1:
            raise ValueError(
                "metrics_max_bytes must be >= 1 (or None = unlimited)")
        if self.backend not in BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r} (expected "
                             "cpu|tpu|auto)")
        if self.watch_every_s is not None and self.watch_every_s < 0:
            raise ValueError(
                "watch_every_s must be >= 0 (0 = back-to-back cycles; "
                "or None)")
        if self.artifact_keep is not None and self.artifact_keep < 1:
            raise ValueError("artifact_keep must be >= 1 (or None)")
        if self.warehouse_format is not None \
                and self.warehouse_format not in WAREHOUSE_FORMATS:
            raise ValueError(
                f"warehouse_format={self.warehouse_format!r} — use one "
                f"of {WAREHOUSE_FORMATS} (or None for the "
                "TPUPROF_WAREHOUSE_FORMAT/default resolution)")
        if self.serve_http_port is not None \
                and not 0 <= self.serve_http_port <= 65535:
            raise ValueError(
                "serve_http_port must be in [0, 65535] (0 = ephemeral; "
                "or None = no HTTP edge)")
        if self.breaker_threshold is not None \
                and self.breaker_threshold < 1:
            raise ValueError("breaker_threshold must be >= 1 (or None)")
        if self.breaker_cooldown_s is not None \
                and self.breaker_cooldown_s < 0:
            raise ValueError("breaker_cooldown_s must be >= 0 (or None)")
        if self.serve_max_connections is not None \
                and self.serve_max_connections < 1:
            raise ValueError(
                "serve_max_connections must be >= 1 (or None)")
        if self.serve_conn_timeout_s is not None \
                and self.serve_conn_timeout_s <= 0:
            raise ValueError(
                "serve_conn_timeout_s must be > 0 (or None)")
        if self.serve_max_header_bytes is not None \
                and self.serve_max_header_bytes < 1024:
            raise ValueError(
                "serve_max_header_bytes must be >= 1024 (or None)")
        if self.serve_max_body_bytes is not None \
                and self.serve_max_body_bytes < 1024:
            raise ValueError(
                "serve_max_body_bytes must be >= 1024 (or None)")
        if self.metrics_block_sample < 0:
            raise ValueError("metrics_block_sample must be >= 0 "
                             "(0 disables block-timing sampling)")
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
        if self.parity:
            if not self.exact_passes:
                raise ValueError(
                    "parity conflicts with single-pass mode "
                    "(exact_passes=False): the reference's histograms "
                    "and top-k counts are exact, which needs the "
                    "second scan")
            self.exact_distinct = True
            self.spearman = True
            if self.unique_spill_dir is None:
                # one per-user directory, not one a run: run files carry
                # per-tracker tokens, and the next parity run's age-gated
                # sweep reclaims a crashed run's litter here
                import tempfile
                uid = os.getuid() if hasattr(os, "getuid") else "u"
                self.unique_spill_dir = os.path.join(
                    tempfile.gettempdir(), f"tpuprof-parity-{uid}")
                self.spill_dir_auto = True
        if self.exact_distinct and not self.unique_spill_dir:
            raise ValueError(
                "exact_distinct needs unique_spill_dir (CLI: "
                "--unique-spill-dir, or --parity which derives one): "
                "exact counting stores 8 bytes per distinct value per "
                "column, which must be able to spill past the RAM "
                "budget")
        if isinstance(self.unique_track_total_rows, str):
            v = self.unique_track_total_rows.strip().lower()
            if v != "auto":
                try:
                    int(v)
                except ValueError:
                    raise ValueError(
                        "unique_track_total_rows must be an int, "
                        "'auto' (derive the budget from available "
                        "RAM), or None (env/default resolution) — got "
                        f"{self.unique_track_total_rows!r}") from None
        if self.unique_partitions is not None:
            resolve_unique_partitions(self.unique_partitions)  # raises
        if self.unique_spill_workers is not None \
                and self.unique_spill_workers < 0:
            raise ValueError("unique_spill_workers must be >= 0 "
                             "(0 = synchronous spill writes; or None)")
        if self.exact_distinct and (
                self.unique_track_rows <= 0
                or resolve_unique_budget(self.unique_track_total_rows)
                <= 0):
            raise ValueError(
                "exact_distinct conflicts with a disabled tracking "
                "budget (unique_track_rows/unique_track_total_rows "
                "<= 0): exact counting needs the in-memory tier.  Set "
                "the row knobs positive, or "
                "unique_track_total_rows='auto' (CLI: "
                "--unique-track-total-rows auto) to size the global "
                "budget from available RAM")
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
        """The resolved pass-B formulation (:func:`resolve_pass_b_kernel`
        of ``pass_b_kernel``): read where a runner, a runner-cache key or
        a store key is made, as the reference reads it."""
        return resolve_pass_b_kernel(self.pass_b_kernel)

    @classmethod
    def from_kwargs(cls, **kwargs) -> "ProfilerConfig":
        """Build a config from ``ProfileReport(**kwargs)``, ignoring
        names that are no field, as the reference does."""
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in kwargs.items() if k in fields})


def _available_ram_bytes() -> int:
    """Available host RAM: ``MemAvailable`` of ``/proc/meminfo``, else the
    sysconf physical-page estimate, else 2 GB."""
    try:
        with open("/proc/meminfo") as fh:
            for line in fh:
                if line.startswith("MemAvailable:"):
                    return int(line.split()[1]) * 1024
    except (OSError, ValueError, IndexError):
        pass
    try:
        return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_AVPHYS_PAGES")
    except (AttributeError, ValueError, OSError):
        return 2 << 30


def resolve_unique_budget(value=None, available_bytes: Optional[int] = None
                          ) -> int:
    """Global exact-unique tracking budget in rows (all columns): an int
    wins; ``"auto"`` takes ``UNIQUE_BUDGET_RAM_SHARE`` of available RAM at
    8 bytes a row, floored at ``UNIQUE_BUDGET_DEFAULT_ROWS`` and capped at
    ``UNIQUE_BUDGET_CAP_ROWS``; None reads ``TPUPROF_UNIQUE_TRACK_TOTAL_ROWS``
    (an int or ``auto``), else the default."""
    if value is None:
        env = os.environ.get("TPUPROF_UNIQUE_TRACK_TOTAL_ROWS")
        value = env if env not in (None, "") else UNIQUE_BUDGET_DEFAULT_ROWS
    if isinstance(value, str):
        v = value.strip().lower()
        if v != "auto":
            return int(v)
        avail = available_bytes if available_bytes is not None \
            else _available_ram_bytes()
        rows = int(avail * UNIQUE_BUDGET_RAM_SHARE) // 8
        return max(UNIQUE_BUDGET_DEFAULT_ROWS,
                   min(rows, UNIQUE_BUDGET_CAP_ROWS))
    return int(value)


def resolve_unique_partitions(value: Optional[int] = None) -> int:
    """Hash partitions of the exact-unique tracker: the config value, else
    ``TPUPROF_UNIQUE_PARTITIONS``, else 16.  A power of two in [1, 256] (a
    partition is the hash's top bits); the results are the same at every
    count, only the sort and resolve working sets change."""
    if value is None:
        env = _env_int("TPUPROF_UNIQUE_PARTITIONS")
        value = env if env is not None else 16
    p = int(value)
    if p < 1 or p > 256 or (p & (p - 1)):
        raise ValueError(
            f"unique_partitions={value!r} — use a power of two in "
            "[1, 256] (the partition id is the hash's top bits)")
    return p


def resolve_spill_workers(value: Optional[int] = None) -> int:
    """Spill-run writes in flight on the io tier (``ingest/prep.py``) while
    the scan folds on: the config value, else
    ``TPUPROF_UNIQUE_SPILL_WORKERS``, else 2; 0 writes on the fold thread.
    The runs are byte-identical at any number."""
    if value is not None:
        return max(int(value), 0)
    env = _env_int("TPUPROF_UNIQUE_SPILL_WORKERS")
    return max(env, 0) if env is not None else 2


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
    """A watchdog deadline (``drain_timeout_s``, ``barrier_timeout_s``):
    the config value, else
    the env var ``var``, else None (the call runs unwatched)."""
    if value is not None:
        return float(value) if value > 0 else None
    env = _env_float(var)
    return env if env and env > 0 else None


def resolve_elastic(value: Optional[bool] = None) -> bool:
    """Elastic fleet membership (``runtime/fleet.py``): the config value,
    else ``TPUPROF_ELASTIC`` ("", "0", "false" and "no" are off), else
    off."""
    if value is not None:
        return bool(value)
    env = os.environ.get("TPUPROF_ELASTIC")
    if env is not None:
        return env not in ("", "0", "false", "no")
    return False


def resolve_fleet_dir(value: Optional[str] = None) -> Optional[str]:
    """The fleet's shared directory (manifest, claims, heartbeats,
    contribution parts): the config value, else ``TPUPROF_FLEET_DIR``, else
    None.  Elastic runs need one on storage every member sees."""
    if value:
        return str(value)
    return os.environ.get("TPUPROF_FLEET_DIR") or None


def resolve_fleet_host_id(value: Optional[str] = None) -> str:
    """This member's stable identity: the config value, else
    ``TPUPROF_FLEET_HOST_ID``, else ``<hostname>-<pid>``.  A restarted
    member presenting the same id adopts its predecessor's claims and
    checkpoint, so a deployment pins it per slot."""
    if value:
        return str(value)
    env = os.environ.get("TPUPROF_FLEET_HOST_ID")
    if env:
        return env
    import socket
    return f"{socket.gethostname()}-{os.getpid()}"


def resolve_liveness_timeout(value: Optional[float] = None) -> float:
    """Heartbeat staleness after which a fleet member is dead and its
    unfinished fragments may be stolen: the config value, else
    ``TPUPROF_LIVENESS_TIMEOUT_S``, else 10 seconds."""
    if value is not None:
        return float(value)
    env = _env_float("TPUPROF_LIVENESS_TIMEOUT_S")
    return env if env and env > 0 else 10.0


def resolve_metrics_max_bytes(value: Optional[int] = None) -> Optional[int]:
    """The JSONL sink's growth cap: the config value, else
    ``TPUPROF_METRICS_MAX_BYTES``, else None (unlimited).  Past the cap the
    sink rotates ``PATH`` to ``PATH.1`` once (``obs/events.JsonlSink``)."""
    if value is not None:
        return int(value) if value > 0 else None
    env = _env_int("TPUPROF_METRICS_MAX_BYTES")
    return env if env and env > 0 else None


def resolve_metrics_enabled(value: Optional[bool] = None,
                            metrics_path: Optional[str] = None) -> bool:
    """The telemetry switch (``tpuprof_torch/obs``): the config value, else
    ``TPUPROF_METRICS`` ("", "0", "false" and "no" are off, anything else
    on), else on exactly when a JSONL sink path was asked for."""
    if value is not None:
        return bool(value)
    env = os.environ.get("TPUPROF_METRICS")
    if env is not None:
        return env not in ("", "0", "false", "no")
    return metrics_path is not None


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


def resolve_pass_b_kernel(value: Optional[str] = None) -> str:
    """The pass-B formulation (counterpart of the reference's
    ``resolve_pass_b_kernel``): the config value, else
    ``TPUPROF_PASS_B_KERNEL``, else ``cumulative``; a value outside
    :data:`PASS_B_KERNELS` raises ``ValueError`` naming where it came
    from.  Both names give the same counts (one K2 serves both,
    ``kernels/hist.py``); the name keys the runner cache and the store of
    built libraries, and the variable stays the reference's rollback
    switch."""
    for cand, origin in ((value, "pass_b_kernel"),
                         (os.environ.get("TPUPROF_PASS_B_KERNEL"),
                          "TPUPROF_PASS_B_KERNEL")):
        if cand:
            if cand not in PASS_B_KERNELS:
                raise ValueError(
                    f"{origin}={cand!r} — use one of {PASS_B_KERNELS}")
            return cand
    return "cumulative"


def resolve_seed_edges(value: Optional[str] = None) -> Optional[str]:
    """The ``tpuprof-stats-v1`` artifact whose bin seeds give a fused
    profile its provisional edges: the config value, else
    ``TPUPROF_SEED_EDGES``, else None (the first batch's sketch).  A seed
    that cannot be used warns and falls back to the sketch."""
    if value:
        return str(value)
    return os.environ.get("TPUPROF_SEED_EDGES") or None


# ---------------------------------------------------------------------------
# the serve daemon (tpuprof_torch/serve) and the store of built kernel
# libraries (runtime/aot.py): the reference's resolvers and env twins
# ---------------------------------------------------------------------------

def resolve_serve_workers(value: Optional[int] = None) -> int:
    """Serve worker threads, the jobs that run at once: the config value,
    else ``TPUPROF_SERVE_WORKERS``, else 2."""
    if value is not None:
        return max(int(value), 1)
    env = _env_int("TPUPROF_SERVE_WORKERS")
    return max(env, 1) if env is not None else 2


def resolve_serve_queue_depth(value: Optional[int] = None) -> int:
    """The admission queue's bound (jobs waiting beyond the running set):
    the config value, else ``TPUPROF_SERVE_QUEUE_DEPTH``, else 32.  A
    submit past it is rejected at once."""
    if value is not None:
        return max(int(value), 1)
    env = _env_int("TPUPROF_SERVE_QUEUE_DEPTH")
    return max(env, 1) if env is not None else 32


def resolve_serve_tenant_quota(value: Optional[int] = None) -> int:
    """A tenant's queued+running cap: the config value, else
    ``TPUPROF_SERVE_TENANT_QUOTA``, else 0 (unlimited)."""
    if value is not None:
        return max(int(value), 0)
    env = _env_int("TPUPROF_SERVE_TENANT_QUOTA")
    return max(env, 0) if env is not None else 0


def resolve_job_timeout(value: Optional[float] = None) -> Optional[float]:
    """The per-job watchdog of the serve daemon: a job running past this
    many seconds fails with :class:`WatchdogTimeout` (exit code 4) and its
    worker is freed.  The config value, else ``TPUPROF_JOB_TIMEOUT_S``,
    else None (off)."""
    return resolve_watchdog_timeout(value, "TPUPROF_JOB_TIMEOUT_S")


def resolve_serve_backlog(value: Optional[int] = None) -> int:
    """The shed budget: past this many queued compute jobs an uncacheable
    submit is shed while the read tier keeps answering.  The config value,
    else ``TPUPROF_SERVE_BACKLOG``, else 0 (off: only the queue depth
    applies)."""
    if value is not None:
        return max(int(value), 0)
    env = _env_int("TPUPROF_SERVE_BACKLOG")
    return max(env, 0) if env is not None else 0


def resolve_serve_drain_timeout(value: Optional[float] = None) -> float:
    """How long a stopping daemon lets its running jobs finish: the config
    value, else ``TPUPROF_SERVE_DRAIN_TIMEOUT_S``, else 30 seconds."""
    if value is not None:
        return max(float(value), 0.0)
    env = _env_float("TPUPROF_SERVE_DRAIN_TIMEOUT_S")
    return max(env, 0.0) if env is not None else 30.0


def resolve_aot_cache_dir(value: Optional[str] = None) -> Optional[str]:
    """The store of built kernel libraries (``runtime/aot.py``): the config
    value, else ``TPUPROF_AOT_CACHE_DIR``, else None (no store; the serve
    daemon defaults it to ``SPOOL/aot``)."""
    if value:
        return str(value)
    return os.environ.get("TPUPROF_AOT_CACHE_DIR") or None


def _mode(value: Optional[str], field: str, var: str, modes) -> str:
    for cand, origin in ((value, field), (os.environ.get(var), var)):
        if cand:
            if cand not in modes:
                raise ValueError(f"{origin}={cand!r} — use one of {modes}")
            return cand
    return "on"


def resolve_aot_cache(value: Optional[str] = None) -> str:
    """The store's switch: the config value, else ``TPUPROF_AOT_CACHE``,
    else ``on``.  ``off`` never reads or writes an entry."""
    return _mode(value, "aot_cache", "TPUPROF_AOT_CACHE", AOT_CACHE_MODES)


def resolve_aot_prewarm(value: Optional[int] = None) -> int:
    """How many of the store manifest's hottest keys a starting daemon
    warms in the background: the config value, else
    ``TPUPROF_AOT_PREWARM``, else 4; 0 warms none."""
    if value is not None:
        return max(int(value), 0)
    env = _env_int("TPUPROF_AOT_PREWARM")
    return max(env, 0) if env is not None else 4


def resolve_read_cache(value: Optional[str] = None) -> str:
    """The read tier's switch (the result cache and coalescing): the config
    value, else ``TPUPROF_READ_CACHE``, else ``on``."""
    return _mode(value, "read_cache", "TPUPROF_READ_CACHE",
                 READ_CACHE_MODES)


def resolve_read_cache_entries(value: Optional[int] = None) -> int:
    """The result cache's entry cap: the config value, else
    ``TPUPROF_READ_CACHE_ENTRIES``, else 512."""
    if value is not None:
        return max(int(value), 1)
    env = _env_int("TPUPROF_READ_CACHE_ENTRIES")
    return max(env, 1) if env is not None else 512


def resolve_read_cache_bytes(value: Optional[int] = None) -> int:
    """The result cache's payload-bytes cap: the config value, else
    ``TPUPROF_READ_CACHE_BYTES``, else 64 MiB."""
    if value is not None:
        return max(int(value), 1)
    env = _env_int("TPUPROF_READ_CACHE_BYTES")
    return max(env, 1) if env is not None else 64 << 20


def resolve_serve_http_port(value: Optional[int] = None) -> Optional[int]:
    """The HTTP edge's port (``serve_http_port``): the config value, else
    ``TPUPROF_SERVE_HTTP_PORT``, else None = no edge (the spool is the only
    front door).  0 binds an ephemeral port, advertised under
    ``SPOOL/daemons/http.<daemon-id>`` and printed at start."""
    if value is not None:
        return int(value)
    env = _env_int("TPUPROF_SERVE_HTTP_PORT")
    return env if env is not None else None


def resolve_serve_auth_file(value: Optional[str] = None) -> Optional[str]:
    """The edge's bearer-token file (``serve_auth_file``: one ``<token>
    <tenant>`` pair a line): the config value, else
    ``TPUPROF_SERVE_AUTH_FILE``, else None = an open edge."""
    if value:
        return str(value)
    return os.environ.get("TPUPROF_SERVE_AUTH_FILE") or None


def resolve_breaker_threshold(value: Optional[int] = None) -> int:
    """Consecutive corrupt or failed warehouse reads a source before its
    breaker opens (``breaker_threshold``): the config value, else
    ``TPUPROF_BREAKER_THRESHOLD``, else 3."""
    if value is not None:
        return max(int(value), 1)
    env = _env_int("TPUPROF_BREAKER_THRESHOLD")
    return max(env, 1) if env is not None else 3


def resolve_breaker_cooldown(value: Optional[float] = None) -> float:
    """Seconds an open breaker waits before one half-open probe
    (``breaker_cooldown_s``): the config value, else
    ``TPUPROF_BREAKER_COOLDOWN_S``, else 30."""
    if value is not None:
        return max(float(value), 0.0)
    env = _env_float("TPUPROF_BREAKER_COOLDOWN_S")
    return max(env, 0.0) if env is not None else 30.0


def resolve_serve_max_connections(value: Optional[int] = None) -> int:
    """Open sockets the edge holds at once (``serve_max_connections``); an
    accept past it answers a terse 503 and closes: the config value, else
    ``TPUPROF_SERVE_MAX_CONNECTIONS``, else 512."""
    if value is not None:
        return max(int(value), 1)
    env = _env_int("TPUPROF_SERVE_MAX_CONNECTIONS")
    return max(env, 1) if env is not None else 512


def resolve_serve_conn_timeout(value: Optional[float] = None) -> float:
    """Per-connection I/O deadline (``serve_conn_timeout_s``, the
    slow-loris defense): the config value, else
    ``TPUPROF_SERVE_CONN_TIMEOUT_S``, else 30 seconds."""
    if value is not None:
        v = float(value)
        return v if v > 0 else 30.0
    env = _env_float("TPUPROF_SERVE_CONN_TIMEOUT_S")
    return env if env and env > 0 else 30.0


def resolve_serve_max_header_bytes(value: Optional[int] = None) -> int:
    """Request line + header bytes the edge buffers before it drops the
    connection (``serve_max_header_bytes``): the config value, else
    ``TPUPROF_SERVE_MAX_HEADER_BYTES``, else 64 KiB."""
    if value is not None:
        return max(int(value), 1024)
    env = _env_int("TPUPROF_SERVE_MAX_HEADER_BYTES")
    return max(env, 1024) if env is not None else 64 << 10


def resolve_serve_max_body_bytes(value: Optional[int] = None) -> int:
    """Request body cap (``serve_max_body_bytes``; a longer declared
    Content-Length answers 400): the config value, else
    ``TPUPROF_SERVE_MAX_BODY_BYTES``, else 1 MiB."""
    if value is not None:
        return max(int(value), 1024)
    env = _env_int("TPUPROF_SERVE_MAX_BODY_BYTES")
    return max(env, 1024) if env is not None else 1 << 20


def resolve_watch_every(value: Optional[float] = None) -> float:
    """Seconds between a watch's cycles a source (``watch_every_s``): the
    config value, else ``TPUPROF_WATCH_EVERY_S``, else 300; 0 runs the
    cycles back to back."""
    if value is not None:
        return max(float(value), 0.0)
    env = _env_float("TPUPROF_WATCH_EVERY_S")
    return max(env, 0.0) if env is not None else 300.0


def resolve_artifact_keep(value: Optional[int] = None) -> int:
    """Watch-cycle artifacts kept a source (``artifact_keep``): the config
    value, else ``TPUPROF_ARTIFACT_KEEP``, else 3."""
    if value is not None:
        return max(int(value), 1)
    env = _env_int("TPUPROF_ARTIFACT_KEEP")
    return max(env, 1) if env is not None else 3


def resolve_warehouse_dir(value: Optional[str] = None) -> Optional[str]:
    """The columnar warehouse root (``warehouse_dir``): the config value,
    else ``TPUPROF_WAREHOUSE_DIR``, else None — no columnar twin for a
    one-shot profile; the watch defaults to ``SPOOL/warehouse`` itself."""
    if value:
        return str(value)
    return os.environ.get("TPUPROF_WAREHOUSE_DIR") or None


def resolve_warehouse_format(value: Optional[str] = None) -> str:
    """``parquet`` (the one columnar encoding) or ``off`` (never write the
    twin, the pyarrow-free opt-out; ``warehouse_format``): the config
    value, else ``TPUPROF_WAREHOUSE_FORMAT``, else ``parquet``."""
    for cand, origin in ((value, "warehouse_format"),
                         (os.environ.get("TPUPROF_WAREHOUSE_FORMAT"),
                          "TPUPROF_WAREHOUSE_FORMAT")):
        if cand:
            if cand not in WAREHOUSE_FORMATS:
                raise ValueError(
                    f"{origin}={cand!r} — use one of {WAREHOUSE_FORMATS}")
            return cand
    return "parquet"
