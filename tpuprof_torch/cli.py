"""Command line of the port: ``python -m tpuprof_torch profile data.parquet
-o report.html``, ``python -m tpuprof_torch diff A.json B.json``, and the
resident daemon ``python -m tpuprof_torch serve SPOOL`` with its client
``python -m tpuprof_torch submit SPOOL data.parquet``.

Counterpart of the ``profile``, ``diff``, ``serve`` and ``submit`` verbs of
``tpuprof/cli.py``,
with the same flag names and defaults for what the port runs.  ``--device``
stands where the reference has ``--backend``: the profile runs on the first
CUDA device unless ``--device cpu`` asks for the kernels' plain versions,
and without a CUDA device it fails instead of running on the CPU.  Input
errors print one ``tpuprof_torch: error: ...`` line and exit 2; a torn
artifact, an unreadable checkpoint, a spent quarantine budget and a
watchdog timeout print one line too and exit with their error's code
(``errors.exit_code``: 6, 3, 5, 4).  ``--checkpoint PATH`` saves the
scan every ``--checkpoint-every`` batches and resumes from PATH when it
exists.  ``--exact-distinct`` (with ``--unique-spill-dir``) and
``--parity`` count every column's distinct values exactly.

Several processes: the same command with ``--coordinator HOST:PORT
--num-processes N --process-id I`` in each joins a gloo group, scans its
stripe of the dataset's fragments on the CUDA devices it sees, and process
0 writes the report (all three flags or none; ``--parity`` then needs a
shared ``--unique-spill-dir``).  ``--elastic --fleet-dir DIR`` runs an
independent member of an elastic fleet instead (``--fleet-host-id``,
``--liveness-timeout``); a fleet directory that cannot be trusted exits 7,
an injected host death 8.

Telemetry: ``--metrics-json PATH`` streams JSONL events into PATH and
writes the final Prometheus text to ``PATH.prom`` (and the fleet-of-one
view to ``PATH.fleet.prom``); ``--metrics-interval`` adds periodic
snapshots, ``--progress`` a status line on stderr, and ``--trace DIR`` a
``torch.profiler`` Chrome trace of the run.  A run that fails on a typed
error or an unexpected exception leaves a flight-recorder bundle,
``tpuprof-postmortem-<pid>.json`` (in ``TPUPROF_POSTMORTEM_DIR``, else the
working directory), and names it on stderr; SIGUSR1 dumps one and goes on,
SIGTERM dumps one and ends the process.

The daemon (``serve``) runs its jobs on ``cuda:0`` unless ``--device cpu``,
and refuses to start without CUDA.  It answers ``submit`` jobs dropped into
its spool directory, keeps runners and loaded kernel libraries warm, and
stores the built libraries under ``SPOOL/aot`` (``--aot-cache-dir``) so a
restarted daemon runs no nvcc.  SIGTERM drains it (running jobs finish,
results flush) and it exits 0.  ``--compile-cache DIR`` names the directory
nvcc builds into (``--no-compile-cache``: a directory private to the
process, removed at exit).  The HTTP edge of the reference (``serve
--http``, ``submit --url`` and the edge's flags) is a later slice: those
flags exit 2 with one line that says so.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

PROG = "tpuprof_torch"


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog=PROG,
        description="Data profiling on an NVIDIA GPU: the HTML report of "
                    "a Parquet source, and the drift between two "
                    "profiles.")
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("profile", help="profile a table and write the report")
    p.add_argument("source", help="Parquet file/directory path")
    p.add_argument("-o", "--output", default="report.html",
                   help="output HTML path (default: report.html)")
    p.add_argument("--device", default=None,
                   help="torch device to profile on (default: cuda:0, "
                        "which must exist; 'cpu' runs the kernels' plain "
                        "PyTorch versions)")
    p.add_argument("--bins", type=int, default=10)
    p.add_argument("--corr-reject", type=float, default=0.9)
    p.add_argument("--batch-rows", type=int, default=1 << 16)
    p.add_argument("--scan-batches", type=int, default=8, metavar="S",
                   help="prepared batches staged per host-to-device copy "
                        "(1 disables staging)")
    p.add_argument("--prepare-workers", type=int, default=None,
                   metavar="W",
                   help="batches prepared in parallel on the host "
                        "(default: TPUPROF_PREPARE_WORKERS env, else half "
                        "the cores, capped at 4)")
    p.add_argument("--prep-workers", type=int, default=None, metavar="W",
                   help="intra-batch prep parallelism: per-column (and "
                        "per-row-chunk) decode/hash/pack tasks of one "
                        "batch on W shared threads (default: "
                        "TPUPROF_PREP_WORKERS env, else 1 while several "
                        "batches are prepared at once, else all cores, "
                        "capped at 16; 1 = the serial path, "
                        "byte-identical output at any width)")
    p.add_argument("--pass-b-kernel", default=None,
                   choices=("cumulative", "legacy"),
                   help="pass-B binning formulation (default: "
                        "TPUPROF_PASS_B_KERNEL env, else cumulative); "
                        "both give the same counts")
    p.add_argument("--profile-passes", default=None,
                   choices=("two_pass", "fused"),
                   help="profile pass structure (default: "
                        "TPUPROF_PROFILE_PASSES env, else two_pass).  "
                        "fused folds the moments and the histograms in "
                        "one read on provisional bin edges (--seed-edges, "
                        "else a first-batch sketch); missed lanes re-bin "
                        "in a second scan, so the result is the same")
    p.add_argument("--seed-edges", metavar="ARTIFACT", default=None,
                   help="seed a fused profile's bin edges from this "
                        "tpuprof-stats-v1 artifact of the same source "
                        "(default: TPUPROF_SEED_EDGES env, else the "
                        "first-batch sketch)")
    p.add_argument("--sketch-size", type=int, default=4096,
                   help="quantile sample-sketch size K")
    p.add_argument("--hll-precision", type=int, default=11)
    p.add_argument("--single-pass", action="store_true",
                   help="one scan only (sketch-derived histograms/top-k)")
    p.add_argument("--spearman", action="store_true",
                   help="also compute Spearman rank correlations (with "
                        "--single-pass: estimated from the row sample)")
    p.add_argument("--columns", metavar="A,B,C",
                   help="profile only these columns, in this order; "
                        "Parquet reads skip the others entirely (also the "
                        "way past a slow nested column).  Unknown names "
                        "error.")
    p.add_argument("--nested", default="stringify",
                   choices=["stringify", "opaque"],
                   help="nested (list/struct/map) column policy: "
                        "'stringify' profiles the str() form (exact, "
                        "but a Python loop a row for that column); "
                        "'opaque' reports count/missing/memory only "
                        "with no decode at all")
    p.add_argument("--unique-spill-dir", metavar="DIR",
                   help="spill sorted hash runs here so exact UNIQUE "
                        "classification never falls back to an estimate "
                        "(disk cost: 8 bytes/row per high-cardinality "
                        "column)")
    p.add_argument("--unique-track-rows", type=int, default=None,
                   metavar="N",
                   help="per-column RAM budget (rows) for exact "
                        "UNIQUE/distinct tracking before spilling "
                        "(default: 4M rows = ~32 MB/column)")
    p.add_argument("--unique-track-total-rows", default=None,
                   metavar="N|auto",
                   help="global RAM budget (rows across all columns) "
                        "for exact tracking; 'auto' derives it from "
                        "available RAM (quarter of MemAvailable at "
                        "8 B/row, capped at 2 GB) (default: "
                        "TPUPROF_UNIQUE_TRACK_TOTAL_ROWS, else 32M "
                        "rows = ~256 MB)")
    p.add_argument("--unique-partitions", type=int, default=None,
                   metavar="P",
                   help="hash partitions of the exact tracker (power "
                        "of two in [1, 256]; results identical at "
                        "every count — this sizes sort/resolve working "
                        "sets, default: TPUPROF_UNIQUE_PARTITIONS, "
                        "else 16)")
    p.add_argument("--unique-spill-workers", type=int, default=None,
                   metavar="W",
                   help="unique-spill run writes in flight on the "
                        "shared io pool while the scan keeps folding "
                        "(0 = synchronous writes; byte-identical "
                        "output at any width; default: "
                        "TPUPROF_UNIQUE_SPILL_WORKERS, else 2)")
    p.add_argument("--exact-distinct", action="store_true",
                   help="count distincts exactly for every column at any "
                        "size (needs --unique-spill-dir; 8 bytes per "
                        "distinct value per column of disk)")
    p.add_argument("--parity", action="store_true",
                   help="reference semantics, exactly, in one switch: "
                        "exact distinct counts for every column (no HLL "
                        "estimate anywhere), exact histograms/top-k "
                        "(second pass), and Spearman.  Auto-derives a "
                        "spill dir under TMPDIR when --unique-spill-dir "
                        "is not given (8 bytes per distinct value per "
                        "column; removed after the profile)")
    p.add_argument("--stats-json", metavar="PATH",
                   help="also dump the whole stats dict as "
                        "tpuprof-stats-v1 JSON")
    p.add_argument("--artifact", metavar="PATH",
                   help="also write the profile as a CRC-sealed, "
                        "stats-only tpuprof-stats-v1 artifact (what "
                        "`diff` compares and --seed-edges reads)")
    p.add_argument("--checkpoint", metavar="PATH",
                   help="persist the scan every N batches and resume "
                        "from PATH after a crash")
    p.add_argument("--checkpoint-every", type=int, default=64,
                   metavar="N", help="batches between checkpoints")
    p.add_argument("--trace", metavar="DIR",
                   help="record a torch.profiler trace of the run (host "
                        "activity, plus the device's kernels and copies "
                        "on a CUDA device) into DIR as Chrome-trace JSON "
                        "(open it in Perfetto or chrome://tracing)")
    p.add_argument("--metrics-json", metavar="PATH",
                   help="enable pipeline telemetry (tpuprof_torch/obs) and "
                        "stream JSONL events here: span timings as they "
                        "close, checkpoint saves, and metric snapshots "
                        "(see OBSERVABILITY.md).  Also dumps the final "
                        "Prometheus text exposition next to PATH "
                        "(PATH + '.prom') and the fleet view of this "
                        "process (PATH + '.fleet.prom', gauges labelled "
                        "host=0)")
    p.add_argument("--metrics-interval", type=float, default=0.0,
                   metavar="SEC",
                   help="with --metrics-json: emit a metrics snapshot "
                        "every SEC seconds while the profile runs "
                        "(default: one final snapshot only)")
    p.add_argument("--metrics-max-bytes", type=int, default=None,
                   metavar="N",
                   help="JSONL sink growth cap: rotate PATH -> PATH.1 "
                        "once at N bytes so long runs stay disk-bounded "
                        "(~2xN; default: TPUPROF_METRICS_MAX_BYTES env, "
                        "else unlimited)")
    p.add_argument("--progress", action="store_true",
                   help="print a one-line pipeline status (rows, "
                        "batches, dispatches, recent rows/s) to stderr "
                        "every few seconds (implies metrics; interval = "
                        "--metrics-interval, default 5s)")
    _add_build_cache_flags(p)
    ft = p.add_argument_group(
        "fault tolerance", "retry transient prepare failures, skip poison "
        "batches instead of dying, keep fallback checkpoint generations, "
        "and bound the device drain with a watchdog")
    ft.add_argument("--checkpoint-keep", type=int, default=None,
                    metavar="N",
                    help="checkpoint generations retained (PATH + "
                         "PATH.1 ...); a resume walks back past a "
                         "corrupt head to the newest good one "
                         "(default: TPUPROF_CHECKPOINT_KEEP, else 2)")
    ft.add_argument("--ingest-retries", type=int, default=None,
                    metavar="N",
                    help="transient per-batch prep failures retried "
                         "with exponential backoff before escalating "
                         "(default: TPUPROF_INGEST_RETRIES, else 2)")
    ft.add_argument("--retry-backoff", type=float, default=None,
                    metavar="SEC",
                    help="first retry's sleep; each further attempt "
                         "doubles it (default: TPUPROF_RETRY_BACKOFF_S, "
                         "else 0.05; 0 retries back-to-back)")
    ft.add_argument("--max-quarantined", type=int, default=None,
                    metavar="N",
                    help="poison-batch budget: skip (and report) up to "
                         "N permanently-failing batches instead of "
                         "dying; the report gains a degraded-run "
                         "banner (default: TPUPROF_MAX_QUARANTINED, "
                         "else 0 = fail fast)")
    ft.add_argument("--quarantine-log", metavar="PATH",
                    help="also append quarantined-batch records to "
                         "PATH as JSONL")
    ft.add_argument("--drain-timeout", type=float, default=None,
                    metavar="SEC",
                    help="watchdog deadline on the device drain; "
                         "expiry exits with a heartbeat snapshot "
                         "instead of hanging (default: "
                         "TPUPROF_DRAIN_TIMEOUT_S, else off)")
    ft.add_argument("--barrier-timeout", type=float, default=None,
                    metavar="SEC",
                    help="watchdog deadline on the multi-process resume "
                         "barrier, and the gloo group's timeout "
                         "(default: TPUPROF_BARRIER_TIMEOUT_S, else off)")
    fleet = p.add_argument_group(
        "elastic fleet", "work-stealing membership: launch N independent "
        "processes sharing --fleet-dir; each pulls fragments from the "
        "shared manifest, survivors steal a dead member's fragments and "
        "finish with correct stats, and a restarted member presenting the "
        "same --fleet-host-id adopts its predecessor's claims and "
        "checkpoint.  Mutually exclusive with --coordinator")
    fleet.add_argument("--elastic", action="store_true", default=None,
                       help="enable elastic membership (default: "
                            "TPUPROF_ELASTIC, else off)")
    fleet.add_argument("--fleet-dir", metavar="DIR",
                       help="shared coordination directory (manifest, "
                            "claims, heartbeats, contributions) on "
                            "storage every member sees (default: "
                            "TPUPROF_FLEET_DIR)")
    fleet.add_argument("--fleet-host-id", metavar="ID",
                       help="stable member identity — pin per slot so "
                            "a restart adopts its predecessor's work "
                            "(default: TPUPROF_FLEET_HOST_ID, else "
                            "hostname-pid)")
    fleet.add_argument("--liveness-timeout", type=float, default=None,
                       metavar="SEC",
                       help="heartbeat staleness before a member is "
                            "declared dead and its fragments stolen "
                            "(default: TPUPROF_LIVENESS_TIMEOUT_S, "
                            "else 10)")
    dist = p.add_argument_group(
        "multi-process", "launch the same command in every process; each "
        "scans its own fragment stripe on the CUDA devices it sees "
        "(CUDA_VISIBLE_DEVICES), the states merge over a gloo group, and "
        "process 0 writes the complete report")
    dist.add_argument("--coordinator", metavar="HOST:PORT",
                      help="rendezvous address of the gloo group (process "
                           "0 listens there), or an init URL such as "
                           "file:///shared/rendezvous")
    dist.add_argument("--num-processes", type=int, metavar="N",
                      help="total number of participating processes")
    dist.add_argument("--process-id", type=int, metavar="I",
                      help="this process's rank in [0, N)")

    _add_serve_parser(sub)
    _add_submit_parser(sub)

    d = sub.add_parser(
        "diff", help="compare two stats artifacts and report per-column "
                     "drift (PSI/KS from stored histograms, distinct/"
                     "top-k churn, schema changes)")
    d.add_argument("baseline", help="baseline artifact (A) path")
    d.add_argument("current", help="current artifact (B) path")
    d.add_argument("-o", "--output", default="drift.html",
                   help="drift report HTML path (default: drift.html)")
    d.add_argument("--json", metavar="PATH", dest="drift_json",
                   help="also write the machine-readable "
                        "tpuprof-drift-v1 report here")
    d.add_argument("--psi-threshold", type=float, default=None,
                   metavar="X",
                   help="PSI at or above X flags a column as drifting "
                        "(default 0.25; warn band at half)")
    d.add_argument("--ks-threshold", type=float, default=None,
                   metavar="X",
                   help="KS distance at or above X flags a column as "
                        "drifting (default 0.2; warn band at half)")
    d.add_argument("--fail-on-drift", action="store_true",
                   help="exit 1 when any column reaches drift severity; "
                        "a corrupt artifact exits 6 either way")
    return parser


# the reference's HTTP-edge flags: parsed so that they can be refused with
# one line naming the slice that ports them
_LATER_3B = "serve 3b (the HTTP edge)"


def _add_build_cache_flags(p: argparse.ArgumentParser,
                           aot_default: str = "TPUPROF_AOT_CACHE_DIR, "
                           "else off") -> None:
    """``--compile-cache``/``--no-compile-cache`` and the store of built
    kernel libraries' ``--aot-cache-dir``/``--aot-cache``."""
    p.add_argument("--aot-cache-dir", metavar="DIR", default=None,
                   help="store of built kernel libraries: after a runner's "
                        "libraries are built they are packed here (keyed "
                        "by runner key + environment fingerprint), and a "
                        "later process of the same key adopts them with "
                        f"no nvcc run (default: {aot_default})")
    p.add_argument("--aot-cache", default=None, choices=("on", "off"),
                   help="the store's switch: 'off' never reads or writes "
                        "an entry even with a dir configured (default: "
                        "TPUPROF_AOT_CACHE, else on)")
    cache = p.add_mutually_exclusive_group()
    cache.add_argument(
        "--compile-cache", metavar="DIR", default=None,
        help="directory nvcc builds the kernel libraries into (default: "
             "TPUPROF_TORCH_BUILD_DIR, else build/tpuprof_torch/ beside "
             "the package)")
    cache.add_argument(
        "--no-compile-cache", action="store_true",
        help="build into a directory private to this process, removed "
             "at exit: nothing shared is written")


def _add_serve_parser(sub) -> None:
    s = sub.add_parser(
        "serve", help="resident profile daemon: hold the card, the warm "
                      "runners and the loaded kernel libraries, and "
                      "answer `submit` jobs from a spool directory")
    s.add_argument("spool", help="spool directory (jobs/ + results/); "
                                 "clients on this host — or shared "
                                 "storage — drop requests here")
    s.add_argument("--device", default=None,
                   help="torch device the jobs run on (default: cuda:0, "
                        "which must exist; 'cpu' runs the kernels' plain "
                        "PyTorch versions)")
    s.add_argument("--serve-workers", type=int, default=None, metavar="N",
                   help="concurrent jobs on the card (host prep of job B "
                        "overlaps job A's launches; default: "
                        "TPUPROF_SERVE_WORKERS, else 2)")
    s.add_argument("--serve-queue-depth", type=int, default=None,
                   metavar="N",
                   help="admission bound: jobs queued beyond the running "
                        "set before submits REJECT (default: "
                        "TPUPROF_SERVE_QUEUE_DEPTH, else 32)")
    s.add_argument("--serve-tenant-quota", type=int, default=None,
                   metavar="N",
                   help="per-tenant queued+running cap; 0 = unlimited "
                        "(default: TPUPROF_SERVE_TENANT_QUOTA, else 0)")
    s.add_argument("--job-timeout", type=float, default=None,
                   dest="job_timeout_s", metavar="SEC",
                   help="per-job watchdog: a profile running past SEC "
                        "fails with exit code 4 and frees its worker "
                        "(default: TPUPROF_JOB_TIMEOUT_S, else off)")
    fleet = s.add_argument_group(
        "serve fleet", "N daemons with --claim-jobs sharing ONE spool "
        "claim jobs atomically, heartbeat, and steal a dead peer's "
        "unanswered jobs")
    fleet.add_argument("--claim-jobs", action="store_true",
                       help="claim spool jobs atomically so N daemons "
                            "can share one spool")
    fleet.add_argument("--daemon-id", metavar="ID",
                       help="stable daemon identity for claims and "
                            "heartbeats (default: TPUPROF_FLEET_HOST_ID, "
                            "else hostname-pid)")
    fleet.add_argument("--liveness-timeout", type=float, default=None,
                       metavar="SEC",
                       help="heartbeat staleness before a fleet daemon is "
                            "declared dead and its claimed jobs stolen "
                            "(default: TPUPROF_LIVENESS_TIMEOUT_S, else "
                            "10)")
    overload = s.add_argument_group(
        "overload + drain", "admission shed past a backlog budget (the "
        "read tier keeps answering) and the SIGTERM drain budget")
    overload.add_argument(
        "--serve-backlog", type=int, default=None, metavar="N",
        help="shed budget: uncacheable submits are rejected once N "
             "compute jobs are queued; 0 = off (default: "
             "TPUPROF_SERVE_BACKLOG, else 0)")
    overload.add_argument(
        "--serve-drain-timeout", type=float, default=None,
        dest="serve_drain_timeout_s", metavar="SEC",
        help="graceful-drain budget on SIGTERM: running jobs get SEC to "
             "finish and flush (default: TPUPROF_SERVE_DRAIN_TIMEOUT_S, "
             "else 30)")
    edge = s.add_argument_group(
        "HTTP edge", f"not in the port yet ({_LATER_3B}): each of these "
        "exits 2")
    edge.add_argument("--http", type=int, default=None,
                      dest="serve_http_port", metavar="PORT")
    edge.add_argument("--serve-auth-file", metavar="PATH")
    edge.add_argument("--breaker-threshold", type=int, default=None,
                      metavar="N")
    edge.add_argument("--breaker-cooldown", type=float, default=None,
                      dest="breaker_cooldown_s", metavar="SEC")
    edge.add_argument("--serve-max-connections", type=int, default=None,
                      metavar="N")
    edge.add_argument("--serve-conn-timeout", type=float, default=None,
                      dest="serve_conn_timeout_s", metavar="SEC")
    edge.add_argument("--serve-max-header-bytes", type=int, default=None,
                      metavar="B")
    edge.add_argument("--serve-max-body-bytes", type=int, default=None,
                      metavar="B")
    aot = s.add_argument_group(
        "restart-to-warm (the store of built kernel libraries)",
        "after a runner's kernel libraries are built they are packed into "
        "SPOOL/aot keyed by runner key + environment fingerprint; a "
        "RESTARTED daemon adopts them with no nvcc run and warms its "
        "hottest keys in the background")
    aot.add_argument("--aot-prewarm", type=int, default=None, metavar="K",
                     help="adopt and warm the manifest's K hottest runner "
                          "keys at startup, in the background (0 = lazy "
                          "loads only; default: TPUPROF_AOT_PREWARM, "
                          "else 4)")
    _add_build_cache_flags(aot, aot_default="TPUPROF_AOT_CACHE_DIR, "
                           "else SPOOL/aot")
    read = s.add_argument_group(
        "read-path tier (result cache + coalescing)", "terminal answers "
        "keyed by (source fingerprint, config fingerprint): a repeat "
        "submit of an unchanged source is answered with no launch, and "
        "N concurrent identical submits collapse onto ONE compute")
    read.add_argument("--read-cache", default=None, choices=("on", "off"),
                      help="'off' disables the result cache AND "
                           "coalescing (default: TPUPROF_READ_CACHE, "
                           "else on)")
    read.add_argument("--read-cache-entries", type=int, default=None,
                      metavar="N",
                      help="LRU entry cap on the result cache (default: "
                           "TPUPROF_READ_CACHE_ENTRIES, else 512)")
    read.add_argument("--read-cache-bytes", type=int, default=None,
                      metavar="B",
                      help="LRU byte cap on cached answers (default: "
                           "TPUPROF_READ_CACHE_BYTES, else 64 MiB)")
    s.add_argument("--once", action="store_true",
                   help="answer the spool's current jobs, then exit "
                        "(CI / cron mode; default: serve until SIGTERM)")
    s.add_argument("--poll-interval", type=float, default=0.2,
                   metavar="SEC", help="spool scan cadence")
    s.add_argument("--metrics-json", metavar="PATH",
                   help="stream serve + pipeline JSONL events here and "
                        "dump PATH.prom on exit")
    s.add_argument("--metrics-interval", type=float, default=0.0,
                   metavar="SEC",
                   help="with --metrics-json: periodic snapshot cadence")
    s.add_argument("--progress", action="store_true",
                   help="one-line pipeline status to stderr every few "
                        "seconds")


def _add_submit_parser(sub) -> None:
    u = sub.add_parser(
        "submit", help="hand one profile job to a running `serve` daemon "
                       "through its spool directory and (by default) "
                       "wait for the result")
    u.add_argument("spool", nargs="?", default=None,
                   help="the daemon's spool directory")
    u.add_argument("source", nargs="?", default=None,
                   help="Parquet file/directory path")
    u.add_argument("--url", metavar="http://HOST:PORT",
                   help=f"not in the port yet ({_LATER_3B}): exits 2")
    u.add_argument("-o", "--output", default=None,
                   help="output HTML path (default: none — use "
                        "--stats-json or --artifact for machine "
                        "consumers)")
    u.add_argument("--tenant", default="default",
                   help="quota bucket this job bills against")
    u.add_argument("--bins", type=int, default=None)
    u.add_argument("--batch-rows", type=int, default=None)
    u.add_argument("--columns", metavar="A,B,C",
                   help="profile only these columns")
    u.add_argument("--single-pass", action="store_true",
                   help="one scan only (sketch-derived histograms)")
    u.add_argument("--stats-json", metavar="PATH",
                   help="dump the tpuprof-stats-v1 JSON here")
    u.add_argument("--artifact", metavar="PATH",
                   help="persist a CRC-sealed stats artifact here")
    u.add_argument("--config-json", metavar="JSON|@FILE",
                   help="extra ProfilerConfig kwargs as inline JSON or "
                        "@path-to-file (unknown keys REJECT)")
    u.add_argument("--no-wait", action="store_true",
                   help="enqueue and print the job id without waiting")
    u.add_argument("--timeout", type=float, default=None, metavar="SEC",
                   help="give up waiting after SEC (the job keeps "
                        "running in the daemon)")
    u.add_argument("--deadline-ms", type=int, default=None, metavar="MS",
                   help="answer-within budget the DAEMON enforces: a job "
                        "still queued MS milliseconds after submit is "
                        "never started (DeadlineExceededError, exit code "
                        "11)")


def _error(msg) -> None:
    print(f"{PROG}: error: {msg}", file=sys.stderr)


def _apply_build_dir(args: argparse.Namespace) -> None:
    """``--compile-cache`` / ``--no-compile-cache``: where this process's
    nvcc builds go (an explicit directory, else ``TPUPROF_TORCH_BUILD_DIR``,
    else ``build/tpuprof_torch/``)."""
    from tpuprof_torch import _build
    if args.no_compile_cache:
        _build.use_private_build_dir()
    elif args.compile_cache:
        _build.set_build_dir(args.compile_cache)


def cmd_profile(args: argparse.Namespace) -> int:
    from tpuprof_torch import obs
    from tpuprof_torch.api import ProfileReport
    from tpuprof_torch.config import ProfilerConfig
    from tpuprof_torch.errors import (CorruptCheckpointError,
                                      CorruptManifestError, HostDeathError,
                                      InputError, PoisonBatchError,
                                      WatchdogTimeout, exit_code)
    from tpuprof_torch.obs import blackbox
    from tpuprof_torch.obs.spans import span
    from tpuprof_torch.runtime.runner import resolve_device
    from tpuprof_torch.utils.trace import trace_to

    # the crash flight recorder, on unless TPUPROF_BLACKBOX=0: SIGTERM and
    # SIGUSR1 dump its ring, and every failure below leaves a bundle
    blackbox.install_signal_handlers()

    multi = args.coordinator is not None \
        or args.num_processes is not None or args.process_id is not None
    if multi:
        if args.coordinator is None or args.num_processes is None \
                or args.process_id is None:
            _error("multi-process needs all three of --coordinator, "
                   "--num-processes and --process-id")
            return 2
        if args.parity and not args.unique_spill_dir:
            # the derived dir is local to each process: the merge could
            # not adopt the peers' runs, and the exact counts --parity
            # promises would fall back to estimates
            _error("multi-process --parity needs --unique-spill-dir on "
                   "storage shared by all processes (the derived TMPDIR "
                   "dir is local)")
            return 2
    try:
        device = resolve_device(args.device)
    except (RuntimeError, ValueError) as exc:
        _error(exc)
        return 2
    _apply_build_dir(args)
    if multi:
        from tpuprof_torch.config import resolve_watchdog_timeout
        from tpuprof_torch.runtime.distributed import initialize
        initialize(args.coordinator, args.num_processes, args.process_id,
                   timeout_s=resolve_watchdog_timeout(
                       args.barrier_timeout, "TPUPROF_BARRIER_TIMEOUT_S"))
    columns = None
    if args.columns is not None:
        # "" parses to an empty tuple, which ProfilerConfig rejects: never
        # a silent profile of every column
        columns = tuple(c.strip() for c in args.columns.split(",")
                        if c.strip())
    try:
        config = ProfilerConfig(
            columns=columns, bins=args.bins, corr_reject=args.corr_reject,
            batch_rows=args.batch_rows, scan_batches=args.scan_batches,
            prepare_workers=args.prepare_workers,
            prep_workers=args.prep_workers, nested=args.nested,
            ingest_retries=args.ingest_retries,
            retry_backoff_s=args.retry_backoff,
            max_quarantined=args.max_quarantined,
            quarantine_log=args.quarantine_log,
            drain_timeout_s=args.drain_timeout,
            barrier_timeout_s=args.barrier_timeout,
            elastic=args.elastic, fleet_dir=args.fleet_dir,
            fleet_host_id=args.fleet_host_id,
            liveness_timeout_s=args.liveness_timeout,
            pass_b_kernel=args.pass_b_kernel,
            profile_passes=args.profile_passes,
            seed_edges=args.seed_edges,
            quantile_sketch_size=args.sketch_size,
            hll_precision=args.hll_precision,
            exact_passes=not args.single_pass,
            spearman=args.spearman, artifact_path=args.artifact,
            unique_spill_dir=args.unique_spill_dir,
            exact_distinct=args.exact_distinct, parity=args.parity,
            **({"unique_track_rows": args.unique_track_rows}
               if args.unique_track_rows is not None else {}),
            unique_track_total_rows=args.unique_track_total_rows,
            unique_partitions=args.unique_partitions,
            unique_spill_workers=args.unique_spill_workers,
            checkpoint_path=args.checkpoint,
            checkpoint_every_batches=args.checkpoint_every,
            checkpoint_keep=args.checkpoint_keep,
            metrics_enabled=True if (args.metrics_json or args.progress)
            else None,
            metrics_path=args.metrics_json,
            metrics_interval=args.metrics_interval,
            metrics_max_bytes=args.metrics_max_bytes,
            aot_cache_dir=args.aot_cache_dir, aot_cache=args.aot_cache)
    except ValueError as exc:
        _error(exc)
        return 2

    # telemetry on before the ticker starts (the backend's configure is
    # then a no-op)
    ticker = None
    if config.metrics_enabled:
        obs.configure_from_config(config)
        interval = args.metrics_interval \
            or (5.0 if args.progress else 0.0)
        if interval > 0:
            ticker = obs.Ticker(interval, progress=args.progress,
                                snapshots=bool(args.metrics_json)).start()

    def postmortem(exc: BaseException) -> None:
        dump = blackbox.dump_postmortem(error=exc)
        if dump:
            print(f"{PROG}: postmortem: {dump}", file=sys.stderr)

    t0 = time.perf_counter()
    try:
        with trace_to(args.trace, device):
            with span("profile"):
                try:
                    report = ProfileReport(args.source, config=config,
                                           device=device)
                except (InputError, FileNotFoundError,
                        NotImplementedError) as exc:
                    # what the caller asked for cannot be read or
                    # profiled (a missing path, an unknown column, a field
                    # of a later slice): one line, not a traceback, and no
                    # postmortem (nothing crashed)
                    _error(exc)
                    return 2
                except (PoisonBatchError, WatchdogTimeout,
                        CorruptCheckpointError, CorruptManifestError,
                        HostDeathError) as exc:
                    # the ingest guard ran out, no checkpoint generation is
                    # readable, the fleet directory cannot be trusted or
                    # this member was killed: one line, its own exit code
                    # and a bundle whose last entries name the site
                    _error(exc)
                    postmortem(exc)
                    return exit_code(exc)
                except Exception as exc:
                    # the traceback is the diagnosis; the bundle adds the
                    # batch and dispatch context it cannot show
                    postmortem(exc)
                    raise
            # every process holds the whole merged stats; only rank 0
            # renders and writes
            write_output = not multi or args.process_id == 0
            if write_output:
                with span("render"):
                    report.to_file(args.output)
                if config.artifact_path:
                    from tpuprof_torch.artifact import write_artifact
                    write_artifact(config.artifact_path,
                                   stats=report.description, config=config,
                                   source=str(args.source))
    finally:
        if ticker is not None:
            ticker.stop()
        if multi:
            from tpuprof_torch.runtime.distributed import shutdown
            shutdown()
    elapsed = time.perf_counter() - t0
    if args.metrics_json:
        # the final snapshot holds the render span the collect's could
        # not; the .prom twin is the same registry as Prometheus text
        obs.finalize(reason="cli")
        with open(args.metrics_json + ".prom", "w") as fh:
            fh.write(obs.registry().render_text())

    table = report.description["table"]
    rate = table["n"] / elapsed if elapsed > 0 else float("nan")
    wrote = args.output if write_output else "(report written by host 0)"
    print(f"{PROG}: {table['n']:,} rows x {table['nvar']} cols -> "
          f"{wrote} in {elapsed:.2f}s ({rate:,.0f} rows/s)",
          file=sys.stderr)
    if args.stats_json and write_output:
        with open(args.stats_json, "w") as fh:
            json.dump(report.to_json_dict(), fh, indent=2)
    return 0


def cmd_diff(args: argparse.Namespace) -> int:
    from tpuprof_torch.artifact import (DriftThresholds, compute_drift,
                                        drift_to_html, read_artifact)
    from tpuprof_torch.errors import CorruptArtifactError, exit_code
    try:
        base = read_artifact(args.baseline)
        current = read_artifact(args.current)
    except FileNotFoundError as exc:
        _error(exc)
        return 2
    except CorruptArtifactError as exc:
        # a torn artifact is a typed one-line failure with its own exit
        # code, never a wrong drift report
        _error(exc)
        return exit_code(exc)
    thresholds = DriftThresholds.from_cli(psi=args.psi_threshold,
                                          ks=args.ks_threshold)
    drift = compute_drift(base, current, thresholds)
    with open(args.output, "w", encoding="utf-8") as fh:
        fh.write(drift_to_html(drift))
    if args.drift_json:
        with open(args.drift_json, "w") as fh:
            json.dump(drift, fh, indent=2)
    s = drift["summary"]
    print(f"{PROG}: diff {args.baseline} -> {args.current}: "
          f"{s['verdict'].upper()} — {s['n_drift']} drifting, "
          f"{s['n_warn']} warning, {s['n_ok']} stable of "
          f"{s['columns_compared']} columns -> {args.output}",
          file=sys.stderr)
    if args.fail_on_drift and s["n_drift"]:
        return 1
    return 0


def cmd_serve(args: argparse.Namespace) -> int:
    import os
    import signal
    import threading

    from tpuprof_torch import _build, obs
    from tpuprof_torch.config import (resolve_aot_cache,
                                      resolve_aot_cache_dir,
                                      resolve_read_cache,
                                      resolve_read_cache_bytes,
                                      resolve_read_cache_entries)
    from tpuprof_torch.obs import blackbox
    from tpuprof_torch.runtime import aot
    from tpuprof_torch.runtime.runner import resolve_device
    from tpuprof_torch.serve import ServeDaemon

    edge = [flag for flag, value in (
        ("--http", args.serve_http_port),
        ("--serve-auth-file", args.serve_auth_file),
        ("--breaker-threshold", args.breaker_threshold),
        ("--breaker-cooldown", args.breaker_cooldown_s),
        ("--serve-max-connections", args.serve_max_connections),
        ("--serve-conn-timeout", args.serve_conn_timeout_s),
        ("--serve-max-header-bytes", args.serve_max_header_bytes),
        ("--serve-max-body-bytes", args.serve_max_body_bytes))
        if value is not None]
    if edge:
        _error(f"{', '.join(edge)}: not in the PyTorch port yet (later "
               f"slice: {_LATER_3B}); the spool daemon serves without it")
        return 2
    try:
        device = resolve_device(args.device)
    except (RuntimeError, ValueError) as exc:
        _error(exc)
        return 2
    # SIGUSR1 postmortems carry the live job queue (the scheduler's
    # dump-time context provider)
    blackbox.install_signal_handlers()
    _apply_build_dir(args)
    ticker = None
    if args.metrics_json or args.progress:
        obs.configure(enabled=True, jsonl_path=args.metrics_json)
        interval = args.metrics_interval or (5.0 if args.progress else 0.0)
        if interval > 0:
            ticker = obs.Ticker(interval, progress=args.progress,
                                snapshots=bool(args.metrics_json)).start()
    try:
        # the daemon's store defaults to SPOOL/aot: a restarted daemon
        # adopts its built libraries instead of re-running nvcc
        aot_dir = None
        if resolve_aot_cache(args.aot_cache) == "on":
            aot_dir = resolve_aot_cache_dir(args.aot_cache_dir) \
                or os.path.join(args.spool, "aot")
        daemon = ServeDaemon(
            args.spool, poll_interval=args.poll_interval,
            claim_jobs=args.claim_jobs, daemon_id=args.daemon_id,
            liveness_timeout_s=args.liveness_timeout,
            drain_timeout_s=args.serve_drain_timeout_s,
            aot_cache_dir=aot_dir, aot_cache=args.aot_cache,
            aot_prewarm=args.aot_prewarm, device=device,
            workers=args.serve_workers,
            queue_depth=args.serve_queue_depth,
            tenant_quota=args.serve_tenant_quota,
            job_timeout_s=args.job_timeout_s,
            read_cache=resolve_read_cache(args.read_cache),
            read_cache_entries=resolve_read_cache_entries(
                args.read_cache_entries),
            read_cache_bytes=resolve_read_cache_bytes(
                args.read_cache_bytes),
            serve_backlog=args.serve_backlog)
    except ValueError as exc:
        if ticker is not None:
            ticker.stop()
        _error(exc)
        return 2
    sched = daemon.scheduler
    if aot_dir:
        print(f"{PROG}: kernel library store at {aot_dir} (prewarming "
              f"{daemon.prewarmer.top_k if daemon.prewarmer else 0} "
              "hottest keys)", file=sys.stderr, flush=True)
    if daemon.prewarmer is not None:
        def _prewarmed(pw=daemon.prewarmer):
            pw.wait()
            st = pw.status()
            print(f"{PROG}: prewarm done: loaded {st['loaded']} missed "
                  f"{st['missed']} failed {st['failed']} in "
                  f"{st['seconds']}s", file=sys.stderr, flush=True)
        threading.Thread(target=_prewarmed, daemon=True,
                         name="tpuprof-torch-prewarm-report").start()

    # a daemon drains on SIGTERM (running jobs finish, results and the
    # .prom dump flush, exit 0), overriding the flight recorder's
    # dump-and-die, which is right for a crashed profile but turns a
    # routine stop into a signal death; SIGUSR1 keeps dump-and-continue
    def _graceful(signum, frame):
        blackbox.record("signal", name="SIGTERM", action="drain")
        daemon.stop_event.set()

    try:
        signal.signal(signal.SIGTERM, _graceful)
    except (ValueError, OSError):
        pass                    # not the main thread: rely on stop_event
    print(f"{PROG}: serving {args.spool} on {sched.device} — "
          f"{sched.workers} workers, queue depth {sched._queue.depth}, "
          f"tenant quota {sched._queue.tenant_quota or 'unlimited'}"
          + (" (once)" if args.once else ""), file=sys.stderr, flush=True)
    try:
        daemon.run(once=args.once)
    except KeyboardInterrupt:
        pass
    finally:
        daemon.close()
        # the store's background saves finish before the closing line
        aot.wait_pending_saves()
        if ticker is not None:
            ticker.stop()
        if args.metrics_json:
            obs.finalize(reason="serve")
            with open(args.metrics_json + ".prom", "w") as fh:
                fh.write(obs.registry().render_text())
    st = sched.stats()
    pw = daemon.prewarmer.status() if daemon.prewarmer else None
    print(f"{PROG}: served {st['requests']} jobs "
          f"({st['done']} done, {st['failed']} failed, "
          f"{st['rejected']} rejected) · p50 {st['p50_s']}s "
          f"p99 {st['p99_s']}s · runner cache "
          f"{st['cache']['hits']}/"
          f"{st['cache']['hits'] + st['cache']['misses']} hits · "
          f"nvcc builds {_build.builds.get('nvcc', 0)} "
          f"({_build.build_seconds.get('nvcc', 0.0):.3f}s) · store "
          f"loaded {aot.counts['loaded']} saved {aot.counts['saved']} "
          f"corrupt {aot.counts['corrupt']}"
          + (f" · prewarm loaded {pw['loaded']} missed {pw['missed']} "
             f"failed {pw['failed']} in {pw['seconds']}s" if pw else ""),
          file=sys.stderr, flush=True)
    return 0


def _parse_config_json(raw) -> dict:
    """``--config-json JSON|@FILE``: a dict of extra ProfilerConfig kwargs.
    Raises ValueError in the CLI's bad-request convention."""
    if not raw:
        return {}
    try:
        if raw.startswith("@"):
            with open(raw[1:]) as fh:
                extra = json.load(fh)
        else:
            extra = json.loads(raw)
    except OSError as exc:
        raise ValueError(str(exc)) from exc
    if not isinstance(extra, dict):
        raise ValueError("must be a JSON object")
    return extra


def cmd_submit(args: argparse.Namespace) -> int:
    # the spool half of the reference's submit: it writes a job file and
    # polls for the result, and creates no CUDA context (torch is never
    # imported here)
    from tpuprof_torch.errors import CorruptResultError, exit_code
    from tpuprof_torch.serve.server import wait_result, write_job

    if args.url:
        _error(f"--url: not in the PyTorch port yet (later slice: "
               f"{_LATER_3B}); submit through the daemon's spool "
               "directory")
        return 2
    if args.spool is None or args.source is None:
        _error("submit needs the daemon's spool directory and a source "
               "path")
        return 2
    config = {}
    if args.bins is not None:
        config["bins"] = args.bins
    if args.batch_rows is not None:
        config["batch_rows"] = args.batch_rows
    if args.columns is not None:
        config["columns"] = tuple(c.strip() for c in args.columns.split(",")
                                  if c.strip())
    if args.single_pass:
        config["exact_passes"] = False
    try:
        config.update(_parse_config_json(args.config_json))
    except ValueError as exc:
        _error(f"--config-json: {exc}")
        return 2
    # a relative --deadline-ms budget resolves to an absolute wall clock
    # HERE, at submit time: the wait in the spool is what it bounds
    deadline_unix_ms = (int((time.time() + args.deadline_ms / 1000.0)
                            * 1000)
                        if args.deadline_ms is not None else None)
    job_id = write_job(args.spool, args.source, output=args.output,
                       tenant=args.tenant, stats_json=args.stats_json,
                       artifact=args.artifact, config_kwargs=config,
                       deadline_unix_ms=deadline_unix_ms)
    if args.no_wait:
        print(job_id)
        return 0
    try:
        result = wait_result(args.spool, job_id, timeout=args.timeout)
    except CorruptResultError as exc:
        _error(exc)
        return exit_code(exc)
    except TimeoutError as exc:
        _error(exc)
        return 4                # the watchdog-shaped failure
    status = result.get("status")
    if status == "done":
        rows = result.get("rows")
        rows_s = f"{rows:,}" if isinstance(rows, int) else "?"
        print(f"{PROG}: job {job_id}: {rows_s} rows "
              f"x {result.get('cols', '?')} cols -> "
              f"{result.get('output') or args.stats_json or '(no output)'}"
              f" in {result.get('seconds', 0)}s "
              f"(queued {result.get('queue_seconds', 0)}s)",
              file=sys.stderr)
        return 0
    _error(f"job {job_id} {status}: {result.get('error', 'unknown')}")
    if status == "rejected":
        return 2                # the CLI's bad-request convention
    return int(result.get("exit_code") or 1)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.command == "profile":
        return cmd_profile(args)
    if args.command == "serve":
        return cmd_serve(args)
    if args.command == "submit":
        return cmd_submit(args)
    return cmd_diff(args)


if __name__ == "__main__":
    sys.exit(main())
