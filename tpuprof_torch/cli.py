"""Command line of the port: ``python -m tpuprof_torch profile data.parquet
-o report.html``, ``python -m tpuprof_torch diff A.json B.json``, the
resident daemon ``python -m tpuprof_torch serve SPOOL`` with its client
``python -m tpuprof_torch submit SPOOL data.parquet``, the drift watch
``watch SPOOL SOURCE...``, the warehouse's ``history`` and ``backtest``, and
``lint``, the invariant suite (``tpuprof_torch/analysis``) over the port's
own tree.

Counterpart of every verb of ``tpuprof/cli.py``, with the same flag names,
defaults and exit codes.  ``--device`` stands beside the reference's ``--backend``: the
profile runs on the first CUDA device unless ``--device cpu`` asks for the
kernels' plain versions, and without a CUDA device it fails instead of
running on the CPU.  ``--backend cpu`` runs the exact pandas oracle, and
only then; ``auto`` and ``tpu`` are the engine.  Input
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
process, removed at exit).  ``serve --http PORT`` adds the HTTP edge
(``serve/http.py``; ``--serve-auth-file``, the connection caps and the
warehouse breaker), and ``submit --url`` talks to it; an edge that cannot be
reached exits 9.  ``profile --artifact A --warehouse-dir D`` also appends a
columnar generation to the warehouse; a box without pyarrow exits 10.
"""

from __future__ import annotations

import argparse
import json
import os
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
    p.add_argument("--backend", default="auto",
                   choices=["auto", "cpu", "tpu"],
                   help="'cpu' runs the exact pandas oracle (no device); "
                        "'auto' and 'tpu' run the engine on --device")
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
    p.add_argument("--warehouse-dir", metavar="DIR",
                   help="with --artifact: ALSO append a columnar "
                        "tpuprof-stats-parquet-v1 generation under "
                        "DIR/<source-key>/ (the profile warehouse — one "
                        "row per column, stats as typed Parquet columns, "
                        "column-pruned reads).  Default: "
                        "TPUPROF_WAREHOUSE_DIR, else off")
    p.add_argument("--warehouse-format", default=None,
                   choices=("parquet", "off"),
                   help="columnar warehouse encoding, or 'off' to never "
                        "write one even with a warehouse dir configured "
                        "(the pyarrow-free opt-out; default: "
                        "TPUPROF_WAREHOUSE_FORMAT, else parquet)")
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
    _add_watch_parser(sub)
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
    _add_history_parsers(sub)
    _add_lint_parser(sub)
    return parser


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
        "HTTP edge", "a network front door on the same scheduler (POST "
        "/v1/jobs, POST /v1/query, GET /v1/results/<id>, /v1/healthz, "
        "/metrics — serve/http.py); it implies --claim-jobs")
    edge.add_argument("--http", type=int, default=None,
                      dest="serve_http_port", metavar="PORT",
                      help="listen for HTTP jobs on PORT (0 = ephemeral, "
                           "advertised under SPOOL/daemons/; default: "
                           "TPUPROF_SERVE_HTTP_PORT, else no HTTP edge)")
    edge.add_argument("--serve-auth-file", metavar="PATH",
                      help="bearer-token file ('<token> <tenant>' lines): "
                           "/v1/* requests must present a listed token "
                           "(401 otherwise) and bill the token's tenant "
                           "(default: TPUPROF_SERVE_AUTH_FILE, else open)")
    edge.add_argument("--breaker-threshold", type=int, default=None,
                      metavar="N",
                      help="consecutive corrupt/failed warehouse reads a "
                           "source before /v1/query skips the warehouse "
                           "tier for it (default: "
                           "TPUPROF_BREAKER_THRESHOLD, else 3)")
    edge.add_argument("--breaker-cooldown", type=float, default=None,
                      dest="breaker_cooldown_s", metavar="SEC",
                      help="open-breaker cooldown before one half-open "
                           "probe (default: TPUPROF_BREAKER_COOLDOWN_S, "
                           "else 30)")
    edge.add_argument("--serve-max-connections", type=int, default=None,
                      metavar="N",
                      help="open-socket ceiling; newcomers past it get a "
                           "terse 503 (default: "
                           "TPUPROF_SERVE_MAX_CONNECTIONS, else 512)")
    edge.add_argument("--serve-conn-timeout", type=float, default=None,
                      dest="serve_conn_timeout_s", metavar="SEC",
                      help="per-connection I/O deadline: a client must "
                           "finish sending its request (and drain its "
                           "response) within SEC (slow-loris defense; "
                           "default: TPUPROF_SERVE_CONN_TIMEOUT_S, else 30)")
    edge.add_argument("--serve-max-header-bytes", type=int, default=None,
                      metavar="B",
                      help="request line + header byte cap (default: "
                           "TPUPROF_SERVE_MAX_HEADER_BYTES, else 64 KiB)")
    edge.add_argument("--serve-max-body-bytes", type=int, default=None,
                      metavar="B",
                      help="request body byte cap (default: "
                           "TPUPROF_SERVE_MAX_BODY_BYTES, else 1 MiB)")
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
        "submit", help="hand one profile job to a running `serve` daemon — "
                       "through its spool directory or its HTTP edge "
                       "(--url) — and (by default) wait for the result")
    u.add_argument("spool", nargs="?", default=None,
                   help="the daemon's spool directory (omit with --url)")
    u.add_argument("source", nargs="?", default=None,
                   help="Parquet file/directory path")
    u.add_argument("--url", metavar="http://HOST:PORT",
                   help="submit over the daemon's HTTP edge (`serve "
                        "--http`) instead of a spool directory; an "
                        "unreachable edge exits 9")
    u.add_argument("--token", default=None,
                   help="bearer token for an auth-enabled edge (default: "
                        "TPUPROF_SERVE_TOKEN env); the token's tenant is "
                        "billed, overriding --tenant")
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


def _add_watch_parser(sub) -> None:
    w = sub.add_parser(
        "watch", help="continuous drift watch: a serve daemon that "
                      "re-profiles each SOURCE every --every seconds on the "
                      "warm card, keeps --keep cycle artifacts, diffs "
                      "consecutive cycles and raises drift alerts; the "
                      "spool still answers `submit` jobs")
    w.add_argument("spool", help="spool directory — watch state lives "
                                 "under SPOOL/watch/<source-key>/")
    w.add_argument("sources", nargs="+", metavar="SOURCE",
                   help="Parquet file/directory path(s) to watch")
    w.add_argument("--device", default=None,
                   help="torch device the cycles run on (default: cuda:0, "
                        "which must exist; 'cpu' runs the kernels' plain "
                        "PyTorch versions)")
    w.add_argument("--every", type=float, default=None,
                   dest="watch_every_s", metavar="SEC",
                   help="seconds between re-profile cycles per source "
                        "(default: TPUPROF_WATCH_EVERY_S, else 300; 0 = "
                        "back-to-back, the CI mode)")
    w.add_argument("--keep", type=int, default=None, dest="artifact_keep",
                   metavar="N",
                   help="cycle artifacts retained per source; the drift "
                        "baseline walks past a corrupt head to the newest "
                        "good generation (default: TPUPROF_ARTIFACT_KEEP, "
                        "else 3)")
    w.add_argument("--cycles", type=int, default=None, metavar="N",
                   help="stop after N cycles over every source (CI/cron "
                        "mode; default: watch forever)")
    w.add_argument("--psi-threshold", type=float, default=None,
                   metavar="X",
                   help="PSI at or above X alerts at drift severity "
                        "(default 0.25; warn band at half)")
    w.add_argument("--ks-threshold", type=float, default=None, metavar="X",
                   help="KS distance at or above X alerts at drift "
                        "severity (default 0.2; warn band at half)")
    w.add_argument("--profile-passes", default=None,
                   choices=("two_pass", "fused"),
                   help="pass structure of the watch's profile jobs "
                        "(default: TPUPROF_PROFILE_PASSES env, else "
                        "two_pass).  fused: each cycle seeds its bin edges "
                        "from the previous cycle's artifact, and an "
                        "undrifted source profiles in ONE scan (K4)")
    w.add_argument("--job-timeout", type=float, default=None,
                   dest="job_timeout_s", metavar="SEC",
                   help="per-job watchdog: a hung cycle profile fails "
                        "(exit-code-4 semantics) and the watch continues "
                        "(default: TPUPROF_JOB_TIMEOUT_S, else off)")
    w.add_argument("--serve-workers", type=int, default=None, metavar="N",
                   help="concurrent jobs on the card (default: "
                        "TPUPROF_SERVE_WORKERS, else 2)")
    w.add_argument("--poll-interval", type=float, default=0.2,
                   metavar="SEC", help="spool scan cadence")
    w.add_argument("--http", type=int, default=None,
                   dest="serve_http_port", metavar="PORT",
                   help="also serve the HTTP edge (submit + GET "
                        "/v1/watch/<key>/alerts; 0 = ephemeral; default: "
                        "TPUPROF_SERVE_HTTP_PORT, else off)")
    w.add_argument("--serve-auth-file", metavar="PATH",
                   help="bearer-token file for the HTTP edge (default: "
                        "TPUPROF_SERVE_AUTH_FILE, else open)")
    w.add_argument("--warehouse-dir", metavar="DIR",
                   help="columnar warehouse root the watch appends one "
                        "tpuprof-stats-parquet-v1 generation a cycle into "
                        "(default: TPUPROF_WAREHOUSE_DIR, else "
                        "SPOOL/warehouse — what `history` and GET "
                        "/v1/history/<key> answer from)")
    w.add_argument("--warehouse-format", default=None,
                   choices=("parquet", "off"),
                   help="'off' disables the columnar twin (cycles are "
                        "unaffected; default: TPUPROF_WAREHOUSE_FORMAT, "
                        "else parquet)")
    w.add_argument("--aot-prewarm", type=int, default=None, metavar="K",
                   help="runner keys prewarmed at startup (default: "
                        "TPUPROF_AOT_PREWARM, else 4; 0 = lazy only)")
    w.add_argument("--config-json", metavar="JSON|@FILE",
                   help="ProfilerConfig kwargs applied to every watch "
                        "cycle's profile job, as inline JSON or "
                        "@path-to-file (unknown keys fail the cycle)")
    w.add_argument("--metrics-json", metavar="PATH",
                   help="stream watch_cycle/drift_alert + serve JSONL "
                        "events here and dump PATH.prom on exit")
    w.add_argument("--metrics-interval", type=float, default=0.0,
                   metavar="SEC",
                   help="with --metrics-json: periodic snapshot cadence")
    _add_build_cache_flags(w, aot_default="TPUPROF_AOT_CACHE_DIR, else "
                           "SPOOL/aot")


def _add_history_parsers(sub) -> None:
    hi = sub.add_parser(
        "history", help="query the columnar profile warehouse: one column's "
                        "stat across every profiled generation (`--stat "
                        "mean --col price`), or the PSI/KS drift trend "
                        "between consecutive generations (`--trend`)")
    hi.add_argument("source",
                    help="the watched/profiled source path (resolved to its "
                         "warehouse key), a warehouse key, or a per-source "
                         "warehouse directory")
    hi.add_argument("--warehouse-dir", metavar="DIR", default=None,
                    help="warehouse root (default: TPUPROF_WAREHOUSE_DIR; "
                         "see also --spool)")
    hi.add_argument("--spool", metavar="DIR", default=None,
                    help="a watch daemon's spool — shorthand for "
                         "--warehouse-dir SPOOL/warehouse")
    hi.add_argument("--col", metavar="NAME", default=None,
                    help="the profiled column to query (required unless "
                         "--trend, where it is an optional filter)")
    hi.add_argument("--stat", metavar="STAT", default="mean",
                    help="which stat column to read (default: mean; any "
                         "tpuprof-stats-v1 numeric stat)")
    hi.add_argument("--trend", action="store_true",
                    help="PSI/KS between every consecutive pair of "
                         "generations instead of a stat series")
    hi.add_argument("--json", action="store_true", dest="as_json",
                    help="print the tpuprof-history-v1 document to stdout "
                         "instead of the table")

    b = sub.add_parser(
        "backtest", help="replay changed alert thresholds against a watched "
                         "source's retained artifact chain with the live "
                         "watch loop's own drift and dedup rules")
    b.add_argument("source",
                   help="the watched source path (resolved to its chain "
                        "under SPOOL/watch/<key>/), or a directory of "
                        "cycle_*.artifact.json files")
    b.add_argument("--spool", metavar="DIR", default=None,
                   help="the watch daemon's spool directory holding the "
                        "retained chain")
    b.add_argument("--psi-threshold", type=float, default=None,
                   metavar="X",
                   help="PSI at or above X alerts at drift severity "
                        "(default 0.25; warn band at half)")
    b.add_argument("--ks-threshold", type=float, default=None, metavar="X",
                   help="KS distance at or above X alerts at drift "
                        "severity (default 0.2; warn band at half)")
    b.add_argument("--json", action="store_true", dest="as_json",
                   help="print the tpuprof-backtest-v1 document to stdout")


def _add_lint_parser(sub) -> None:
    l = sub.add_parser(
        "lint", help="run the AST-enforced invariant suite over the "
                     "source tree (tpuprof_torch/analysis; ANALYSIS.md): "
                     "durability seams, config surface, obs contracts, "
                     "error taxonomy, runtime discipline")
    l.add_argument("root", nargs="?", default=None,
                   help="repo root holding tpuprof_torch/ + the docs "
                        "(default: the checkout this tpuprof_torch "
                        "package was imported from)")
    l.add_argument("--json", metavar="PATH", dest="lint_json",
                   help="also write the machine-readable "
                        "tpuprof-lint-v1 report here")
    l.add_argument("--strict", action="store_true",
                   help="ignore the suppression file: report every "
                        "finding, absorb none")
    l.add_argument("--suppressions", metavar="PATH", default=None,
                   help="suppression file (default: "
                        "tpuprof_torch/LINT_SUPPRESSIONS under the root; "
                        "'<checker> <ident-glob> <reason>' lines)")
    l.add_argument("--only", metavar="ID[,ID...]", default=None,
                   help="run only these checker ids (comma-separated)")
    l.add_argument("--list", action="store_true", dest="lint_list",
                   help="list checker ids + one-line docs and exit")


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
        if args.backend == "cpu":
            _error("--backend cpu has no fragment striping — every "
                   "process would profile the whole dataset; multi-process "
                   "needs the engine")
            return 2
        if args.parity and not args.unique_spill_dir:
            # the derived dir is local to each process: the merge could
            # not adopt the peers' runs, and the exact counts --parity
            # promises would fall back to estimates
            _error("multi-process --parity needs --unique-spill-dir on "
                   "storage shared by all processes (the derived TMPDIR "
                   "dir is local)")
            return 2
    device = None
    if args.backend == "cpu":
        if args.device is not None:
            # the oracle runs no device: a named one would be ignored
            _error("--device names the engine's device; --backend cpu runs "
                   "the pandas oracle, which takes none")
            return 2
    else:
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
            backend=args.backend,
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
            warehouse_dir=args.warehouse_dir,
            warehouse_format=args.warehouse_format,
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
                    # profiled (a missing path, an unknown column, a
                    # Pallas switch): one line, not a traceback, and no
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
                    rc = _warehouse_append(config, args.source)
                    if rc:
                        return rc
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


def _warehouse_append(config, source) -> int:
    """``--artifact`` with a warehouse dir: append the columnar generation
    derived from the artifact just sealed, so its Parquet rows and the JSON
    document carry the same bits.  The user asked for the warehouse, so its
    typed failures (exit 10 without pyarrow) are the command's; 0 else."""
    from tpuprof_torch.config import (resolve_warehouse_dir,
                                      resolve_warehouse_format)
    whd = resolve_warehouse_dir(config.warehouse_dir)
    if not whd or resolve_warehouse_format(
            config.warehouse_format) != "parquet":
        return 0
    from tpuprof_torch.artifact import read_artifact
    from tpuprof_torch.errors import TYPED_ERRORS, exit_code
    from tpuprof_torch.warehouse import append_artifact
    try:
        append_artifact(whd, read_artifact(config.artifact_path),
                        source=str(source))
    except TYPED_ERRORS as exc:
        _error(exc)
        return exit_code(exc)
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
                                      resolve_read_cache_entries,
                                      resolve_serve_http_port)
    from tpuprof_torch.obs import blackbox
    from tpuprof_torch.runtime import aot
    from tpuprof_torch.runtime.runner import resolve_device
    from tpuprof_torch.serve import ServeDaemon

    http_port = resolve_serve_http_port(args.serve_http_port)
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
        # the HTTP edge implies fleet claims: N --http daemons on one spool
        # is the deployment the edge exists for, and claims keep them from
        # running each other's jobs twice
        daemon = ServeDaemon(
            args.spool, poll_interval=args.poll_interval,
            claim_jobs=bool(args.claim_jobs or http_port is not None),
            daemon_id=args.daemon_id,
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
    edge = None
    if http_port is not None:
        edge = _start_edge(daemon, http_port, args)
        if edge is None:
            if ticker is not None:
                ticker.stop()
            return 2
        print(f"{PROG}: http edge on {edge.url}"
              + (" (auth required)" if edge.tokens else " (open)"),
              file=sys.stderr, flush=True)

    # a daemon drains on SIGTERM (running jobs finish, results and the
    # .prom dump flush, exit 0), overriding the flight recorder's
    # dump-and-die, which is right for a crashed profile but turns a
    # routine stop into a signal death; SIGUSR1 keeps dump-and-continue
    def _graceful(signum, frame):
        blackbox.record("signal", name="SIGTERM", action="drain")
        daemon.stop_event.set()     # /v1/healthz turns "draining"
        if edge is not None:
            # stop accepting sockets now; established connections keep
            # draining and in-flight answers are delivered
            edge.stop_accepting()

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
        if edge is not None:
            edge.close()            # stop accepting before draining
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


def _start_edge(daemon, http_port: int, args: argparse.Namespace):
    """Start ``daemon``'s HTTP edge with the serve verb's flags (the watch
    verb has only the port and the auth file).  A bad auth file or a port
    in use prints one line, closes the daemon and returns None."""
    from tpuprof_torch.config import (resolve_breaker_cooldown,
                                      resolve_breaker_threshold,
                                      resolve_serve_auth_file)
    from tpuprof_torch.errors import InputError
    from tpuprof_torch.serve.breaker import CircuitBreaker
    from tpuprof_torch.serve.http import HttpEdge
    flags = vars(args)
    try:
        return HttpEdge(
            daemon, port=http_port,
            auth_file=resolve_serve_auth_file(args.serve_auth_file),
            max_connections=flags.get("serve_max_connections"),
            conn_timeout_s=flags.get("serve_conn_timeout_s"),
            max_header_bytes=flags.get("serve_max_header_bytes"),
            max_body_bytes=flags.get("serve_max_body_bytes"),
            breaker=CircuitBreaker(
                threshold=resolve_breaker_threshold(
                    flags.get("breaker_threshold")),
                cooldown_s=resolve_breaker_cooldown(
                    flags.get("breaker_cooldown_s")))).start()
    except (InputError, OSError) as exc:
        _error(f"http edge: {exc}")
        daemon.close(timeout=5)
        return None


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
    # the client half: it writes a job file (or POSTs it to an edge) and
    # polls for the result, and creates no CUDA context (torch is never
    # imported here)
    import os

    from tpuprof_torch.errors import (CorruptResultError,
                                      ServeUnavailableError, exit_code)
    from tpuprof_torch.serve.server import wait_result, write_job

    # `submit SPOOL SOURCE` or `submit --url URL SOURCE`: with --url the one
    # positional is the source (argparse fills left to right, so it lands
    # in `spool`)
    if args.url:
        if args.source is None:
            args.spool, args.source = None, args.spool
        if args.spool is not None:
            _error("pass either a spool directory or --url, not both")
            return 2
    if args.source is None:
        _error("submit needs a source path (and a spool directory or "
               "--url)")
        return 2
    if args.spool is None and not args.url:
        _error("submit needs the daemon's spool directory (or --url for "
               "its HTTP edge)")
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
    if args.url:
        from tpuprof_torch.serve.http import submit_job, wait_result_http
        token = args.token or os.environ.get("TPUPROF_SERVE_TOKEN")
        try:
            code, doc = submit_job(
                args.url, args.source, output=args.output,
                tenant=args.tenant, stats_json=args.stats_json,
                artifact=args.artifact, config_kwargs=config, token=token,
                deadline_ms=args.deadline_ms)
        except ServeUnavailableError as exc:
            # the edge itself is down: its own exit code (9), so a retry
            # wrapper tells "unreachable" from "rejected"
            _error(exc)
            return exit_code(exc)
        if code == 401:
            _error(f"{doc.get('error', 'unauthorized')} (pass --token or "
                   "set TPUPROF_SERVE_TOKEN)")
            return 2
        if code == 503 and doc.get("reject_kind") == "BacklogFull":
            # an overload shed: the serve plane's exit code (9), so a
            # retry wrapper backs off
            _error(f"job shed (HTTP 503): {doc.get('error', doc)}")
            return exit_code(ServeUnavailableError(""))
        if code not in (200, 202):
            # the daemon answered and said no: 429 carries the scheduler's
            # reject reason, 400 the request's own fault
            _error(f"job rejected (HTTP {code}): {doc.get('error', doc)}")
            return 2
        job_id = doc["id"]
        if args.no_wait:
            print(job_id)
            return 0
        try:
            result = wait_result_http(args.url, job_id,
                                      timeout=args.timeout, token=token)
        except (ServeUnavailableError, CorruptResultError) as exc:
            _error(exc)
            return exit_code(exc)
        except TimeoutError as exc:
            _error(exc)
            return 4                # the watchdog-shaped failure
    else:
        # a relative --deadline-ms budget resolves to an absolute wall
        # clock HERE, at submit time: the wait in the spool is what it
        # bounds
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


def cmd_watch(args: argparse.Namespace) -> int:
    import os
    import signal
    import threading

    from tpuprof_torch import obs
    from tpuprof_torch.artifact import DriftThresholds
    from tpuprof_torch.config import (resolve_aot_cache,
                                      resolve_aot_cache_dir,
                                      resolve_serve_http_port)
    from tpuprof_torch.obs import blackbox
    from tpuprof_torch.runtime import aot
    from tpuprof_torch.runtime.runner import resolve_device
    from tpuprof_torch.serve import DriftWatcher, ServeDaemon

    try:
        config_kwargs = _parse_config_json(args.config_json)
    except ValueError as exc:
        _error(f"--config-json: {exc}")
        return 2
    if args.profile_passes:
        config_kwargs.setdefault("profile_passes", args.profile_passes)
    try:
        device = resolve_device(args.device)
    except (RuntimeError, ValueError) as exc:
        _error(exc)
        return 2
    blackbox.install_signal_handlers()
    _apply_build_dir(args)
    ticker = None
    if args.metrics_json:
        obs.configure(enabled=True, jsonl_path=args.metrics_json)
        if args.metrics_interval > 0:
            ticker = obs.Ticker(args.metrics_interval,
                                snapshots=True).start()
    http_port = resolve_serve_http_port(args.serve_http_port)
    # the watch's cycles share the serve verb's store default, so a
    # restarted watch adopts its built libraries instead of running nvcc
    aot_dir = None
    if resolve_aot_cache(args.aot_cache) == "on":
        aot_dir = resolve_aot_cache_dir(args.aot_cache_dir) \
            or os.path.join(args.spool, "aot")
    try:
        daemon = ServeDaemon(args.spool, poll_interval=args.poll_interval,
                             claim_jobs=http_port is not None,
                             workers=args.serve_workers,
                             job_timeout_s=args.job_timeout_s,
                             aot_cache_dir=aot_dir, aot_cache=args.aot_cache,
                             aot_prewarm=args.aot_prewarm, device=device)
    except ValueError as exc:
        if ticker is not None:
            ticker.stop()
        _error(exc)
        return 2
    edge = None
    if http_port is not None:
        edge = _start_edge(daemon, http_port, args)
        if edge is None:
            if ticker is not None:
                ticker.stop()
            return 2
        print(f"{PROG}: http edge on {edge.url} (alert feeds at "
              "/v1/watch/<key>/alerts)", file=sys.stderr, flush=True)
    try:
        watcher = DriftWatcher(
            args.spool, args.sources, daemon.scheduler,
            every_s=args.watch_every_s, keep=args.artifact_keep,
            thresholds=DriftThresholds.from_cli(psi=args.psi_threshold,
                                                ks=args.ks_threshold),
            job_timeout_s=args.job_timeout_s, config_kwargs=config_kwargs,
            warehouse_dir=args.warehouse_dir,
            warehouse_format=args.warehouse_format)
    except ValueError as exc:
        if edge is not None:
            edge.close()
        daemon.close(timeout=5)
        if ticker is not None:
            ticker.stop()
        _error(exc)
        return 2
    blackbox.set_context(watch_sources=[w.source for w in watcher.watches])

    def _graceful(signum, frame):
        blackbox.record("signal", name="SIGTERM", action="drain")
        watcher.stop_event.set()
        daemon.stop_event.set()

    try:
        signal.signal(signal.SIGTERM, _graceful)
    except (ValueError, OSError):
        pass                    # not the main thread: rely on stop_event
    print(f"{PROG}: watching {len(watcher.watches)} source(s) on "
          f"{daemon.scheduler.device} every {watcher.every_s:g}s (keep "
          f"{watcher.keep}"
          + (f", job timeout {watcher.job_timeout_s:g}s"
             if watcher.job_timeout_s else "")
          + f") — spool {args.spool}"
          + (f" ({args.cycles} cycles)" if args.cycles else ""),
          file=sys.stderr, flush=True)
    # the spool keeps answering `submit` while the watch runs: the
    # daemon's poll loop rides a background thread, the watch loop owns
    # the foreground
    spool_thread = threading.Thread(target=daemon.run, daemon=True,
                                    name="tpuprof-torch-watch-spool")
    spool_thread.start()
    try:
        watcher.run(cycles=args.cycles)
    except KeyboardInterrupt:
        pass
    finally:
        watcher.stop_event.set()
        daemon.stop_event.set()
        if edge is not None:
            edge.close()
        spool_thread.join(timeout=30)
        daemon.close()
        aot.wait_pending_saves()
        if ticker is not None:
            ticker.stop()
        if args.metrics_json:
            obs.finalize(reason="watch")
            with open(args.metrics_json + ".prom", "w") as fh:
                fh.write(obs.registry().render_text())
    st = watcher.stats()
    c = st["cycles"]
    print(f"{PROG}: watched {st['sources']} source(s): {c['ok']} ok, "
          f"{c['warn']} warn, {c['drift']} drift, {c['failed']} failed "
          f"cycles · {st['alerts']} alerts on file", file=sys.stderr)
    return 0


def _resolve_history_dir(args: argparse.Namespace) -> str:
    """The per-source warehouse directory a history query reads:
    ``--warehouse-dir``/env (or ``--spool``'s SPOOL/warehouse) plus the
    source key — or the source itself when it already IS a per-source
    warehouse directory."""
    import os

    from tpuprof_torch.config import resolve_warehouse_dir
    from tpuprof_torch.errors import InputError
    from tpuprof_torch.warehouse import source_dir
    from tpuprof_torch.warehouse.store import _has_generations
    root = resolve_warehouse_dir(args.warehouse_dir) \
        or (os.path.join(args.spool, "warehouse") if args.spool else None)
    if root is None:
        if os.path.isdir(args.source) and _has_generations(args.source):
            return args.source
        raise InputError(
            "history needs the warehouse root: pass --warehouse-dir (or "
            "TPUPROF_WAREHOUSE_DIR), --spool SPOOL for a watch daemon's "
            "SPOOL/warehouse, or point SOURCE at a per-source warehouse "
            "directory directly")
    return source_dir(root, args.source)


def cmd_history(args: argparse.Namespace) -> int:
    from tpuprof_torch.errors import TYPED_ERRORS, exit_code
    from tpuprof_torch.warehouse import query_stat, query_trend
    try:
        dirpath = _resolve_history_dir(args)
        if args.trend:
            doc = query_trend(dirpath, col=args.col)
        else:
            if not args.col:
                _error("history needs --col NAME (or --trend for the drift "
                       "series)")
                return 2
            doc = query_stat(dirpath, args.col, args.stat)
    except TYPED_ERRORS as exc:
        _error(exc)
        return exit_code(exc)
    if args.as_json:
        json.dump(doc, sys.stdout, indent=1)
        print()
        return 0
    skipped = (f" (skipped corrupt: {doc['skipped_corrupt']})"
               if doc["skipped_corrupt"] else "")
    if args.trend:
        print(f"# trend over {doc['generations']} generation pair(s) in "
              f"{doc['warehouse']}{skipped}")
        print("generation  baseline  column  psi  ks")
        for entry in doc["series"]:
            for name, m in sorted(entry["columns"].items()):
                print(f"{entry['generation']:>10}  "
                      f"{entry['baseline_generation']:>8}  {name}  "
                      f"{m['psi']}  {m['ks']}")
    else:
        print(f"# {args.stat}({args.col}) over {doc['generations']} "
              f"generation(s) in {doc['warehouse']}{skipped}")
        print("generation  rows  value")
        for entry in doc["series"]:
            rows = entry["rows"] if entry["rows"] is not None else "?"
            print(f"{entry['generation']:>10}  {rows:>4}  {entry['value']}")
    return 0


def cmd_backtest(args: argparse.Namespace) -> int:
    from tpuprof_torch.artifact import DriftThresholds
    from tpuprof_torch.errors import TYPED_ERRORS, exit_code
    from tpuprof_torch.warehouse import backtest, chain_dir
    thresholds = DriftThresholds.from_cli(psi=args.psi_threshold,
                                          ks=args.ks_threshold)
    try:
        doc = backtest(chain_dir(args.spool, args.source), thresholds)
    except TYPED_ERRORS as exc:
        _error(exc)
        return exit_code(exc)
    if args.as_json:
        json.dump(doc, sys.stdout, indent=1)
        print()
        return 0
    s = doc["summary"]
    print(f"{PROG}: backtest {doc['chain']}: {s['alerts']} alert(s) over "
          f"{s['cycles']} retained cycle(s) ({s['drift_cycles']} drift, "
          f"{s['warn_cycles']} warn"
          + (f", {s['unreadable']} unreadable" if s["unreadable"] else "")
          + ")", file=sys.stderr)
    for a in doc["alerts"]:
        cols = ",".join(a["columns"][:6]) + \
            ("…" if len(a["columns"]) > 6 else "")
        print(f"cycle {a['cycle']:>6}  {a['severity']:<6} "
              f"{a['n_drift']} drifting / {a['n_warn']} warning  [{cols}]")
    return 0


def _default_lint_root() -> str:
    """The checkout this package was imported from: the directory holding
    the ``tpuprof_torch/`` package dir (where the docs the checkers parse
    live in a source tree)."""
    import tpuprof_torch
    return os.path.dirname(os.path.dirname(os.path.abspath(
        tpuprof_torch.__file__)))


def cmd_lint(args: argparse.Namespace) -> int:
    from tpuprof_torch import analysis
    from tpuprof_torch.errors import LintFindingsError, exit_code
    if args.lint_list:
        for cid in analysis.checker_ids():
            print(f"{cid}: {analysis.checker_doc(cid)}")
        return 0
    root = args.root or _default_lint_root()
    only = [c.strip() for c in args.only.split(",")] if args.only \
        else None
    try:
        report = analysis.run_lint(root, only=only,
                                   suppressions=args.suppressions,
                                   strict=args.strict)
    except ValueError as exc:           # unknown checker id
        _error(exc)
        return 2
    analysis.observe(report)
    if args.lint_json:
        with open(args.lint_json, "w") as fh:
            fh.write(report.to_json())
    unsuppressed = report.unsuppressed()
    for f in unsuppressed:
        print(f.format())
    n_sup = len(report.suppressed)
    if unsuppressed:
        exc = LintFindingsError(
            f"{len(unsuppressed)} finding(s) across "
            f"{len(report.counts_by_checker())} checker(s)"
            + (f" ({n_sup} suppressed)" if n_sup else ""))
        print(f"{PROG} lint: {exc}", file=sys.stderr)
        return exit_code(exc)
    print(f"{PROG} lint: clean — {len(report.checkers_run)} checkers"
          + (f", {n_sup} suppressed finding(s)" if n_sup else "")
          + f" in {report.wall_s:.2f}s", file=sys.stderr)
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.command == "profile":
        return cmd_profile(args)
    if args.command == "serve":
        return cmd_serve(args)
    if args.command == "watch":
        return cmd_watch(args)
    if args.command == "submit":
        return cmd_submit(args)
    if args.command == "history":
        return cmd_history(args)
    if args.command == "backtest":
        return cmd_backtest(args)
    if args.command == "lint":
        return cmd_lint(args)
    return cmd_diff(args)


if __name__ == "__main__":
    sys.exit(main())
