"""Command line of the port: ``python -m tpuprof_torch profile data.parquet
-o report.html`` and ``python -m tpuprof_torch diff A.json B.json``.

Counterpart of the ``profile`` and ``diff`` verbs of ``tpuprof/cli.py``,
with the same flag names and defaults for what the port runs.  ``--device``
stands where the reference has ``--backend``: the profile runs on the first
CUDA device unless ``--device cpu`` asks for the kernels' plain versions,
and without a CUDA device it fails instead of running on the CPU.  Input
errors print one ``tpuprof_torch: error: ...`` line and exit 2; a torn
artifact, an unreadable checkpoint, a spent quarantine budget and a
watchdog timeout print one line too and exit with their error's code
(``errors.exit_code``: 6, 3, 5, 4).  ``--checkpoint PATH`` saves the
scan every ``--checkpoint-every`` batches and resumes from PATH when it
exists.
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


def _error(msg) -> None:
    print(f"{PROG}: error: {msg}", file=sys.stderr)


def cmd_profile(args: argparse.Namespace) -> int:
    from tpuprof_torch.api import ProfileReport
    from tpuprof_torch.config import ProfilerConfig
    from tpuprof_torch.errors import (CorruptCheckpointError, InputError,
                                      PoisonBatchError, WatchdogTimeout,
                                      exit_code)
    from tpuprof_torch.obs.spans import span
    from tpuprof_torch.runtime.runner import resolve_device

    try:
        device = resolve_device(args.device)
    except (RuntimeError, ValueError) as exc:
        _error(exc)
        return 2
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
            pass_b_kernel=args.pass_b_kernel,
            profile_passes=args.profile_passes,
            seed_edges=args.seed_edges,
            quantile_sketch_size=args.sketch_size,
            hll_precision=args.hll_precision,
            exact_passes=not args.single_pass,
            spearman=args.spearman, artifact_path=args.artifact,
            checkpoint_path=args.checkpoint,
            checkpoint_every_batches=args.checkpoint_every,
            checkpoint_keep=args.checkpoint_keep)
    except ValueError as exc:
        _error(exc)
        return 2

    t0 = time.perf_counter()
    try:
        report = ProfileReport(args.source, config=config, device=device)
    except (InputError, FileNotFoundError, NotImplementedError) as exc:
        # what the caller asked for cannot be read or profiled (a missing
        # path, an unknown column, a field of a later slice): one line, not
        # a traceback; every other failure keeps its traceback
        _error(exc)
        return 2
    except (PoisonBatchError, WatchdogTimeout,
            CorruptCheckpointError) as exc:
        # the ingest guard ran out, or no checkpoint generation is
        # readable: one line and its own exit code
        _error(exc)
        return exit_code(exc)
    with span("render"):
        report.to_file(args.output)
    if config.artifact_path:
        from tpuprof_torch.artifact import write_artifact
        write_artifact(config.artifact_path, stats=report.description,
                       config=config, source=str(args.source))
    elapsed = time.perf_counter() - t0

    table = report.description["table"]
    rate = table["n"] / elapsed if elapsed > 0 else float("nan")
    print(f"{PROG}: {table['n']:,} rows x {table['nvar']} cols -> "
          f"{args.output} in {elapsed:.2f}s ({rate:,.0f} rows/s)",
          file=sys.stderr)
    if args.stats_json:
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


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.command == "profile":
        return cmd_profile(args)
    return cmd_diff(args)


if __name__ == "__main__":
    sys.exit(main())
