"""The readings that a cell's limits are set from, on the card.

    python3 -m portbench.control --workload <name> --seeds 12 \
        --control-seeds 3 [--first-seed N]

For each seed, set-up as a run of the cell makes it, then one request a
client through the cell's own timed path, at the cell's own size; then
every number of ``portbench/compare.py`` for the program's answers (the
lower readings) and, on the first ``--control-seeds`` seeds, for the
control: the reference computed on the same tables with every numeric
value rounded to bfloat16, put in the program's place (the upper
readings).  Prints one JSON line a seed and a last line with the largest
program reading and the smallest control reading of each number.  The
benchmark's own runs do not run it.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile


def readings(config, traffic, seeds, control_seeds: int, device):
    """The per-seed rows and the summary {number: {"lower", "upper"}}."""
    from portbench import compare
    from portbench.loop import Cell
    from portbench.reference.stats import reference
    out = []
    for i, seed in enumerate(seeds):
        workdir = tempfile.mkdtemp(prefix="portbench-control-")
        cell = Cell(config, traffic, seed, device, workdir)
        try:
            cell.setup()
            cell.window(1e9, requests=1)
        finally:
            cell.close()
        answers = list(cell.answers())
        shutil.rmtree(workdir, ignore_errors=True)
        tables = cell.tables()
        prog, ctl = [], []
        for k in sorted({k for k, _ in answers}):
            ref = reference(tables[k], int(config["bins"]),
                            float(config["corr_reject"]), device)
            prog += [compare.numbers(got, ref)[0] for kk, got in answers
                     if kk == k]
            if i < control_seeds:
                low = reference(tables[k], int(config["bins"]),
                                float(config["corr_reject"]), device,
                                round_to="bfloat16")
                ctl.append(compare.numbers(low, ref)[0])
        del tables
        row = {"seed": seed, "program": compare.worst(prog),
               "work_missing": len(cell.work_missing),
               "failed": len(cell.failed)}
        if ctl:
            row["control"] = compare.worst(ctl)
        print(json.dumps(row), flush=True)
        out.append(row)
    summary = {}
    for k in compare.NUMBERS:
        lower = [r["program"][k] for r in out if r["program"][k] is not None]
        upper = [r["control"][k] for r in out if "control" in r
                 and r["control"][k] is not None]
        summary[k] = {"lower": max(lower) if lower else None,
                      "upper": min(upper) if upper else None}
    return out, summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=1000003)
    args = ap.parse_args(argv)
    from portbench import run
    os.environ["TPUPROF_TORCH_BUILD_DIR"] = os.path.join(
        run.ROOT, "portbench", ".build")
    import torch
    if not torch.cuda.is_available():
        print("portbench.control: no CUDA device", file=sys.stderr)
        return 2
    with open(os.path.join(run.ROOT, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    spec = next(w for w in bench["workloads"] if w["name"] == args.workload)
    seeds = [args.first_seed + 7919 * i for i in range(args.seeds)]
    _, summary = readings(run.load("configs", spec["config"]),
                          run.load("traffic", spec["traffic"]), seeds,
                          args.control_seeds, torch.device("cuda:0"))
    print(json.dumps({"workload": args.workload, "readings": summary}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
