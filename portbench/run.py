"""Run one cell of the benchmark once and print its result's line.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, ``portbench/``
and the ``tpuprof_torch`` package.  The cell is found by name in
``BENCHMARK.json``; its configuration (``portbench/configs/<config>.json``),
its traffic (``portbench/traffic/<traffic>.json``) and each metric's
reader (``portbench/metrics/<metric>.py``) are found by theirs.  A run:

1. makes the cell's tables from ``--seed``, warms up (set-up);
2. runs the traffic for ``--seconds`` (the window), with ``--trace 1``
   under ``torch.profiler``;
3. frees the program's state and compares every answer of the window
   with the plain reference (``portbench/reference/``);
4. prints each number compared beside its limit as the last lines of
   standard error, and one JSON object as the last line of standard
   output: ``correct``, ``attempted``, ``failed``, ``metrics``,
   ``device``, with ``--trace 1`` ``breakdown``, and ``checks`` last.

It exits 2 and prints no result without CUDA or with fewer devices than
the cell asks for, and 3 when the program or the benchmark's files are
missing or when ``jax``, ``jaxlib``, ``flax`` or ``tpuprof`` was loaded.
Kernel builds go to ``portbench/.build`` in the checkout, so only a
checkout's first run of a cell builds; every other file goes under
``TMPDIR`` and is removed at the end.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import shutil
import sys
import tempfile
import threading
import time

from portbench import hoststat

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "tpuprof")


def process_start() -> float:
    """The epoch seconds at which this process started (/proc), else
    now."""
    try:
        with open("/proc/self/stat") as fh:
            ticks = int(fh.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as fh:
            btime = next(int(line.split()[1]) for line in fh
                         if line.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time()


class RssPeak(threading.Thread):
    """The highest VmRSS of this process while it runs, every 20 ms."""

    def __init__(self):
        super().__init__(name="portbench-rss", daemon=True)
        self.peak = 0
        self._stop_event = threading.Event()

    def run(self) -> None:
        while not self._stop_event.is_set():
            self.peak = max(self.peak, hoststat.rss())
            self._stop_event.wait(0.02)

    def stop(self) -> int:
        self._stop_event.set()
        self.join()
        self.peak = max(self.peak, hoststat.rss())
        return self.peak


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def load(kind: str, name: str):
    with open(os.path.join(ROOT, "portbench", kind, f"{name}.json")) as fh:
        return json.load(fh)


def cell_metrics(bench, workload: str, trace: bool):
    """The names of the cell's end-to-end metrics, or with ``trace`` its
    per-layer ones."""
    group = bench["per_layer" if trace else "end_to_end"]
    return [m["name"] for m in group
            if workload in m.get("workloads", [workload])]


def traced_window(cell, seconds):
    """The window under ``torch.profiler``, every program span a range of
    the trace; returns (the last completion, the trace's summary)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from portbench import tracing
    from tpuprof_torch.obs import spans
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    spans.annotate = record_function
    try:
        with prof:
            with record_function(tracing.WINDOW):
                t_last = cell.window(seconds)
                torch.cuda.synchronize()
    finally:
        spans.annotate = None
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as fh:
            doc = json.load(fh)
    finally:
        os.remove(path)
    return t_last, tracing.summarize(doc)


def check(cell, config, device):
    """(numbers, limits, what went wrong) of every answer of the window
    against the reference, and of the work the traffic expects."""
    import torch

    from portbench import compare
    from portbench.reference.stats import reference
    refs, tables = {}, None
    per_answer, wrong = [], []
    for k, got in cell.answers():
        if k not in refs:
            if tables is None:
                tables = cell.tables()
            refs[k] = reference(tables[k], int(config["bins"]),
                                float(config["corr_reject"]), device)
            if device.type == "cuda":
                torch.cuda.empty_cache()
        nums, bad = compare.numbers(got, refs[k])
        per_answer.append(nums)
        wrong.extend(bad)
    worst = compare.worst(per_answer)
    # the configuration's limits name the numbers its cells compare
    nums = {k: worst[k] for k in config["limits"]}
    nums["work_missing"] = float(len(cell.work_missing))
    wrong.extend(cell.work_missing[:8])
    limits = dict(config["limits"], work_missing=0)
    return nums, limits, wrong


def main(argv=None) -> int:
    t_start = process_start()
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    os.environ["TPUPROF_TORCH_BUILD_DIR"] = os.path.join(
        ROOT, "portbench", ".build")
    try:
        with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
            bench = json.load(fh)
        cellspec = next(w for w in bench["workloads"]
                        if w["name"] == args.workload)
        config = load("configs", cellspec["config"])
        traffic = load("traffic", cellspec["traffic"])
        readers = {name: importlib.import_module(f"portbench.metrics.{name}")
                   for name in cell_metrics(bench, args.workload,
                                            bool(args.trace))}
        import torch
        import tpuprof_torch  # noqa: F401  (the system under test)
    except (OSError, StopIteration, ImportError, ValueError) as exc:
        print(f"portbench: cannot run {args.workload}: "
              f"{type(exc).__name__}: {exc}", file=sys.stderr)
        return 3
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < int(cellspec["chips"]):
        print(f"portbench: {args.workload} needs {cellspec['chips']} CUDA "
              "device(s)", file=sys.stderr)
        return 2
    return run_cell(args, bench, cellspec, config, traffic, readers,
                    torch.device("cuda:0"), t_start)


def run_cell(args, bench, cellspec, config, traffic, readers, device,
             t_start) -> int:
    import torch

    from portbench.loop import Cell
    from tpuprof_torch import _build
    workdir = tempfile.mkdtemp(prefix="portbench-")
    cuda = device.type == "cuda"
    cell = Cell(config, traffic, args.seed, device, workdir)
    try:
        cell.setup()
        if cuda:
            torch.cuda.synchronize()
        builds_setup = dict(_build.builds)
        rss = RssPeak()
        rss.start()
        setup_s = time.time() - t_start
        trace = None
        if args.trace:
            t_last, trace = traced_window(cell, args.seconds)
        else:
            t_last = cell.window(args.seconds)
            if cuda:
                torch.cuda.synchronize()
        rss_peak = rss.stop()
        cell.close()
        builds_window = {k: v - builds_setup.get(k, 0)
                         for k, v in _build.builds.items()
                         if v != builds_setup.get(k, 0)}
        ctx = {"cell": cell, "config": config, "traffic": traffic,
               "t0": cell.t0, "t_last": t_last, "setup_s": setup_s,
               "rss_peak_bytes": rss_peak, "trace": trace}
        metrics = {}
        for m in bench["per_layer" if args.trace else "end_to_end"]:
            if m["name"] in readers:
                value = readers[m["name"]].read(ctx)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device_info = {"platform": "gpu" if cuda else "cpu",
                       "kind": torch.cuda.get_device_name(0) if cuda
                       else "cpu",
                       "count": int(cellspec["chips"]),
                       "memory_peak_bytes": int(
                           torch.cuda.max_memory_allocated(0)) if cuda
                       else 0}
        if trace is not None:
            device_info["busy_s"] = trace["busy_s"]
            device_info["window_s"] = trace["window_s"]
        attempted = len(cell.profiles) + len(cell.failed)
        if cuda:
            torch.cuda.empty_cache()
        nums, limits, wrong = check(cell, config, device)
    finally:
        cell.close()
        shutil.rmtree(workdir, ignore_errors=True)
    found = forbidden_modules()
    if found:
        print(f"portbench: loaded {', '.join(found)}", file=sys.stderr)
        return 3
    checks = {}
    ok = not cell.failed and bool(cell.profiles)
    for k, v in nums.items():
        # a number the configuration limits and the answers do not give
        # fails the run
        checks[k] = {"value": v, "limit": limits[k]}
        ok = ok and v is not None and v <= limits[k]
    result = {"correct": ok, "attempted": attempted,
              "failed": len(cell.failed), "metrics": metrics,
              "device": device_info}
    if trace is not None:
        result["breakdown"] = {
            "device_ops": [[k, s] for k, s in trace["device_ops"][:10]],
            "idle_gaps": [[k, s] for k, s in trace["idle_gaps"][:10]]}
    result["checks"] = checks
    for msg in (cell.failed[:4] + wrong[:8]):
        print(f"portbench: {msg}", file=sys.stderr)
    if builds_window:
        print(f"portbench: built in the window: {builds_window}",
              file=sys.stderr)
    span = t_last - cell.t0
    print(f"portbench: builds in set-up {builds_setup}; setup_s "
          f"{setup_s:.3f}; VmRSS (GiB) "
          + " ".join(f"{k} {v / 2 ** 30:.2f}" for k, v in cell.rss_marks)
          + f" window peak {rss_peak / 2 ** 30:.2f}; window {span:.3f} s, "
          f"{threading.active_count()} threads: "
          + hoststat.line(cell.host), file=sys.stderr)
    for n, p in enumerate(cell.profiles):
        if "host" in p:
            print(f"portbench: profile {n}: " + hoststat.line(p["host"]),
                  file=sys.stderr)
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
