"""Shared helpers of the benchmark's own tests: tiny cells run on the CPU
through the harness's real path (``portbench.run.run_cell``)."""

import importlib
import json
import os
import sys
import time
import types

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def tiny(workload: str):
    """(bench, cell spec, config, traffic) of ``workload`` cut to a size a
    test run holds: 8,192 rows in batches of 2,048, files of 4,096.  The
    plain versions count no launches, so the launch check is off.  A
    ``<config>.<traffic>`` that ``BENCHMARK.json`` does not list is built
    from its files alone."""
    from portbench import run
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    config_name, traffic_name = workload.split(".", 1)
    spec = next((w for w in bench["workloads"] if w["name"] == workload),
                {"name": workload, "config": config_name,
                 "traffic": traffic_name, "chips": 1})
    config = run.load("configs", spec["config"])
    traffic = run.load("traffic", spec["traffic"])
    config.update(rows=8192, batch_rows=2048)
    traffic.update(warm_rows=2048, rows_per_file=4096,
                   launches_per_batch={})
    return bench, spec, config, traffic


def run_tiny(workload: str, seed: int, capsys, seconds: float = 0.5):
    """One run of a tiny cell on the CPU; its result's line as a dict."""
    import torch

    from portbench import run
    bench, spec, config, traffic = tiny(workload)
    readers = {n: importlib.import_module(f"portbench.metrics.{n}")
               for n in run.cell_metrics(bench, workload, False)}
    args = types.SimpleNamespace(workload=workload, seed=seed,
                                 seconds=seconds, trace=0)
    rc = run.run_cell(args, bench, spec, config, traffic, readers,
                      torch.device("cpu"), time.time())
    assert rc == 0
    out = capsys.readouterr().out.strip().splitlines()
    return json.loads(out[-1])


@pytest.fixture
def cuda_device():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")
