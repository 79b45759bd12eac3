"""What the benchmark runs loads no module whose top-level name is
``jax``, ``jaxlib``, ``flax`` or ``tpuprof`` (compared whole: the port's
``tpuprof_torch`` begins with ``tpuprof``); the reference loads nothing of
the port either.  Each check runs in a child process of its own."""

import json
import subprocess
import sys

import pytest

from portbench.tests.conftest import ROOT

RUN_A_CELL = """
import sys, json
sys.path.insert(0, {root!r})
from portbench.tests.conftest import tiny
import importlib, time, types, torch
from portbench import run
bench, spec, config, traffic = tiny({cell!r})
readers = {{n: importlib.import_module(f"portbench.metrics.{{n}}")
           for n in run.cell_metrics(bench, {cell!r}, False)}}
args = types.SimpleNamespace(workload={cell!r}, seed=3, seconds=0.2, trace=0)
run.run_cell(args, bench, spec, config, traffic, readers,
             torch.device("cpu"), time.time())
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

REFERENCE_ALONE = """
import sys, json
sys.path.insert(0, {root!r})
import numpy as np, pandas as pd
from portbench.reference.stats import reference
df = pd.DataFrame({{"a": np.arange(100, dtype=np.float32),
                   "b": np.arange(100) % 7}})
reference(df, 10, 0.9)
reference(df, 10, 0.9, round_to="bfloat16")
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def loaded(code: str):
    env = {"PATH": "/usr/bin:/bin", "HOME": ROOT, "USE_FLAX": "0"}
    import os
    env.update({k: v for k, v in os.environ.items()
                if k in ("TMPDIR", "PYTHONPATH", "LD_LIBRARY_PATH")})
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


@pytest.mark.parametrize("cell", ["synth200.describe", "synth200.serve"])
def test_a_run_loads_no_jax_nor_the_jax_package(cell):
    names = loaded(RUN_A_CELL.format(root=ROOT, cell=cell))
    assert "tpuprof_torch" in names
    assert not names & {"jax", "jaxlib", "flax", "tpuprof"}


def test_the_reference_loads_nothing_of_either_package():
    names = loaded(REFERENCE_ALONE.format(root=ROOT))
    assert not names & {"jax", "jaxlib", "flax", "tpuprof", "tpuprof_torch"}


def test_forbidden_modules_compares_whole_names(monkeypatch):
    from portbench import run
    monkeypatch.setitem(sys.modules, "tpuprof_torchlike", sys)
    assert "tpuprof" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "tpuprof.api", sys)
    assert run.forbidden_modules() == ["tpuprof"]


def test_without_the_program_no_result(tmp_path):
    """In a directory that holds only BENCHMARK.json and portbench/, a run
    exits with another code than 0 and prints no result."""
    import shutil
    shutil.copy(f"{ROOT}/BENCHMARK.json", tmp_path)
    shutil.copytree(f"{ROOT}/portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns(".build", "__pycache__"))
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "synth200.describe", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
        timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
