"""Helpers of the port's multi-process and fleet tests.

``mixed_dataset`` writes a Parquet directory of several fragments (floats
with NaNs, an exponential column, a string category, small integers and
timestamps), small enough that the row sample holds every row, so the
quantiles are exact in every run.  ``launch`` starts worker processes of
the port (``python -c SCRIPT``, the repo on ``sys.path``, never ``jax``),
each with a time limit; the tests give process groups a ``file://`` init
URL under their own directory, so parallel test workers never race for a
TCP port.
``export_close`` compares two ``tpuprof-stats-v1`` exports at ROADMAP's
tolerances: integers, strings and flags exact, floats at ``rtol=5e-4,
atol=1e-5`` (moments; rho within that too), ``memorysize`` at ``rel=0.02``
(striped reads hold one dictionary a stripe, the reference's own
allowance) and the ``display`` strings by their keys only (their last
digit follows the float merge order).
"""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.parquet as pq

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 5e-4, 1e-5
TIMEOUT_S = 120


def mixed_dataset(path, n_frags=4, rows=900, seed=11) -> str:
    os.makedirs(path, exist_ok=True)
    rng = np.random.default_rng(seed)
    for f in range(n_frags):
        a = rng.normal(5, 2, rows)
        a[rng.random(rows) < 0.05] = np.nan
        df = pd.DataFrame({
            "a": a,
            "b": rng.exponential(1.5, rows),
            "c": rng.choice(["x", "y", "z", "w"], rows,
                            p=[0.4, 0.3, 0.2, 0.1]),
            "i": rng.integers(0, 50, rows),
            "d": pd.Timestamp("2024-01-01") + pd.to_timedelta(
                rng.integers(0, 10 ** 6, rows), unit="s"),
        })
        df.loc[rng.random(rows) < 0.03, "c"] = None
        pq.write_table(pa.Table.from_pandas(df, preserve_index=False),
                       os.path.join(path, f"p{f}.parquet"))
    return str(path)


def worker_env(**extra):
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "TPUPROF_FAULTS", "TPUPROF_METRICS",
                        "TPUPROF_METRICS_PATH")}
    env.update(extra)
    return env


def launch(script: str, args, env=None):
    """Start ``python -c script ARGS`` (the repo first on its path)."""
    code = f"import sys; sys.path.insert(0, {REPO!r})\n" \
        + textwrap.dedent(script)
    return subprocess.Popen([sys.executable, "-c", code, *map(str, args)],
                            env=env or worker_env(), cwd=REPO,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)


def finish(procs):
    """Wait for every process (``TIMEOUT_S`` each); returns their
    (exit code, output) pairs."""
    out = []
    for p in procs:
        try:
            log, _ = p.communicate(timeout=TIMEOUT_S)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        out.append((p.returncode, log.decode(errors="replace")))
    return out


def plain(doc):
    """A JSON round trip (numpy scalars become plain numbers)."""
    return json.loads(json.dumps(doc))


def export_close(got, want, path=""):
    """Assert two exports equal at the tolerances above."""
    if path == ".display":
        assert set(got["table"]) == set(want["table"]), path
        assert {n: set(v) for n, v in got["variables"].items()} == \
            {n: set(v) for n, v in want["variables"].items()}, path
        return
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), \
            (path, sorted(set(got) ^ set(want)))
        for k in want:
            export_close(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            export_close(g, w, f"{path}[{i}]")
    elif isinstance(want, float) and not isinstance(want, bool):
        rtol = 0.02 if path.endswith("memorysize") else RTOL
        assert isinstance(got, (int, float)) and np.isclose(
            got, want, rtol=rtol, atol=ATOL, equal_nan=True), \
            (path, got, want)
    else:
        assert got == want, (path, got, want)
