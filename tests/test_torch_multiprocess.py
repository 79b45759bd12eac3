"""Profiles of the port across processes, over gloo on the CPU.

Two ranks (``tpuprof_torch.runtime.distributed.initialize`` with a
``file://`` rendezvous under the test's directory) profile a Parquet
directory of four fragments, each rank its stripe of two, with
``device="cpu"``.  Both ranks' ``stats_to_json`` must be the same, and equal
the port's single-process export and the reference's (``tpuprof.describe``,
JAX on the CPU) at ROADMAP's tolerances (``tests/torch_ranks.py``).  The
same through the ``profile`` verb's flags (``--coordinator HOST:PORT`` on a
port bound at 0, rank 0 alone writing); a checkpointed pair killed by a
``fold`` fault after a save, resumed (``PATH.h0of2``, ``PATH.h1of2``) and
resumed again with rank 1's chain torn (one rank restored, one fresh);
``parity`` with a shared spill dir (exact counts equal ``nunique``, only
rank 0 reads the runs); and the fleet's ``.fleet.prom`` (gauges labelled
``host="0"`` and ``host="1"``, written by rank 0 alone).  No rank loads
``jax`` or a ``tpuprof`` module.
"""

import glob
import json
import os
import socket

import jax  # noqa: F401  (JAX stays on the CPU: tests/conftest.py)
import numpy as np
import pandas as pd
import pytest

import tpuprof
import tpuprof_torch
from tpuprof.report.export import stats_to_json as ref_stats_to_json
from tpuprof_torch.report.export import stats_to_json
from torch_ranks import (export_close, finish, launch, mixed_dataset, plain,
                         worker_env)
from torch_route import same_hash_route  # noqa: F401  (autouse)

BATCH = 256

DESCRIBE = """
import json, sys
rank, world, rdv, ds, out = sys.argv[1:6]
kw = json.loads(sys.argv[6])
from tpuprof_torch.runtime import distributed
distributed.initialize(rdv, int(world), int(rank), timeout_s=90)
import tpuprof_torch
from tpuprof_torch.kernels import unique
from tpuprof_torch.report.export import stats_to_json
reads = []
real_layout, real_resolve = (unique.UniqueTracker._run_layout,
                             distributed.resolve_unique_distributed)
def layout(self, *a):
    if reads:
        reads[0] += 1
    return real_layout(self, *a)
def resolve(tracker):
    reads.append(0)
    return real_resolve(tracker)
unique.UniqueTracker._run_layout = layout
distributed.resolve_unique_distributed = resolve
stats = tpuprof_torch.describe(ds, device="cpu", **kw)
json.dump({"stats": stats_to_json(stats), "run_reads": reads,
           "mods": sorted({m.split(".")[0] for m in sys.modules}
                          & {"jax", "jaxlib", "tpuprof"})},
          open(out, "w"))
distributed.shutdown()
"""


def _two_ranks(tmp_path, ds, tag, **kw):
    outs = [str(tmp_path / f"{tag}{i}.json") for i in range(2)]
    rdv = f"file://{tmp_path}/{tag}.rendezvous"
    procs = [launch(DESCRIBE, [i, 2, rdv, ds, outs[i], json.dumps(kw)])
             for i in range(2)]
    for rc, log in finish(procs):
        assert rc == 0, log[-3000:]
    return [json.load(open(o)) for o in outs]


@pytest.fixture(scope="module")
def ds(tmp_path_factory):
    return mixed_dataset(tmp_path_factory.mktemp("mp") / "ds")


@pytest.fixture(scope="module")
def singles(ds):
    """The port's and the reference's single-process exports."""
    port = plain(stats_to_json(tpuprof_torch.describe(
        ds, device="cpu", batch_rows=BATCH, spearman=True)))
    ref = plain(ref_stats_to_json(tpuprof.describe(
        ds, backend="tpu", batch_rows=BATCH)))
    return port, ref


@pytest.fixture(scope="module")
def ranks(ds, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ranks")
    return tmp, _two_ranks(tmp, ds, "r", batch_rows=BATCH, spearman=True,
                           metrics_enabled=True,
                           metrics_path=str(tmp / "m.jsonl"))


def test_both_ranks_hold_the_same_whole_profile(ranks):
    _tmp, (r0, r1) = ranks
    assert r0["stats"] == r1["stats"]
    assert r0["stats"]["table"]["n"] == 3600


def test_two_ranks_equal_the_single_process_port(ranks, singles):
    _tmp, (r0, _r1) = ranks
    export_close(plain(r0["stats"]), singles[0])


def test_two_ranks_equal_the_single_process_reference(ranks, singles):
    """Spearman aside: the port's CPU path ranks on the grid, the
    reference's CPU run on its exact tier (a standing difference, ROADMAP
    Queue 3); the port's two ranks hold it at 5e-4 to one process above."""
    _tmp, (r0, _r1) = ranks
    got = plain(r0["stats"])
    got["correlations"].pop("spearman")
    export_close(got, singles[1])


def test_no_rank_loads_jax_or_the_reference(ranks):
    _tmp, (r0, r1) = ranks
    assert r0["mods"] == r1["mods"] == []


def test_fleet_prom_labels_both_ranks(ranks):
    """Rank 0 writes the fleet exposition of both registries; counters sum
    across ranks, gauges keep ``host=`` labels; rank 1 writes none."""
    from test_obs_smoke import parse_prom
    tmp, _r = ranks
    path = str(tmp / "m.jsonl.fleet.prom")
    prom = parse_prom(open(path).read())
    hosts = {lab.get("host") for _n, lab, _v in
             prom["tpuprof_host_rss_bytes"]["samples"]}
    assert hosts == {"0", "1"}
    rows = sum(v for _n, _l, v in
               prom["tpuprof_ingest_rows_total"]["samples"])
    assert rows == 2 * 3600     # each rank ingests its stripe twice
    events = [json.loads(ln) for ln in open(tmp / "m.jsonl")]
    (snap,) = [e for e in events if e["kind"] == "fleet_snapshot"]
    assert snap["hosts"] == 2


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


CLI = """
import sys
from tpuprof_torch.cli import main
sys.exit(main(sys.argv[1:]))
"""


def test_profile_verb_two_ranks_rank0_writes(ds, singles, tmp_path):
    coord = f"127.0.0.1:{_free_port()}"
    procs = [launch(CLI, [
        "profile", ds, "-o", str(tmp_path / f"r{i}.html"), "--device",
        "cpu", "--batch-rows", str(BATCH), "--spearman", "--coordinator",
        coord, "--num-processes", "2", "--process-id", str(i),
        "--barrier-timeout", "90",
        "--stats-json", str(tmp_path / f"s{i}.json"), "--artifact",
        str(tmp_path / f"a{i}.json")]) for i in range(2)]
    (rc0, log0), (rc1, log1) = finish(procs)
    assert rc0 == 0 and rc1 == 0, (log0[-2000:], log1[-2000:])
    assert "(report written by host 0)" in log1
    assert os.path.exists(tmp_path / "r0.html")
    assert os.path.exists(tmp_path / "a0.json")
    assert not any(os.path.exists(tmp_path / f) for f in
                   ("r1.html", "s1.json", "a1.json"))
    export_close(plain(json.load(open(tmp_path / "s0.json"))), singles[0])
    assert "3,600" in open(tmp_path / "r0.html").read()


CRASH = """
import json, os, sys
rank, rdv, ds, out, ck, every = sys.argv[1:7]
from tpuprof_torch.runtime import distributed
distributed.initialize(rdv, 2, int(rank), timeout_s=90)
import tpuprof_torch
from tpuprof_torch.report.export import stats_to_json
stats = tpuprof_torch.describe(ds, device="cpu", batch_rows=256,
                               checkpoint_path=ck,
                               checkpoint_every_batches=int(every))
json.dump(stats_to_json(stats), open(out, "w"))
distributed.shutdown()
"""


def test_checkpointed_ranks_killed_then_resumed(ds, tmp_path):
    """Each rank saves its stripe every 3 batches to ``PATH.h<i>of2``; a
    ``fold`` fault at the 7th batch kills both after their save at 6.
    Resumed with both chains, then with rank 1's torn (a mixed group: one
    restored, one fresh), each equals the uninterrupted profile; a clean
    finish removes both chains."""
    ck = str(tmp_path / "scan.ckpt")
    outs = [str(tmp_path / f"c{i}.json") for i in range(2)]

    def run(tag, env=None):
        return finish([launch(CRASH, [i, f"file://{tmp_path}/{tag}", ds,
                                      outs[i], ck, 3], env=env)
                       for i in range(2)])

    for rc, log in run("crash", worker_env(TPUPROF_FAULTS="fold:1@7")):
        assert rc != 0 and "injected transient fault" in log, log[-2000:]
    chains = {i: sorted(glob.glob(f"{ck}.h{i}of2*")) for i in range(2)}
    assert os.path.exists(f"{ck}.h0of2") and os.path.exists(f"{ck}.h1of2")
    saved = {p: open(p, "rb").read() for c in chains.values() for p in c}

    for rc, log in run("resume"):
        assert rc == 0, log[-2000:]
    clean = plain(stats_to_json(tpuprof_torch.describe(
        ds, device="cpu", batch_rows=BATCH)))
    got = [plain(json.load(open(o))) for o in outs]
    assert got[0] == got[1]
    export_close(got[0], clean)
    assert not glob.glob(f"{ck}*")

    for p, raw in saved.items():
        with open(p, "wb") as fh:
            fh.write(raw if ".h0of2" in p else b"\0torn\0" * 8)
    logs = run("mixed")
    for rc, log in logs:
        assert rc == 0, log[-2000:]
    assert "start from zero" in logs[0][1] + logs[1][1]
    mixed = [plain(json.load(open(o))) for o in outs]
    assert mixed[0] == mixed[1]
    export_close(mixed[0], clean)
    assert not glob.glob(f"{ck}*")


def test_parity_two_ranks_shared_spill_dir(ds, tmp_path):
    """``parity`` across two ranks with a shared spill dir and a 300-row
    budget (the float columns spill): every exact count equals pandas'
    ``nunique`` over the whole table, rank 0 alone reads the runs (rank 1
    adopts its verdicts), and the runs are gone afterwards."""
    spill = tmp_path / "spill"
    spill.mkdir()
    r0, r1 = _two_ranks(tmp_path, ds, "p", batch_rows=BATCH, parity=True,
                        unique_spill_dir=str(spill),
                        unique_track_rows=300)
    assert r0["stats"] == r1["stats"]
    df = pd.concat([pd.read_parquet(p) for p in
                    sorted(glob.glob(os.path.join(ds, "*.parquet")))])
    for name, v in r0["stats"]["variables"].items():
        assert v["distinct_count"] == df[name].nunique(), name
        assert v["distinct_approx"] is False, name
    assert r0["run_reads"][0] > 0 and r1["run_reads"] == [0]
    assert not list(spill.glob("*.u64"))


def test_profile_verb_argument_errors(ds, tmp_path):
    from tpuprof_torch.cli import main
    base = ["profile", ds, "-o", str(tmp_path / "r.html"), "--device",
            "cpu"]
    assert main(base + ["--coordinator", "127.0.0.1:1"]) == 2
    assert main(base + ["--num-processes", "2", "--process-id", "0"]) == 2
    assert main(base + ["--coordinator", "127.0.0.1:1", "--num-processes",
                        "2", "--process-id", "0", "--parity"]) == 2
    assert not os.path.exists(tmp_path / "r.html")
    np.testing.assert_equal(os.listdir(tmp_path), [])
