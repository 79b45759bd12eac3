"""The port's profile warehouse (``tpuprof_torch/warehouse``) against the
reference's (``tpuprof/warehouse``).

One chain of generations — a drifting source profiled by the port on the
CPU (the kernels' plain versions), one ``tpuprof-stats-v1`` artifact a
generation — goes into both packages' warehouses.  Then: the Parquet
tables are equal (data, schema, ``stat_columns``; the metadata differs
only in the writer's ``tpuprof_version``), each package reads the other's
generations, ``query_stat``/``query_trend``/``query_columns`` and
``backtest`` give equal documents, a flipped byte is
``CorruptWarehouseError`` in both, a missing pyarrow is
``WarehouseUnavailableError``, the ``warehouse_write`` fault site tears a
write, and the ``history`` and ``backtest`` verbs print what the
reference's print with the same exit codes.
"""

import json
import os
import shutil
import sys

import jax  # noqa: F401  (JAX stays on the CPU: tests/conftest.py)
import numpy as np
import pandas as pd
import pyarrow.parquet as pq
import pytest

import tpuprof_torch
from tpuprof import warehouse as ref_wh
from tpuprof.artifact import DriftThresholds as RefThresholds
from tpuprof.artifact import read_artifact as ref_read_artifact
from tpuprof.cli import main as ref_main
from tpuprof.errors import CorruptWarehouseError as RefCorrupt
from tpuprof.testing import faults as ref_faults
from tpuprof_torch import warehouse as wh
from tpuprof_torch.artifact import (DriftThresholds, read_artifact,
                                    write_artifact)
from tpuprof_torch.cli import main
from tpuprof_torch.config import ProfilerConfig
from tpuprof_torch.errors import (CorruptArtifactError,
                                  CorruptWarehouseError,
                                  WarehouseUnavailableError, exit_code)
from tpuprof_torch.serve.watch import source_key
from tpuprof_torch.testing import faults
from torch_route import same_hash_route  # noqa: F401  (autouse)

N_GENS = 10
JUMP_AT = 6


def _gen_frame(g: int, n: int = 600) -> pd.DataFrame:
    """The same base rows every generation, a small creep on ``a`` and one
    +3 sigma jump at JUMP_AT."""
    rng = np.random.default_rng(11)
    base = rng.normal(0.0, 1.0, n)
    shift = 0.02 * g + (3.0 if g >= JUMP_AT else 0.0)
    return pd.DataFrame({
        "a": base * 2.0 + 10.0 + shift * 2.0,
        "b": rng.exponential(1.0, n),
        "q": rng.integers(0, 9, n).astype(np.int64),
        "c": rng.choice(["x", "y", "z"], n),
    })


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    td = tmp_path_factory.mktemp("twh")
    source = str(td / "drifting.parquet")
    key = source_key(source)
    spool = str(td / "spool")
    watch_dir = os.path.join(spool, "watch", key)
    os.makedirs(watch_dir)
    roots = {"port": str(td / "wh_port"), "ref": str(td / "wh_ref")}
    for g in range(1, N_GENS + 1):
        stats = tpuprof_torch.describe(_gen_frame(g), device="cpu",
                                       batch_rows=256)
        path = os.path.join(watch_dir, f"cycle_{g:08d}.artifact.json")
        write_artifact(path, stats=stats, config=ProfilerConfig(),
                       source=source)
        wh.append_artifact(roots["port"], read_artifact(path),
                           source=source, generation=g)
        ref_wh.append_artifact(roots["ref"], ref_read_artifact(path),
                               source=source, generation=g)
    return {"source": source, "key": key, "spool": spool,
            "watch_dir": watch_dir, "roots": roots,
            "dirs": {k: os.path.join(v, key) for k, v in roots.items()}}


@pytest.fixture(autouse=True)
def no_faults():
    faults.reset()
    ref_faults.reset()
    yield
    faults.reset()
    ref_faults.reset()


def _masked(doc, *paths):
    text = json.dumps(doc, sort_keys=True)
    for p in paths:
        text = text.replace(p, "<DIR>")
    return json.loads(text)


def _gen_files(chain, tag):
    return wh.chain(chain["dirs"][tag])


def test_source_key_is_the_reference_key(chain):
    from tpuprof.serve.watch import source_key as ref_key
    for s in (chain["source"], "rel/data.parquet", "/x/y/", "we ird!.pq"):
        assert source_key(s) == ref_key(s)
    assert sorted(os.listdir(chain["roots"]["port"])) \
        == sorted(os.listdir(chain["roots"]["ref"])) == [chain["key"]]


def test_parquet_tables_equal_but_the_version_stamp(chain):
    port, ref = _gen_files(chain, "port"), _gen_files(chain, "ref")
    assert [g for g, _ in port] == [g for g, _ in ref] \
        == list(range(1, N_GENS + 1))
    for (_, a), (_, b) in zip(port, ref):
        ta, tb = pq.read_table(a), pq.read_table(b)
        assert ta.schema.remove_metadata() == tb.schema.remove_metadata()
        assert ta.to_pydict() == tb.to_pydict()
        ma, mb = dict(ta.schema.metadata), dict(tb.schema.metadata)
        assert json.loads(ma.pop(b"tpuprof.tpuprof_version")) \
            == tpuprof_torch.__version__
        mb.pop(b"tpuprof.tpuprof_version")
        assert ma == mb


def test_stat_columns_equal(chain):
    art = read_artifact(os.path.join(chain["watch_dir"],
                                     "cycle_00000001.artifact.json"))
    from tpuprof.warehouse.columnar import stat_columns as ref_stat_columns
    variables = art.stats["variables"]
    assert wh.columnar.stat_columns(variables) \
        == ref_stat_columns(variables)
    assert "mean" in wh.columnar.stat_columns(variables)


@pytest.mark.parametrize("reader", ["port_reads_ref", "ref_reads_port"])
def test_each_package_reads_the_others_generations(chain, reader):
    port, ref = _gen_files(chain, "port"), _gen_files(chain, "ref")
    for (_, a), (_, b) in zip(port, ref):
        if reader == "port_reads_ref":
            mine, theirs = wh.read_stats_parquet(b), \
                ref_wh.read_stats_parquet(b)
        else:
            mine, theirs = ref_wh.read_stats_parquet(a), \
                wh.read_stats_parquet(a)
        assert mine.meta == theirs.meta
        assert (mine.columns, mine.stats) == (theirs.columns, theirs.stats)
    g = wh.read_stats_parquet(port[-1][1], columns=["a"],
                              stats=["mean", "std"])
    h = ref_wh.read_stats_parquet(port[-1][1], columns=["a"],
                                  stats=["mean", "std"])
    assert g.stats == h.stats and set(g.stats["a"]) == {"mean", "std"}


@pytest.mark.parametrize("col,stat", [("a", "mean"), ("b", "std"),
                                      ("q", "distinct_count"),
                                      ("c", "p_missing"), ("nope", "mean")])
def test_query_stat_equal(chain, col, stat):
    a = wh.query_stat(chain["dirs"]["port"], col, stat)
    b = ref_wh.query_stat(chain["dirs"]["ref"], col, stat)
    assert _masked(a, chain["dirs"]["port"]) \
        == _masked(b, chain["dirs"]["ref"])
    assert a["generations"] == N_GENS


@pytest.mark.parametrize("col", [None, "a", "b"])
def test_query_trend_equal(chain, col):
    a = wh.query_trend(chain["dirs"]["port"], col=col)
    b = ref_wh.query_trend(chain["dirs"]["ref"], col=col)
    assert _masked(a, chain["dirs"]["port"]) \
        == _masked(b, chain["dirs"]["ref"])
    if col in (None, "a"):
        psi = [e["columns"]["a"]["psi"] for e in a["series"]]
        assert int(np.argmax(psi)) + 2 == JUMP_AT


def test_query_columns_equal(chain):
    cols, stats = ["a", "c", "missing_col"], ["mean", "count"]
    a = wh.history.query_columns(chain["dirs"]["port"], cols, stats)
    b = ref_wh.history.query_columns(chain["dirs"]["ref"], cols, stats)
    assert a == b and a["missing"] == ["missing_col"]
    assert a["generation"] == N_GENS


@pytest.mark.parametrize("psi", [None, 0.05])
def test_backtest_equal(chain, psi):
    a = wh.backtest(chain["watch_dir"], DriftThresholds.from_cli(psi=psi))
    b = ref_wh.backtest(chain["watch_dir"], RefThresholds.from_cli(psi=psi))
    assert a == b
    assert any(al["cycle"] == JUMP_AT for al in a["alerts"])
    assert wh.chain_dir(chain["spool"], chain["source"]) \
        == ref_wh.chain_dir(chain["spool"], chain["source"]) \
        == chain["watch_dir"]


def _flipped(src, dst):
    if src != dst:
        shutil.copy(src, dst)
    with open(dst, "r+b") as fh:
        blob = fh.read()
        fh.seek(len(blob) - 5)       # the footer length / magic
        fh.write(bytes([blob[-5] ^ 0xFF]))
    return dst


def test_flipped_byte_is_corrupt_in_both(chain, tmp_path):
    bad = _flipped(_gen_files(chain, "port")[0][1],
                   str(tmp_path / "gen_00000001.stats.parquet"))
    with pytest.raises(CorruptWarehouseError) as ei:
        wh.read_stats_parquet(bad)
    assert isinstance(ei.value, CorruptArtifactError)
    assert exit_code(ei.value) == 6
    with pytest.raises(RefCorrupt):
        ref_wh.read_stats_parquet(bad)
    for n in (0, 10, 200):
        torn = str(tmp_path / f"torn{n}.parquet")
        with open(_gen_files(chain, "port")[0][1], "rb") as fh:
            blob = fh.read()
        with open(torn, "wb") as fh:
            fh.write(blob[:n])
        with pytest.raises(CorruptWarehouseError):
            wh.read_stats_parquet(torn)


def test_corrupt_generation_walked_past_like_reference(chain, tmp_path):
    docs = {}
    for tag, mod in (("port", wh), ("ref", ref_wh)):
        d = str(tmp_path / tag / chain["key"])
        shutil.copytree(chain["dirs"][tag], d)
        _flipped(os.path.join(d, "gen_00000003.stats.parquet"),
                 os.path.join(d, "gen_00000003.stats.parquet"))
        docs[tag] = (_masked(mod.query_stat(d, "a", "mean"), d),
                     _masked(mod.query_trend(d, col="a"), d))
        seen = []
        mod.history.query_columns(d, ["a"], ["mean"])
        os.remove(os.path.join(d, "gen_00000010.stats.parquet"))
        _flipped(os.path.join(d, "gen_00000009.stats.parquet"),
                 os.path.join(d, "gen_00000009.stats.parquet"))
        got = mod.history.query_columns(
            d, ["a"], ["mean"], on_corrupt=lambda p, e: seen.append(
                os.path.basename(p)))
        assert got["generation"] == 8 \
            and seen == ["gen_00000009.stats.parquet"]
    assert docs["port"] == docs["ref"]
    assert docs["port"][0]["skipped_corrupt"] == [3]


@pytest.fixture
def no_pyarrow(monkeypatch):
    monkeypatch.setitem(sys.modules, "pyarrow", None)
    monkeypatch.delitem(sys.modules, "pyarrow.parquet", raising=False)


def test_pyarrow_gate(no_pyarrow, tmp_path, chain):
    with pytest.raises(WarehouseUnavailableError, match="pyarrow") as ei:
        wh.write_stats_parquet(str(tmp_path / "g.parquet"),
                               {"variables": {}})
    assert exit_code(ei.value) == 10
    assert "warehouse_format=off" in str(ei.value)
    with pytest.raises(WarehouseUnavailableError):
        wh.append_generation(str(tmp_path / "root"), "src", {})
    assert not os.listdir(tmp_path)     # nothing half-written
    with pytest.raises(WarehouseUnavailableError):
        wh.read_stats_parquet(_gen_files(chain, "port")[0][1])


def test_warehouse_write_fault_site(chain, tmp_path):
    art = read_artifact(os.path.join(chain["watch_dir"],
                                     "cycle_00000001.artifact.json"))
    faults.configure("warehouse_write:truncate@1")
    torn = wh.append_artifact(str(tmp_path / "w"), art, source="s",
                              generation=1)
    with pytest.raises(CorruptWarehouseError):
        wh.read_stats_parquet(torn)
    ok = wh.append_artifact(str(tmp_path / "w"), art, source="s",
                            generation=2)
    assert wh.read_stats_parquet(ok).generation == 2
    faults.configure("warehouse_write:1@1")
    with pytest.raises(Exception, match="injected"):
        wh.append_artifact(str(tmp_path / "w2"), art, source="s",
                           generation=1)
    assert faults.injected("warehouse_write") == 1


def _run(fn, argv, capsys):
    rc = fn(argv)
    cap = capsys.readouterr()
    return rc, cap.out, cap.err


@pytest.mark.parametrize("argv", [
    ["--col", "a"], ["--col", "b", "--stat", "std"], ["--trend"],
    ["--trend", "--col", "a", "--json"], ["--col", "q", "--json"],
    [], ["--col", "a", "--warehouse-dir", "{empty}"]])
def test_history_verb_against_reference(chain, argv, capsys, tmp_path):
    empty = str(tmp_path / "empty")
    outs = {}
    for tag, fn in (("port", main), ("ref", ref_main)):
        args = [a.format(empty=empty) for a in argv]
        if "--warehouse-dir" not in args:
            args += ["--warehouse-dir", chain["roots"][tag]]
        rc, out, err = _run(fn, ["history", chain["source"]] + args,
                            capsys)
        out = out.replace(chain["roots"][tag], "<ROOT>")
        outs[tag] = (rc, out, bool(err))
    assert outs["port"] == outs["ref"]


@pytest.mark.parametrize("argv", [[], ["--json"],
                                  ["--psi-threshold", "0.05"],
                                  ["--no-spool"]])
def test_backtest_verb_against_reference(chain, argv, capsys, tmp_path):
    outs = {}
    for tag, fn in (("port", main), ("ref", ref_main)):
        if argv == ["--no-spool"]:
            args = ["backtest", str(tmp_path / "nothing.parquet")]
        else:
            args = ["backtest", chain["source"], "--spool",
                    chain["spool"]] + argv
        rc, out, err = _run(fn, args, capsys)
        err = err.replace("tpuprof_torch:", "tpuprof:")
        outs[tag] = (rc, out, err)
    assert outs["port"] == outs["ref"]


def test_history_without_pyarrow_exits_10(chain, capsys, monkeypatch):
    monkeypatch.setitem(sys.modules, "pyarrow", None)
    monkeypatch.delitem(sys.modules, "pyarrow.parquet", raising=False)
    rc = main(["history", chain["source"], "--warehouse-dir",
               chain["roots"]["port"], "--col", "a"])
    assert rc == 10 and "pyarrow" in capsys.readouterr().err


def test_profile_artifact_feeds_the_warehouse(tmp_path, capsys):
    df = _gen_frame(1)
    src = str(tmp_path / "t.parquet")
    df.to_parquet(src)
    root = str(tmp_path / "wh")
    for i in (1, 2):
        assert main(["profile", src, "-o", str(tmp_path / "r.html"),
                     "--device", "cpu", "--artifact",
                     str(tmp_path / f"a{i}.json"), "--warehouse-dir",
                     root]) == 0
    d = os.path.join(root, source_key(src))
    assert [g for g, _ in wh.chain(d)] == [1, 2]
    art = read_artifact(str(tmp_path / "a2.json"))
    g = ref_wh.read_stats_parquet(wh.chain(d)[-1][1])
    assert g.meta["artifact_crc32"] == art.crc32
    assert g.stats["a"]["mean"] == art.stats["variables"]["a"]["mean"]
    # --warehouse-format off writes nothing, and a warehouse without
    # --artifact is not written either (the reference's rule)
    assert main(["profile", src, "-o", str(tmp_path / "r.html"),
                 "--device", "cpu", "--artifact", str(tmp_path / "a3.json"),
                 "--warehouse-dir", root, "--warehouse-format", "off"]) == 0
    assert main(["profile", src, "-o", str(tmp_path / "r.html"),
                 "--device", "cpu", "--warehouse-dir", root]) == 0
    assert len(wh.chain(d)) == 2
