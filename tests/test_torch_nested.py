"""Nested (list, struct, map) columns in the port against the reference.

Mirrors ``tests/test_nested.py``: under ``nested="stringify"`` (the
default) a nested column profiles as a categorical column of the ``str()``
of each value; under ``nested="opaque"`` it reports count, missing and
memory only, with no decode, and the stats contract's fields stay.  Both
policies on a Parquet file with list, struct and map columns, every field
against the reference's ``describe(path, backend="tpu")``: type, counts,
``distinct_count``, top-k and ``memorysize`` (both read the same Parquet
file, so the Arrow layout is the same).
"""

import json

import jax  # noqa: F401  (JAX stays on the CPU: tests/conftest.py)
import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import tpuprof
import tpuprof_torch
from tpuprof_torch import cli, schema
from tpuprof_torch.config import ProfilerConfig
from tpuprof_torch.ingest import arrow as port_arrow
from tpuprof_torch.ingest.arrow import ColumnPlan
from torch_route import same_hash_route  # noqa: F401  (autouse)

BATCH = 512
N = 2000
NESTED = ("tags", "meta", "attrs")


@pytest.fixture(scope="module")
def nested_parquet(tmp_path_factory):
    rng = np.random.default_rng(31)
    vocab = [f"w{i}" for i in range(12)]
    tags = [None if i % 10 == 0 else
            [vocab[j] for j in rng.integers(0, 12, rng.integers(0, 4))]
            for i in range(N)]
    meta = [None if i % 7 == 0 else
            {"a": int(rng.integers(0, 5)), "b": vocab[int(rng.integers(0, 3))]}
            for i in range(N)]
    attrs = [None if i % 9 == 0 else
             [(vocab[int(rng.integers(0, 2))], int(rng.integers(0, 3)))]
             for i in range(N)]
    table = pa.table({
        "num": pa.array(rng.normal(size=N)),
        "tags": pa.array(tags, type=pa.list_(pa.string())),
        "meta": pa.array(meta, type=pa.struct([("a", pa.int64()),
                                               ("b", pa.string())])),
        "attrs": pa.array(attrs, type=pa.map_(pa.string(), pa.int64())),
        "cat": pa.array(rng.choice(["a", "b"], N)),
    })
    path = str(tmp_path_factory.mktemp("nested") / "t.parquet")
    pq.write_table(table, path, row_group_size=700)
    return path


def _both(path, nested):
    port = tpuprof_torch.describe(path, device="cpu", batch_rows=BATCH,
                                  nested=nested)
    ref = tpuprof.describe(path, backend="tpu", batch_rows=BATCH,
                           nested=nested)
    return port, ref


@pytest.mark.parametrize("nested", ["stringify", "opaque"])
def test_policy_matches_reference(nested_parquet, nested):
    port, ref = _both(nested_parquet, nested)
    assert schema.validate_stats(port) == []
    assert list(port["variables"]) == list(ref["variables"])
    for name, rv in ref["variables"].items():
        pv = port["variables"][name]
        for fld in ("type", "count", "n_missing", "p_missing",
                    "distinct_count", "distinct_approx", "is_unique",
                    "memorysize", "mode", "freq"):
            if fld in rv:
                assert pv[fld] == rv[fld], (nested, name, fld)
    assert port["table"]["memorysize"] == ref["table"]["memorysize"]
    assert set(port["freq"]) == set(ref["freq"])
    for name, rf in ref["freq"].items():
        pd.testing.assert_series_equal(port["freq"][name].sort_index(),
                                       rf.sort_index(), check_names=False)
    for name in NESTED:
        v = port["variables"][name]
        assert v["type"] == schema.CAT
        if nested == "stringify":
            assert v["distinct_count"] > 1 and name in port["freq"]
        else:
            assert v["distinct_count"] is None and v["mode"] is None
            assert v["freq"] == 0 and name not in port["freq"]
            assert v["memorysize"] > 0


def test_opaque_counts_and_contract(nested_parquet):
    port = tpuprof_torch.describe(nested_parquet, device="cpu",
                                  batch_rows=BATCH, nested="opaque")
    v = port["variables"]["tags"]
    assert v["count"] == N - N // 10 and v["n_missing"] == N // 10
    assert v["distinct_approx"] is True
    assert list(port["variables"]) == ["num", *NESTED[:1], "meta",
                                       "attrs", "cat"]
    assert port["variables"]["cat"]["distinct_count"] == 2
    assert not [m for m in port["messages"]
                if m.column in NESTED
                and m.kind in (schema.MSG_HIGH_CARDINALITY,
                               schema.MSG_APPROX_DISTINCT)]


def test_opaque_skips_stringification(nested_parquet):
    """The warned per-row ``str()`` loop never runs under opaque."""
    for name in NESTED:
        port_arrow._NESTED_WARNED.discard(name)
    tpuprof_torch.describe(nested_parquet, device="cpu", batch_rows=BATCH,
                           nested="opaque")
    assert not port_arrow._NESTED_WARNED & set(NESTED)
    plan = ColumnPlan.from_schema(pq.read_schema(nested_parquet),
                                  nested="opaque")
    assert [s.hash_lane for s in plan.specs] == [0, -1, -1, -1, 1]
    assert plan.n_hash == 2 and all(s.opaque for s in plan.specs[1:4])


def test_opaque_renders_and_exports(nested_parquet, tmp_path, capsys):
    out, sj = str(tmp_path / "r.html"), str(tmp_path / "s.json")
    rc = cli.main(["profile", nested_parquet, "-o", out, "--device", "cpu",
                   "--batch-rows", str(BATCH), "--nested", "opaque",
                   "--stats-json", sj])
    capsys.readouterr()
    assert rc == 0
    with open(out, encoding="utf-8") as fh:
        assert 'id="var-tags"' in fh.read()
    with open(sj) as fh:
        payload = json.load(fh)
    # unknown cardinality is a raw null; its display twin the empty string
    assert payload["variables"]["tags"]["distinct_count"] is None
    assert payload["display"]["variables"]["tags"]["distinct_count"] == ""


def test_unknown_policy_raises():
    with pytest.raises(ValueError, match="nested="):
        ProfilerConfig(nested="drop")
    with pytest.raises(ValueError, match="nested="):
        ColumnPlan.from_schema(pa.schema([("x", pa.int64())]),
                               nested="drop")
