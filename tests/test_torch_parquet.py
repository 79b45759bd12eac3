"""Parquet and ``pyarrow.dataset`` sources of the port against the reference.

``tpuprof_torch.describe(source, device="cpu")`` (the kernels' plain
versions) against ``tpuprof.describe(source, backend="tpu")`` (JAX on CPU
devices, Pallas kernels in interpret mode) on the same path: a file whose
row groups are smaller than ``batch_rows``, a directory of three such files,
and a dataset object.  The scanner's batches end at row-group and file
edges, so short batches come mid-stream, and the string columns arrive as
one dictionary a row group.  Tolerances are ROADMAP's: counts, histograms
and min/max exact; moments ``rtol=5e-4, atol=1e-5``; rho ``atol=5e-4``.

One field depends on the Arrow layout and not on the values: ``memorysize``
(each column's Arrow buffer bytes, and the table's sum).  A Parquet read
carries a validity bitmap where the column has nulls and one dictionary a
row group; a DataFrame converts to one buffer a column.  Both packages
report the same ``memorysize`` for the same source, and both report
another for the DataFrame of the same rows."""

import dataclasses
import json
import os

import jax  # noqa: F401  (JAX stays on the CPU: tests/conftest.py)
import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.dataset as pads
import pyarrow.parquet as pq
import pytest
import torch

import tpuprof
import tpuprof_torch
from tpuprof import schema as ref_schema
from tpuprof_torch.ingest.arrow import ArrowIngest
from tpuprof_torch.report.export import stats_to_json
from torch_route import same_hash_route  # noqa: F401  (autouse)

RTOL, ATOL, RHO_ATOL = 5e-4, 1e-5, 5e-4
BATCH = 512
MOMENTS = ("mean", "std", "variance", "sum", "mad", "skewness", "kurtosis",
           "cv")
# the field that measures the Arrow layout, not the values (see above)
LAYOUT_FIELDS = ("memorysize",)


def _frame(n=3000, seed=7):
    rng = np.random.default_rng(seed)
    fare = rng.gamma(2.0, 7.5, n)
    df = pd.DataFrame({
        "fare_amount": fare,
        "tip_amount": fare * 0.2 + rng.normal(0, 0.5, n),
        "f32": rng.normal(3.0, 2.0, n).astype(np.float32),
        "passenger_count": rng.integers(1, 7, n).astype(np.int64),
        "vendor_id": rng.choice(["CMT", "VTS", "DDS"], n,
                                p=[0.5, 0.4, 0.1]),
        "payment": rng.choice([f"p{i}" for i in range(40)], n),
        "pickup_datetime": pd.Timestamp("2019-01-01") + pd.to_timedelta(
            rng.integers(0, 31 * 24 * 3600, n), unit="s"),
        "store_and_fwd": rng.random(n) < 0.3,
        "const_col": 1.0,
        "record_id": [f"id_{i:06d}" for i in range(n)],
    })
    df.loc[rng.choice(n, 200, replace=False), "fare_amount"] = np.nan
    df.loc[rng.choice(n, 100, replace=False), "vendor_id"] = None
    return df


@pytest.fixture(scope="module")
def frame():
    return _frame()


@pytest.fixture(scope="module")
def paths(frame, tmp_path_factory):
    """{"file": one file, row groups of 300; "dir": three files of 1,100,
    1,000 and 900 rows, row groups of 300}."""
    root = tmp_path_factory.mktemp("parquet")
    table = pa.Table.from_pandas(frame, preserve_index=False)
    pq.write_table(table, root / "one.parquet", row_group_size=300)
    d = root / "dir"
    d.mkdir()
    for i, (lo, n) in enumerate(((0, 1100), (1100, 1000), (2100, 900))):
        pq.write_table(table.slice(lo, n), d / f"part{i}.parquet",
                       row_group_size=300)
    return {"file": str(root / "one.parquet"), "dir": str(d)}


def _source(paths, kind):
    if kind == "dataset":
        return pads.dataset(paths["dir"], format="parquet")
    return paths[kind]


@pytest.fixture(scope="module")
def runs(paths):
    """{kind: (port stats, reference stats)} on each source kind."""
    out = {}
    for kind in ("file", "dir", "dataset"):
        port = tpuprof_torch.describe(_source(paths, kind), device="cpu",
                                      batch_rows=BATCH)
        ref = tpuprof.describe(_source(paths, kind), backend="tpu",
                               batch_rows=BATCH)
        out[kind] = (port, ref)
    return out


KINDS = ["file", "dir", "dataset"]


@pytest.mark.parametrize("kind", KINDS)
def test_types_counts_histograms_exact(runs, kind):
    port, ref = runs[kind]
    assert list(port["variables"]) == list(ref["variables"])
    assert port["table"] == ref["table"]
    for name, rv in ref["variables"].items():
        pv = port["variables"][name]
        assert pv["type"] == rv["type"], name
        for fld in ("count", "n_missing", "distinct_count", "is_unique",
                    "memorysize"):
            assert pv[fld] == rv[fld], (name, fld)
        if rv["type"] == ref_schema.NUM:
            for fld in ("n_zeros", "n_infinite", "min", "max", "p5", "p50",
                        "p95", "mode"):
                assert pv[fld] == rv[fld], (name, fld)
            np.testing.assert_array_equal(pv["histogram"][0],
                                          rv["histogram"][0], err_msg=name)
            np.testing.assert_array_equal(pv["histogram"][1],
                                          rv["histogram"][1], err_msg=name)


@pytest.mark.parametrize("kind", KINDS)
def test_moments_within_tolerance(runs, kind):
    port, ref = runs[kind]
    for name, rv in ref["variables"].items():
        if rv["type"] != ref_schema.NUM:
            continue
        for fld in MOMENTS:
            np.testing.assert_allclose(port["variables"][name][fld],
                                       rv[fld], rtol=RTOL, atol=ATOL,
                                       err_msg=f"{name}.{fld}")


@pytest.mark.parametrize("kind", KINDS)
def test_pearson_and_rejection_within_atol(runs, kind):
    port, ref = runs[kind]
    pp, rp = port["correlations"]["pearson"], ref["correlations"]["pearson"]
    assert list(pp.index) == list(rp.index)
    np.testing.assert_allclose(pp.to_numpy(), rp.to_numpy(), rtol=0,
                               atol=RHO_ATOL, equal_nan=True)
    assert port["variables"]["tip_amount"]["type"] == ref_schema.CORR
    assert [(m.kind, m.column) for m in port["messages"]] == \
        [(m.kind, m.column) for m in ref["messages"]]


@pytest.mark.parametrize("kind", KINDS)
def test_topk_and_sample_equal(runs, kind):
    """Dictionary string columns (one dictionary a row group) give the
    reference's exact top-k; the sample is the dataset's head."""
    port, ref = runs[kind]
    assert set(port["freq"]) == set(ref["freq"])
    for name, rf in ref["freq"].items():
        pd.testing.assert_series_equal(port["freq"][name], rf,
                                       check_names=False)
    pd.testing.assert_frame_equal(port["sample"], ref["sample"])


def _without_layout(stats):
    doc = stats_to_json(stats)
    for section in (doc, doc["display"]):
        for fld in LAYOUT_FIELDS:
            section["table"].pop(fld)
            for var in section["variables"].values():
                var.pop(fld)
    return doc


def _assert_close_docs(a, b, path=""):
    """Two exported docs equal, floats within the moment tolerance."""
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _assert_close_docs(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_close_docs(x, y, f"{path}[{i}]")
    elif isinstance(a, float) and isinstance(b, float):
        tol = RHO_ATOL if ".correlations." in path else ATOL
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=tol, err_msg=path)
    elif path.startswith(".display."):
        return          # the human formatting of a float within tolerance
    else:
        assert a == b, path


def test_dataframe_equals_parquet_except_layout(frame, runs):
    """The same rows as a DataFrame (fixed 512-row windows) and as a
    Parquet directory (batches cut at row groups and files): the same
    statistics, floats within the moment tolerance, except
    ``memorysize``."""
    on_df = tpuprof_torch.describe(frame, device="cpu", batch_rows=BATCH)
    on_dir = runs["dir"][0]
    _assert_close_docs(_without_layout(on_df), _without_layout(on_dir))
    differs = [name for name, v in on_df["variables"].items()
               if v["memorysize"] != on_dir["variables"][name]["memorysize"]]
    assert "vendor_id" in differs and "record_id" in differs


def test_reference_memorysize_also_depends_on_layout(frame, runs):
    """The reference's own behaviour on the same two sources: its
    DataFrame ``memorysize`` equals the port's DataFrame one, its Parquet
    one the port's Parquet one, and the two differ."""
    ref_df = tpuprof.describe(frame, backend="tpu", batch_rows=BATCH)
    port_df = tpuprof_torch.describe(frame, device="cpu", batch_rows=BATCH)
    port_dir, ref_dir = runs["dir"]
    for name in frame.columns:
        assert ref_df["variables"][name]["memorysize"] == \
            port_df["variables"][name]["memorysize"], name
        assert ref_dir["variables"][name]["memorysize"] == \
            port_dir["variables"][name]["memorysize"], name
    assert ref_df["table"]["memorysize"] != ref_dir["table"]["memorysize"]


def test_parquet_strings_arrive_as_row_group_dictionaries(paths):
    ingest = ArrowIngest(paths["dir"], BATCH)
    cats = {s.name: s for s in ingest.plan.by_role("cat")}
    assert set(cats) == {"vendor_id", "payment", "record_id"}
    for spec in cats.values():
        assert isinstance(spec.arrow_type, pa.DictionaryType)
    sizes = [rb.num_rows for rb in ingest.raw_batches()]
    assert sum(sizes) == 3000 and max(sizes) <= BATCH
    assert min(sizes) < BATCH      # batches end at row groups and files
    dicts = {rb.column(rb.schema.get_field_index("record_id")).dictionary
             .to_pylist()[0] for rb in ingest.raw_batches()}
    row_groups = sum(pq.ParquetFile(os.path.join(paths["dir"], f))
                     .num_row_groups for f in os.listdir(paths["dir"]))
    assert len(dicts) == row_groups == 11      # one dictionary a row group


def test_short_batches_fold_deterministically(paths):
    """Staged groups of S (S = 3, 1) and a rerun give the same bits on a
    stream of short batches, two-pass and fused."""
    docs = []
    for scan_batches in (3, 1, 3):
        for passes in ("two_pass", "fused"):
            stats = tpuprof_torch.describe(
                paths["dir"], device="cpu", batch_rows=BATCH,
                scan_batches=scan_batches, profile_passes=passes)
            docs.append(json.dumps(stats_to_json(stats), sort_keys=True))
    assert len(set(docs)) == 1


def test_columns_pushdown_skips_a_nested_column(frame, tmp_path):
    table = pa.Table.from_pandas(frame, preserve_index=False)
    nested = pa.array([[i, i + 1] for i in range(len(frame))],
                      type=pa.list_(pa.int64()))
    path = str(tmp_path / "nested.parquet")
    pq.write_table(table.append_column("tags", nested), path,
                   row_group_size=300)
    # without the projection the nested column profiles through its str()
    # form, as the reference's default nested="stringify" does
    whole = tpuprof_torch.describe(path, device="cpu", batch_rows=BATCH)
    ref_whole = tpuprof.describe(path, backend="tpu", batch_rows=BATCH)
    for fld in ("type", "count", "n_missing", "distinct_count"):
        assert whole["variables"]["tags"][fld] == \
            ref_whole["variables"]["tags"][fld], fld
    cols = ["record_id", "fare_amount", "vendor_id"]
    ingest = ArrowIngest(path, BATCH, columns=cols)
    assert [s.name for s in ingest.plan.specs] == cols
    assert all(rb.schema.names == cols for rb in ingest.raw_batches())
    port = tpuprof_torch.describe(path, device="cpu", batch_rows=BATCH,
                                  columns=cols)
    ref = tpuprof.describe(path, backend="tpu", batch_rows=BATCH,
                           columns=cols)
    assert list(port["variables"]) == cols
    for name, rv in ref["variables"].items():
        pv = port["variables"][name]
        for fld in ("type", "count", "n_missing", "distinct_count",
                    "memorysize"):
            assert pv[fld] == rv[fld], (name, fld)
    pd.testing.assert_series_equal(port["freq"]["vendor_id"],
                                   ref["freq"]["vendor_id"],
                                   check_names=False)
    from tpuprof_torch.errors import InputError
    with pytest.raises(InputError, match="nope"):
        tpuprof_torch.describe(path, device="cpu", columns=["nope"])


def test_path_without_cuda_raises(paths, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpuprof_torch.ProfileReport(paths["file"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpuprof_torch.describe(pads.dataset(paths["dir"]))


def test_artifact_path_is_inert_in_the_library(paths, tmp_path):
    """As in the reference, only the command line writes the artifact."""
    art = tmp_path / "a.json"
    config = tpuprof_torch.ProfilerConfig(batch_rows=BATCH,
                                          artifact_path=str(art))
    assert dataclasses.replace(config).artifact_path == str(art)
    tpuprof_torch.describe(paths["file"], config, device="cpu")
    assert not os.path.exists(art)
