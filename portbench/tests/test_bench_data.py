"""The generator: shapes, dtypes, and the same table from the same seed."""

import json
import os

import numpy as np
import pandas as pd
import pytest

from portbench import data
from portbench.tests.conftest import ROOT


def config(name):
    with open(os.path.join(ROOT, "portbench", "configs", f"{name}.json")) as fh:
        return json.load(fh)


def test_synth200_shape_and_dtypes():
    df = data.make_table(config("synth200"), 4096, 7)
    assert df.shape == (4096, 200)
    assert set(df.dtypes) == {np.dtype(np.float32)}
    assert list(df.columns[:2]) == ["c0000", "c0001"]
    share = float(df.isna().to_numpy().mean())
    assert 0.01 < share < 0.03
    # the correlated block and the rising offsets
    assert df["c0000"].corr(df["c0001"]) > 0.8
    assert df["c0199"].mean() > 90 and df["c0000"].mean() < -90


def test_nyctaxi_shape_and_dtypes():
    cfg = config("nyctaxi2019")
    df = data.make_table(cfg, 4096, 7)
    assert list(df.columns) == [c["name"] for c in cfg["columns"]]
    kinds = df.dtypes.astype(str).value_counts().to_dict()
    assert kinds["float64"] == 9 and kinds["int64"] == 6
    assert kinds["datetime64[ns]"] == 2
    assert set(df["store_and_fwd_flag"].dropna()) <= {"N", "Y"}
    assert df["PULocationID"].between(1, 265).all()
    assert (df["tpep_dropoff_datetime"] >= df["tpep_pickup_datetime"]).all()
    assert df["congestion_surcharge"].isna().mean() > 0.95
    assert 0.07 < df["fare_amount"].isna().mean() < 0.13


@pytest.mark.parametrize("name", ["synth200", "nyctaxi2019"])
def test_same_seed_same_table(name):
    cfg = config(name)
    a = data.make_table(cfg, 2048, 2 ** 31 + 11)
    b = data.make_table(cfg, 2048, 2 ** 31 + 11)
    c = data.make_table(cfg, 2048, 2 ** 31 + 12)
    pd.testing.assert_frame_equal(a, b)
    assert not a.equals(c)


def test_files_differ_by_index():
    cfg = config("synth200")
    a = data.make_table(cfg, 1024, [5, 1])
    b = data.make_table(cfg, 1024, [5, 2])
    assert not a.equals(b)
    pd.testing.assert_frame_equal(a, data.make_table(cfg, 1024, [5, 1]))


def test_batch_sizes_end_at_row_groups(tmp_path):
    import pyarrow as pa
    import pyarrow.parquet as pq

    from portbench.data import batch_sizes
    df = pd.DataFrame({"x": np.arange(12_000, dtype=np.float32)})
    path = str(tmp_path / "t.parquet")
    pq.write_table(pa.Table.from_pandas(df, preserve_index=False), path,
                   row_group_size=5_000)
    assert batch_sizes(path, 2048) == [2048, 2048, 904] * 2 + [2000]
    assert batch_sizes(df, 2048) == [2048] * 5 + [1760]
