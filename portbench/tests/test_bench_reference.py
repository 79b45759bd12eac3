"""The reference against statistics computed by hand on a tiny frame."""

import math

import numpy as np
import pandas as pd
import pytest

from portbench import compare
from portbench.reference.stats import reference


def frame():
    return pd.DataFrame({
        "x": np.array([1.0, 2.0, 3.0, 4.0, np.nan], dtype=np.float32),
        "y": np.array([2.0, 4.0, 6.0, 8.0, 10.0], dtype=np.float32),
        "z": np.array([4.0, 3.0, 2.0, 1.0, 0.0], dtype=np.float32),
        "k": np.array([5, 5, 5, 5, 5], dtype=np.int64),
        "d": pd.to_datetime(["2019-01-02", None, "2019-01-01",
                             "2019-01-03", "2019-01-01"]),
        "f": ["Y", "N", "N", None, "N"],
    })


def test_numeric_column_by_hand():
    r = reference(frame(), bins=3, corr_reject=0.9)
    x = r["columns"]["x"]
    assert x["type"] == "NUM" and x["count"] == 4 and x["n_missing"] == 1
    assert (x["min"], x["max"], x["sum"], x["mean"]) == (1.0, 4.0, 10.0, 2.5)
    assert x["variance"] == pytest.approx(5.0 / 3.0)
    assert x["std"] == pytest.approx(math.sqrt(5.0 / 3.0))
    assert x["skewness"] == pytest.approx(0.0, abs=1e-12)
    # population m4 / m2^2 - 3 of 1, 2, 3, 4: 2.5625 / 1.5625 - 3
    assert x["kurtosis"] == pytest.approx(2.5625 / 1.5625 - 3.0)
    assert x["mad"] == pytest.approx(1.0)
    assert x["histogram"].tolist() == [1, 1, 2]   # [1, 2), [2, 3), [3, 4]
    assert x["distinct_count"] == 4 and x["n_zeros"] == 0
    assert r["columns"]["z"]["n_zeros"] == 1


def test_types_rejection_and_pearson():
    r = reference(frame(), bins=3, corr_reject=0.9)
    cols = r["columns"]
    assert cols["k"]["type"] == "CONST"
    # y = 2 * (row + 1): rho(x, y) = 1 over x's rows, so y is rejected,
    # then z = 4 - row against x: -1, rejected too
    assert cols["y"]["type"] == "CORR" and cols["z"]["type"] == "CORR"
    names, rho = r["rho"]
    assert names == ["x", "y", "z"]
    assert rho[0, 1] == pytest.approx(1.0)
    assert rho[0, 2] == pytest.approx(-1.0)
    assert rho[1, 2] == pytest.approx(-1.0)


def test_dates_and_strings():
    r = reference(frame(), bins=3, corr_reject=0.9)
    d = r["columns"]["d"]
    assert d["type"] == "DATE" and d["count"] == 4 and d["n_missing"] == 1
    assert d["min"] == pd.Timestamp("2019-01-01").value
    assert d["max"] == pd.Timestamp("2019-01-03").value
    assert d["distinct_count"] == 3
    f = r["columns"]["f"]
    assert (f["type"], f["count"], f["distinct_count"]) == ("CAT", 4, 2)
    assert r["freq"]["f"] == {"N": 3, "Y": 1}


def test_bfloat16_rounds_every_value():
    df = pd.DataFrame({"v": np.array([1.0, 1.00390625, 100.3, 257.0],
                                     dtype=np.float32)})
    r = reference(df, bins=2, corr_reject=0.9, round_to="bfloat16")
    assert r["columns"]["v"]["min"] == 1.0
    assert r["columns"]["v"]["max"] == 256.0       # 257 is not a bf16 value
    assert r["columns"]["v"]["distinct_count"] == 3


def test_reference_against_itself_is_exact():
    r = reference(frame(), bins=3, corr_reject=0.9)
    nums, bad = compare.numbers(r, r)
    assert bad == []
    assert nums == {"mismatches": 0.0, "hist_moved": 0.0, "moment_err": 0.0,
                    "rho_err": 0.0, "distinct_err": 0.0}
