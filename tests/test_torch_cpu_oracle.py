"""The port's CPU oracle (``tpuprof_torch/backends/cpu.py``) against the
reference's (``tpuprof/backends/cpu.py``).

Both are the same numpy/pandas arithmetic, so the stats dicts are EQUAL —
compared through each package's ``stats_to_json`` export, key for key —
on the conftest fixture and on the edge-case frames: empty, one row,
all-NaN, ±inf, int64 near 2**62, uint64, bool, tz-aware dates with NaT,
timedelta, nullable ``Int64``, float16, unicode, constant, all-unique.
Every case of ``tests/test_cpu_oracle.py`` then runs on the port.  The
oracle runs only when named: ``backend="auto"`` without CUDA and without
``device="cpu"`` raises and never returns oracle stats, and the oracle
with ``elastic`` raises ``InputError``.
"""

import json

import jax  # noqa: F401  (JAX stays on the CPU: tests/conftest.py)
import numpy as np
import pandas as pd
import pytest
import torch

import tpuprof_torch
from tpuprof.backends.cpu import CPUStatsBackend as RefOracle
from tpuprof.config import ProfilerConfig as RefConfig
from tpuprof.report.export import stats_to_json as ref_to_json
from tpuprof_torch import ProfilerConfig, describe, schema
from tpuprof_torch.backends.base import get_backend
from tpuprof_torch.backends.cpu import CPUStatsBackend
from tpuprof_torch.errors import InputError
from tpuprof_torch.kernels import fused, hist
from tpuprof_torch.report.export import stats_to_json


def _collect(df, **kw):
    return CPUStatsBackend().collect(df, ProfilerConfig(backend="cpu", **kw))


def _json(doc) -> str:
    return json.dumps(doc, sort_keys=True, default=str)


def _both(df, **kw):
    mine = stats_to_json(_collect(df, **kw))
    ref = ref_to_json(RefOracle().collect(df, RefConfig(backend="cpu", **kw)))
    return mine, ref


def _edge_frames():
    rng = np.random.default_rng(7)
    n = 40
    tz = pd.Series(pd.date_range("2024-01-01", periods=n, freq="h",
                                 tz="Europe/Berlin"))
    tz[3] = pd.NaT
    return {
        "empty": pd.DataFrame({"x": pd.Series([], dtype="float64"),
                               "s": pd.Series([], dtype=object)}),
        "one_row": pd.DataFrame({"x": [1.5], "s": ["a"], "b": [True]}),
        "all_nan": pd.DataFrame({"x": [np.nan] * n,
                                 "y": rng.normal(size=n)}),
        "inf": pd.DataFrame({"x": np.r_[np.inf, -np.inf,
                                        rng.normal(size=n - 2)],
                             "y": rng.normal(size=n)}),
        "int64_2_62": pd.DataFrame({"x": rng.integers(
            2 ** 62, 2 ** 62 + 2 ** 40, n, dtype=np.int64),
            "y": rng.integers(0, 9, n)}),
        "uint64": pd.DataFrame({"x": (np.arange(n, dtype=np.uint64)
                                      * np.uint64(2 ** 40)),
                                "y": rng.normal(size=n)}),
        "bool": pd.DataFrame({"b": rng.random(n) < 0.3,
                              "y": rng.normal(size=n)}),
        "tz_nat": pd.DataFrame({"t": tz, "y": rng.normal(size=n)}),
        "timedelta": pd.DataFrame({"d": pd.to_timedelta(
            rng.integers(0, 1000, n), unit="s"), "y": rng.normal(size=n)}),
        "nullable_int": pd.DataFrame({"x": pd.array(
            [None if i % 7 == 0 else i for i in range(n)], dtype="Int64"),
            "y": rng.normal(size=n)}),
        "float16": pd.DataFrame({"x": rng.normal(size=n).astype(np.float16),
                                 "y": rng.normal(size=n)}),
        "unicode": pd.DataFrame({"s": rng.choice(["äö", "日本", "🙂", "x"],
                                                 n),
                                 "y": rng.normal(size=n)}),
        "constant": pd.DataFrame({"c": [3.0] * n, "s": ["k"] * n,
                                  "y": rng.normal(size=n)}),
        "all_unique": pd.DataFrame({"u": [f"id{i}" for i in range(n)],
                                    "v": np.arange(n, dtype=np.float64)}),
    }


EDGE = _edge_frames()


def test_taxi_fixture_equal_to_reference(taxi_like_df):
    mine, ref = _both(taxi_like_df)
    assert _json(mine) == _json(ref)


@pytest.mark.parametrize("name", sorted(EDGE))
def test_edge_frame_equal_to_reference(name):
    mine, ref = _both(EDGE[name])
    assert _json(mine) == _json(ref)
    assert schema.validate_stats(_collect(EDGE[name])) == []


def test_int64_steps_below_float64_resolution_fail_like_reference():
    """Distinct int64 values closer than float64 resolves near 2**62 give
    numpy's histogram zero-width bins: both oracles raise the same error
    (the engine profiles such a column in float32 instead)."""
    df = pd.DataFrame({"x": (2 ** 62 + np.arange(40) * 3).astype(np.int64),
                       "y": np.arange(40.0)})
    with pytest.raises(Exception) as mine:
        _collect(df)
    with pytest.raises(Exception) as ref:
        RefOracle().collect(df, RefConfig(backend="cpu"))
    assert type(mine.value) is type(ref.value)
    assert str(mine.value) == str(ref.value)


@pytest.mark.parametrize("kw", [{"bins": 7}, {"spearman": True},
                                {"columns": ["fare_amount", "vendor_id"]},
                                {"correlation_overrides": ["tip_amount"]}])
def test_options_equal_to_reference(taxi_like_df, kw):
    mine, ref = _both(taxi_like_df, **kw)
    assert _json(mine) == _json(ref)


def test_parquet_path_equal_to_reference(taxi_like_df, tmp_path):
    path = str(tmp_path / "t.parquet")
    taxi_like_df.to_parquet(path)
    mine = stats_to_json(describe(path, backend="cpu"))
    ref = ref_to_json(RefOracle().collect(path, RefConfig(backend="cpu")))
    assert _json(mine) == _json(ref)


# -- the cases of tests/test_cpu_oracle.py, on the port ----------------------

def test_contract_valid(taxi_like_df):
    assert schema.validate_stats(_collect(taxi_like_df)) == []


def test_type_classification(taxi_like_df):
    v = _collect(taxi_like_df)["variables"]
    assert v["fare_amount"]["type"] == schema.NUM
    assert v["tip_amount"]["type"] == schema.CORR
    assert v["vendor_id"]["type"] == schema.CAT
    assert v["pickup_datetime"]["type"] == schema.DATE
    assert v["store_and_fwd"]["type"] == schema.BOOL
    assert v["const_col"]["type"] == schema.CONST
    assert v["record_id"]["type"] == schema.UNIQUE


def test_numeric_moments_exact():
    x = np.array([1.0, 2.0, 3.0, 4.0, 100.0])
    df = pd.DataFrame({"x": x, "y": [1.0, -1.0, 1.0, -1.0, 1.0]})
    v = _collect(df)["variables"]["x"]
    assert v["count"] == 5
    assert v["mean"] == pytest.approx(x.mean())
    assert v["std"] == pytest.approx(x.std(ddof=1))
    assert v["variance"] == pytest.approx(x.var(ddof=1))
    assert v["min"] == 1.0 and v["max"] == 100.0 and v["range"] == 99.0
    assert v["sum"] == pytest.approx(x.sum())
    d = x - x.mean()
    m2, m3, m4 = (d ** 2).mean(), (d ** 3).mean(), (d ** 4).mean()
    assert v["skewness"] == pytest.approx(m3 / m2 ** 1.5)
    assert v["kurtosis"] == pytest.approx(m4 / m2 ** 2 - 3.0)
    assert v["mad"] == pytest.approx(np.abs(d).mean())
    assert v["p50"] == pytest.approx(np.quantile(x, 0.5))
    assert v["iqr"] == pytest.approx(np.quantile(x, .75)
                                     - np.quantile(x, .25))


def test_missing_zeros_inf():
    df = pd.DataFrame({"x": [0.0, 0.0, 1.0, np.nan, np.inf, -np.inf, 5.0],
                       "y": np.arange(7, dtype="float64")})
    v = _collect(df)["variables"]["x"]
    assert v["count"] == 6 and v["n_missing"] == 1
    assert v["p_missing"] == pytest.approx(1 / 7)
    assert v["n_zeros"] == 2 and v["n_infinite"] == 2
    assert v["min"] == -np.inf and v["max"] == np.inf
    finite = np.array([0.0, 0.0, 1.0, 5.0])
    assert v["mean"] == pytest.approx(finite.mean())
    assert v["sum"] == pytest.approx(finite.sum())


def test_histogram_bins():
    df = pd.DataFrame({"x": np.linspace(0, 10, 100),
                       "y": np.random.default_rng(0).normal(size=100)})
    counts, edges = _collect(df, bins=7)["variables"]["x"]["histogram"]
    assert len(counts) == 7 and len(edges) == 8
    assert counts.sum() == 100


def test_corr_rejection_order_and_api(taxi_like_df):
    report = tpuprof_torch.ProfileReport(taxi_like_df, backend="cpu")
    assert report.get_rejected_variables() == ["tip_amount"]
    assert report.get_rejected_variables(0.999) == []
    v = report.description["variables"]["tip_amount"]
    assert v["correlation_var"] == "fare_amount"
    assert abs(v["correlation"]) > 0.9


def test_corr_overrides(taxi_like_df):
    stats = _collect(taxi_like_df, correlation_overrides=["tip_amount"])
    assert stats["variables"]["tip_amount"]["type"] == schema.NUM


def test_table_stats(taxi_like_df):
    t = _collect(taxi_like_df)["table"]
    assert t["n"] == 2000 and t["nvar"] == 10
    assert t[schema.NUM] == 3 and t[schema.CORR] == 1 and t[schema.CAT] == 2
    assert t[schema.DATE] == 1 and t[schema.BOOL] == 1
    assert t[schema.CONST] == 1 and t[schema.UNIQUE] == 1
    assert 0 < t["total_missing"] < 0.05


def test_messages(taxi_like_df):
    kinds = {(m.kind, m.column) for m in _collect(taxi_like_df)["messages"]}
    assert (schema.MSG_CONST, "const_col") in kinds
    assert (schema.MSG_UNIQUE, "record_id") in kinds
    assert (schema.MSG_CORR, "tip_amount") in kinds


def test_freq_and_sample(taxi_like_df):
    stats = _collect(taxi_like_df)
    vc = stats["freq"]["vendor_id"]
    assert vc.index[0] == "CMT"
    assert vc.sum() == 1900
    assert len(stats["sample"]) == 5


def test_empty_and_edge_frames():
    stats = _collect(pd.DataFrame({"x": pd.Series([], dtype="float64")}))
    assert stats["table"]["n"] == 0
    assert stats["variables"]["x"]["type"] == schema.CONST
    v = _collect(pd.DataFrame({"x": [np.nan, np.nan]}))["variables"]["x"]
    assert v["count"] == 0 and v["n_missing"] == 2
    stats = _collect(pd.DataFrame({"x": [1.0, 1.0, 1.0]}))
    assert stats["variables"]["x"]["type"] == schema.CONST


# -- selection: the oracle only when named -----------------------------------

def test_auto_without_cuda_raises_never_the_oracle(taxi_like_df,
                                                   monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in ("auto", "tpu"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            describe(taxi_like_df, backend=name)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            get_backend(name)
    assert get_backend("auto", device="cpu").name == "gpu"
    assert get_backend("cpu").name == "cpu"
    with pytest.raises(ValueError, match="unknown backend"):
        ProfilerConfig(backend="gpu0")


def test_auto_on_the_cpu_runs_the_engine_not_the_oracle(taxi_like_df):
    """``device="cpu"`` with ``auto`` runs the kernels' plain versions,
    which estimate what the oracle counts exactly (HLL distincts)."""
    eng = describe(taxi_like_df, device="cpu", bins=7)
    ora = describe(taxi_like_df, backend="cpu", bins=7)
    assert "_phases" in eng and "_phases" not in ora
    a, b = eng["variables"]["fare_amount"], ora["variables"]["fare_amount"]
    assert a["count"] == b["count"]
    np.testing.assert_allclose(a["mean"], b["mean"], rtol=5e-4, atol=1e-5)


def test_oracle_launches_nothing(taxi_like_df):
    before = (fused.launches, fused.launches_ab, hist.launches)
    describe(taxi_like_df, backend="cpu")
    assert (fused.launches, fused.launches_ab, hist.launches) == before


def test_elastic_with_the_oracle_is_input_error(taxi_like_df, tmp_path):
    with pytest.raises(InputError, match="elastic fleet mode"):
        describe(taxi_like_df, backend="cpu", elastic=True,
                 fleet_dir=str(tmp_path))


def test_profile_verb_backend_cpu(taxi_like_df, tmp_path, capsys,
                                  monkeypatch):
    from tpuprof_torch import cli
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path = str(tmp_path / "t.parquet")
    taxi_like_df.to_parquet(path)
    out = tmp_path / "s.json"
    assert cli.main(["profile", path, "-o", str(tmp_path / "r.html"),
                     "--backend", "cpu", "--stats-json", str(out)]) == 0
    ref = ref_to_json(RefOracle().collect(path, RefConfig(backend="cpu")))
    with open(out) as fh:
        mine = json.load(fh)
    assert _json(mine) == _json(json.loads(_json(ref)))
    # the engine still needs its device; the oracle takes none
    assert cli.main(["profile", path, "-o", str(tmp_path / "r2.html")]) == 2
    assert cli.main(["profile", path, "--backend", "cpu", "--device",
                     "cpu", "-o", str(tmp_path / "r3.html")]) == 2
    assert cli.main(["profile", path, "--backend", "cpu", "--coordinator",
                     "127.0.0.1:1", "--num-processes", "2",
                     "--process-id", "0"]) == 2
    assert "no fragment striping" in capsys.readouterr().err
