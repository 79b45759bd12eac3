"""The PyTorch port's whole main path against the JAX reference.

``tpuprof_torch.describe(df, device="cpu")`` (plain PyTorch versions of the
kernels) against ``tpuprof.backends.tpu.TPUStatsBackend().collect`` (its XLA
twins on CPU devices) on the reference backend tests' fixture: exact where
the scan is exact, float32 tolerances for moments and rho."""

import os
import subprocess
import sys
import textwrap

import jax  # noqa: F401  (JAX stays on the CPU: tests/conftest.py)
import numpy as np
import pandas as pd
import pyarrow as pa
import pytest
import torch

import tpuprof_torch
from tpuprof import ProfilerConfig as RefConfig
from tpuprof import schema as ref_schema
from tpuprof.backends.tpu import TPUStatsBackend
from tpuprof_torch import schema
from tpuprof_torch.config import ProfilerConfig
from torch_route import same_hash_route  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# moments: the reference backend tests' own tolerances
# (tests/test_tpu_backend.py); rho: the fused-kernel contract
MOMENT_TOL = [("mean", 1e-4), ("std", 1e-3), ("variance", 2e-3),
              ("sum", 1e-4), ("mad", 1e-3), ("skewness", 2e-2),
              ("kurtosis", 5e-2)]
RHO_ATOL = 5e-4


def _frame(seed=42, n=2000):
    rng = np.random.default_rng(seed)
    fare = rng.gamma(2.0, 7.5, n)
    df = pd.DataFrame({
        "fare_amount": fare,
        "tip_amount": fare * 0.2 + rng.normal(0, 0.5, n),
        "trip_distance": rng.exponential(2.5, n),
        "passenger_count": rng.integers(1, 7, n).astype(np.int64),
        "vendor_id": rng.choice(["CMT", "VTS", "DDS"], n,
                                p=[0.5, 0.4, 0.1]),
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
def fixture_df():
    return _frame()


@pytest.fixture(scope="module")
def both(fixture_df):
    ref = TPUStatsBackend().collect(
        fixture_df, RefConfig(backend="tpu", batch_rows=512))
    port = tpuprof_torch.describe(fixture_df, device="cpu", batch_rows=512)
    return port, ref


def test_contract_and_types(both):
    port, ref = both
    assert schema.validate_stats(port) == []
    assert list(port["variables"]) == list(ref["variables"])
    for name, v in ref["variables"].items():
        assert port["variables"][name]["type"] == v["type"], name


def test_exact_counts_match(both):
    port, ref = both
    assert port["table"]["n"] == ref["table"]["n"]
    for name, rv in ref["variables"].items():
        pv = port["variables"][name]
        for fld in ("count", "n_missing", "distinct_count", "is_unique",
                    "memorysize"):
            assert pv[fld] == rv[fld], (name, fld)
        if rv["type"] == ref_schema.NUM:
            for fld in ("n_zeros", "n_infinite", "min", "max", "p5", "p50",
                        "p95", "mode"):
                assert pv[fld] == rv[fld], (name, fld)


def test_moments_within_f32_tolerance(both):
    port, ref = both
    for name, rv in ref["variables"].items():
        if rv["type"] != ref_schema.NUM:
            continue
        pv = port["variables"][name]
        for fld, tol in MOMENT_TOL:
            assert pv[fld] == pytest.approx(rv[fld], rel=tol, abs=1e-6), \
                (name, fld)


def test_histograms_and_topk_exact(both):
    port, ref = both
    for name, rv in ref["variables"].items():
        pv = port["variables"][name]
        if rv["type"] == ref_schema.NUM:
            np.testing.assert_array_equal(pv["histogram"][0],
                                          rv["histogram"][0], err_msg=name)
            np.testing.assert_array_equal(pv["histogram"][1],
                                          rv["histogram"][1], err_msg=name)
    assert set(port["freq"]) == set(ref["freq"])
    for name, rf in ref["freq"].items():
        pd.testing.assert_series_equal(port["freq"][name].sort_index(),
                                       rf.sort_index(), check_names=False)


def test_pearson_within_atol(both):
    port, ref = both
    pp = port["correlations"]["pearson"]
    rp = ref["correlations"]["pearson"]
    assert list(pp.index) == list(rp.index)
    np.testing.assert_allclose(pp.to_numpy(), rp.to_numpy(), rtol=0,
                               atol=RHO_ATOL, equal_nan=True)


def test_rejected_variables_and_messages_equal(fixture_df, both, tmp_path):
    port, ref = both
    report = tpuprof_torch.ProfileReport(fixture_df, device="cpu",
                                         batch_rows=512)
    assert report.get_rejected_variables() == \
        ref_schema.rejected_variables(ref)
    assert report.get_rejected_variables() == ["tip_amount"]
    assert [(m.kind, m.column) for m in port["messages"]] == \
        [(m.kind, m.column) for m in ref["messages"]]
    assert repr(report) == "<tpuprof_torch.ProfileReport n=2000 nvar=9>"
    # the report renders: the fragment, and the standalone page
    assert 'id="var-tip_amount"' in report.html
    out = tmp_path / "report.html"
    report.to_file(str(out))
    page = out.read_text(encoding="utf-8")
    assert page.startswith("<!DOCTYPE html>") and report.html in page


def test_adversarial_numeric_table_matches_reference():
    """NaN, +-inf, zeros, an all-NaN and an int column with nulls through
    both whole paths (pyarrow Table source)."""
    rng = np.random.default_rng(3)
    n = 1500
    a = rng.normal(100.0, 5.0, n)
    a[rng.random(n) < 0.05] = np.nan
    a[rng.random(n) < 0.02] = np.inf
    a[rng.random(n) < 0.02] = -np.inf
    a[rng.random(n) < 0.05] = 0.0
    b = a * 2.0 + rng.normal(0, 1.0, n)
    ints = pa.array([None if rng.random() < 0.1 else int(v)
                     for v in rng.integers(-50, 50, n)], type=pa.int64())
    table = pa.table({"a": a, "b": b, "all_nan": np.full(n, np.nan),
                      "ints": ints,
                      "f32": rng.normal(0, 1, n).astype(np.float32)})
    ref = TPUStatsBackend().collect(
        table, RefConfig(backend="tpu", batch_rows=256))
    port = tpuprof_torch.describe(table, device="cpu", batch_rows=256)
    for name, rv in ref["variables"].items():
        pv = port["variables"][name]
        assert pv["type"] == rv["type"], name
        for fld in ("count", "n_missing", "distinct_count"):
            assert pv[fld] == rv[fld], (name, fld)
        if rv["type"] == ref_schema.NUM:
            for fld in ("n_zeros", "n_infinite", "min", "max"):
                assert pv[fld] == rv[fld], (name, fld)
            np.testing.assert_array_equal(pv["histogram"][0],
                                          rv["histogram"][0], err_msg=name)
            for fld, tol in MOMENT_TOL:
                assert pv[fld] == pytest.approx(rv[fld], rel=tol,
                                                abs=1e-6), (name, fld)


def test_staged_scan_bit_equal_to_per_batch(fixture_df):
    """scan_batches=3 (one staged group of 3 + a per-batch tail of 1) gives
    the same bits as per-batch folding."""
    one = tpuprof_torch.describe(fixture_df, device="cpu", batch_rows=512,
                                 scan_batches=1)
    three = tpuprof_torch.describe(fixture_df, device="cpu", batch_rows=512,
                                   scan_batches=3)
    for name, v1 in one["variables"].items():
        v3 = three["variables"][name]
        assert v1.keys() == v3.keys(), name
        for fld, a in v1.items():
            b = v3[fld]
            if fld in ("histogram", "mini_histogram") and a is not None:
                np.testing.assert_array_equal(a[0], b[0])
                np.testing.assert_array_equal(a[1], b[1])
            elif isinstance(a, float) and np.isnan(a):
                assert np.isnan(b), (name, fld)
            else:
                assert a == b, (name, fld)
    np.testing.assert_array_equal(
        one["correlations"]["pearson"].to_numpy(),
        three["correlations"]["pearson"].to_numpy())


def test_single_scan_mode_matches_reference(fixture_df):
    """exact_passes=False: one scan, sample-scaled histograms and sample
    MAD, exactly as the reference derives them from the same sample."""
    ref = TPUStatsBackend().collect(
        fixture_df, RefConfig(backend="tpu", batch_rows=512,
                              exact_passes=False))
    port = tpuprof_torch.describe(fixture_df, device="cpu", batch_rows=512,
                                  exact_passes=False)
    for name, rv in ref["variables"].items():
        pv = port["variables"][name]
        assert pv["type"] == rv["type"], name
        if rv["type"] == ref_schema.NUM:
            np.testing.assert_array_equal(pv["histogram"][0],
                                          rv["histogram"][0], err_msg=name)
            assert pv["mad"] == pytest.approx(rv["mad"], rel=1e-6), name
        if rv["type"] == ref_schema.CAT:
            assert pv["freq"] == rv["freq"], name


def test_columns_projection_and_empty(fixture_df):
    port = tpuprof_torch.describe(fixture_df, device="cpu", batch_rows=512,
                                  columns=["record_id", "fare_amount"])
    assert list(port["variables"]) == ["record_id", "fare_amount"]
    from tpuprof_torch.errors import InputError
    with pytest.raises(InputError):
        tpuprof_torch.describe(fixture_df, device="cpu", columns=["nope"])
    empty = tpuprof_torch.describe(pd.DataFrame(), device="cpu")
    assert empty["table"]["n"] == 0 and schema.validate_stats(empty) == []


def test_default_device_without_cuda_raises(fixture_df, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tpuprof_torch.describe(fixture_df)
    with pytest.raises(RuntimeError, match="CUDA"):
        tpuprof_torch.ProfileReport(fixture_df)


@pytest.mark.parametrize("field,value", [
    ("artifact_keep", 3), ("compile_cache_dir", "/nonexistent/cc"),
    ("unique_partitions", 4), ("elastic", True),
    ("unique_spill_dir", "/nonexistent"), ("exact_distinct", True),
    ("mesh_devices", 2), ("parity", True)])
def test_unported_config_fields_raise(field, value):
    with pytest.raises(NotImplementedError, match=field):
        ProfilerConfig(**{field: value})
    with pytest.raises(NotImplementedError):
        ProfilerConfig.from_kwargs(**{field: value})


@pytest.mark.parametrize("field,value", [
    ("nested", "opaque"), ("prep_workers", 3), ("ingest_retries", 0),
    ("retry_backoff_s", 0.0), ("max_quarantined", 2),
    ("quarantine_log", "quarantine.jsonl"), ("drain_timeout_s", 60.0)])
def test_ported_ingest_fields_run(fixture_df, both, tmp_path, field, value):
    """The fields the ingest slice ports run at a non-default value; on a
    source without nested columns or faults each leaves the result as the
    default gives it, and no quarantine log is written."""
    from tpuprof_torch.report.export import stats_to_json
    if field == "quarantine_log":
        value = str(tmp_path / value)
    port, _ = both
    got = tpuprof_torch.describe(fixture_df, device="cpu", batch_rows=512,
                                 **{field: value})
    assert "_quarantine" not in got
    assert stats_to_json(got) == stats_to_json(port)
    assert not os.path.exists(tmp_path / "quarantine.jsonl")


def test_config_fields_mirror_reference():
    import dataclasses
    ref = {f.name: f.default for f in dataclasses.fields(RefConfig)}
    mine = {f.name: f.default for f in dataclasses.fields(ProfilerConfig)}
    assert mine == ref


def test_port_imports_no_jax_and_no_reference():
    """A describe run in a fresh process, a checkpointed one, a wide one
    (the XLA twin and the exact rank tier), a ``StreamingProfiler``
    checkpointed and restored and a ``resume_profiler`` from a fold-state
    artifact load neither jax nor any module of the reference package."""
    code = textwrap.dedent("""
        import sys
        import numpy as np, pandas as pd
        import tpuprof_torch
        df = pd.DataFrame({"x": np.arange(100.0), "c": ["a", "b"] * 50,
                           "t": pd.date_range("2020-01-01", periods=100)})
        stats = tpuprof_torch.describe(df, device="cpu", batch_rows=32)
        assert stats["table"]["n"] == 100
        df["y"] = np.sqrt(np.arange(100.0))
        stats = tpuprof_torch.describe(df, device="cpu", batch_rows=32,
                                       spearman=True)
        assert "spearman" in stats["correlations"]
        wide = pd.DataFrame(np.random.default_rng(0).normal(size=(40, 520)),
                            columns=[f"w{i}" for i in range(520)])
        stats = tpuprof_torch.describe(wide, device="cpu", batch_rows=64,
                                       spearman=True)
        assert stats["correlations"]["spearman"].shape == (520, 520)
        import os, tempfile
        from tpuprof_torch.artifact import read_artifact, write_artifact
        two = tpuprof_torch.describe(df, device="cpu", batch_rows=32)
        with tempfile.TemporaryDirectory() as tmp:
            art = os.path.join(tmp, "a.json")
            write_artifact(art, stats=two)
            assert read_artifact(art).sketches["bin_seeds"]
            stats = tpuprof_torch.describe(df, device="cpu", batch_rows=32,
                                           profile_passes="fused",
                                           seed_edges=art)
            assert stats["table"]["n"] == 100
            stats = tpuprof_torch.describe(
                df, device="cpu", batch_rows=32,
                checkpoint_path=os.path.join(tmp, "scan.ckpt"),
                checkpoint_every_batches=2)
            assert stats["table"]["n"] == 100
            prof = tpuprof_torch.StreamingProfiler.for_example(
                df, config=tpuprof_torch.ProfilerConfig(batch_rows=32),
                device="cpu")
            prof.update(df.iloc[:60])
            prof.checkpoint(os.path.join(tmp, "s.ckpt"))
            prof = tpuprof_torch.StreamingProfiler.restore(
                os.path.join(tmp, "s.ckpt"), device="cpu")
            prof.update(df.iloc[60:])
            write_artifact(art, profiler=prof)
            prof = tpuprof_torch.resume_profiler(art, device="cpu")
            prof.update(df)
            assert prof.stats()["table"]["n"] == 200
        wider = pd.DataFrame(np.random.default_rng(1).normal(size=(20, 2050)),
                             columns=[f"v{i}" for i in range(2050)])
        stats = tpuprof_torch.describe(wider, device="cpu", batch_rows=32,
                                       spearman=True)
        assert stats["correlations"]["spearman"].shape == (2050, 2050)
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith("jax.")
                     or m == "tpuprof" or m.startswith("tpuprof."))
        print("LOADED", bad)
        sys.exit(1 if bad else 0)
    """)
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "LOADED []" in out.stdout
