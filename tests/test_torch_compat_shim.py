"""The port's spark-df-profiling drop-in (``tpuprof_torch.spark_df_profiling``)
against the reference's (``spark_df_profiling``).

The four cases of ``tests/test_compat_shim.py`` on the port with
``device="cpu"``, each against the reference shim on the same numpy-seeded
frame, its engine on JAX's CPU devices (``backend="tpu"``): types, counts,
min/max, histograms and top-k exact, moments at the reference backend
tests' tolerances, rho within 5e-4, the rejected columns equal; the HTML as
``tests/test_torch_report.py`` holds it, byte for byte the reference
renderer's on the same stats (its ``__version__`` set to the port's).
Then what only the port has to show: without a CUDA device and without
``device="cpu"`` the drop-in raises, and importing it loads neither
``jax``, nor the reference, nor the reference's shim.
"""

import importlib
import os
import subprocess
import sys
import textwrap

import jax  # noqa: F401  (JAX stays on the CPU: tests/conftest.py)
import numpy as np
import pandas as pd
import pytest
import torch

import spark_df_profiling as ref_shim
import tpuprof
import tpuprof_torch
from tpuprof import ProfilerConfig as RefConfig
from tpuprof import schema as ref_schema
from tpuprof.report import render as ref_render
from tpuprof_torch import spark_df_profiling
from torch_route import same_hash_route  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = {"device": "cpu"}
REF = {"backend": "tpu"}
# the reference backend tests' moment tolerances (tests/test_tpu_backend.py)
MOMENT_TOL = [("mean", 1e-4), ("std", 1e-3), ("variance", 2e-3),
              ("sum", 1e-4), ("mad", 1e-3), ("skewness", 2e-2),
              ("kurtosis", 5e-2)]
RHO_ATOL = 5e-4


@pytest.fixture
def same_version(monkeypatch):
    """The reference renders its own version string; set it to the port's
    so the two renderers' bytes are comparable."""
    monkeypatch.setattr(tpuprof, "__version__", tpuprof_torch.__version__)


def _assert_stats_match(port, ref):
    assert port["table"]["n"] == ref["table"]["n"]
    assert list(port["variables"]) == list(ref["variables"])
    for name, rv in ref["variables"].items():
        pv = port["variables"][name]
        assert pv["type"] == rv["type"], name
        for fld in ("count", "n_missing", "distinct_count", "is_unique"):
            assert pv[fld] == rv[fld], (name, fld)
        if rv["type"] != ref_schema.NUM:
            continue
        for fld in ("n_zeros", "n_infinite", "min", "max", "p5", "p50",
                    "p95"):
            assert pv[fld] == rv[fld], (name, fld)
        for fld, tol in MOMENT_TOL:
            assert pv[fld] == pytest.approx(rv[fld], rel=tol, abs=1e-6), \
                (name, fld)
        for k in (0, 1):
            np.testing.assert_array_equal(pv["histogram"][k],
                                          rv["histogram"][k], err_msg=name)
    assert set(port["freq"]) == set(ref["freq"])
    for name, rf in ref["freq"].items():
        pd.testing.assert_series_equal(port["freq"][name].sort_index(),
                                       rf.sort_index(), check_names=False)
    pp, rp = port["correlations"]["pearson"], ref["correlations"]["pearson"]
    assert list(pp.index) == list(rp.index)
    np.testing.assert_allclose(pp.to_numpy(), rp.to_numpy(), rtol=0,
                               atol=RHO_ATOL, equal_nan=True)


def test_reference_usage_verbatim(tmp_path, same_version):
    rng = np.random.default_rng(0)
    df = pd.DataFrame({
        "fare": rng.gamma(2.0, 7.5, 500),
        "tip": rng.gamma(1.0, 2.0, 500),
        "vendor": rng.choice(["CMT", "VTS"], 500),
    })
    df["tip2"] = df["tip"] * 1.0000001          # CORR-rejected
    report = spark_df_profiling.ProfileReport(df, bins=10, corr_reject=0.9,
                                              **CPU)
    ref = ref_shim.ProfileReport(df, bins=10, corr_reject=0.9, **REF)
    out = tmp_path / "report.html"
    report.to_file(str(out))
    page = out.read_text()
    assert "vendor" in page and "fare" in page
    assert report.get_rejected_variables(0.9) == ["tip2"] \
        == ref.get_rejected_variables(0.9)
    assert report._repr_html_() == report.html
    _assert_stats_match(report.description, ref.description)
    ref_cfg = RefConfig(bins=10, corr_reject=0.9)
    assert report.html == ref_render.to_html(report.description, ref_cfg)
    assert page == ref_render.to_standalone_html(report.description, ref_cfg)


def test_description_variables_dataframe_idioms():
    """The reference kept description['variables'] as a pandas DataFrame
    indexed by column name; the port's view serves that AND the native
    dict contract from the same object, with the reference shim's
    values."""
    rng = np.random.default_rng(1)
    df = pd.DataFrame({
        "fare": rng.gamma(2.0, 7.5, 300),
        "vendor": rng.choice(["CMT", "VTS"], 300),
    })
    report = spark_df_profiling.ProfileReport(df, **CPU)
    ref = ref_shim.ProfileReport(df, **REF)
    variables = report.description["variables"]
    ref_vars = ref.description["variables"]
    # reference idioms
    assert variables.loc["fare", "mean"] == variables["fare"]["mean"]
    assert variables.loc["fare", "mean"] == pytest.approx(
        ref_vars.loc["fare", "mean"], rel=1e-4)
    assert set(variables.index) == {"fare", "vendor"} == set(ref_vars.index)
    assert "mean" in variables.columns
    rows = dict(variables.iterrows())
    assert rows["fare"]["count"] == 300 == dict(ref_vars.iterrows())[
        "fare"]["count"]
    # native dict contract is untouched
    assert variables["vendor"]["type"] == "CAT" == ref_vars["vendor"]["type"]
    assert set(variables) == {"fare", "vendor"}
    _assert_stats_match(report.description, ref.description)


def test_base_and_formatters_layout():
    from tpuprof_torch.spark_df_profiling import base, formatters

    frame = pd.DataFrame({"x": [1.0, 2.0, 3.0]})
    stats = base.describe(frame, **CPU)
    assert stats["table"]["n"] == 3
    _assert_stats_match(stats, ref_shim.base.describe(frame, **REF))
    assert formatters.fmt_percent(0.125) == "12.5%"
    assert formatters.fmt_bytesize(2048).startswith("2.0")


@pytest.mark.parametrize("value", [0.125, 2048, 1024 ** 3 * 1.5, 7, -0.5,
                                   float("nan")])
def test_formatters_are_the_references(value):
    # the alias module itself (the package's ``formatters`` attribute is
    # the report's module it re-exports, as in the reference's package)
    alias = importlib.import_module(
        "tpuprof_torch.spark_df_profiling.formatters")
    ref_alias = importlib.import_module("spark_df_profiling.formatters")
    assert sorted(alias.__all__) == sorted(ref_alias.__all__)
    for name in alias.__all__:
        if name == "VALUE_FORMATTERS":
            assert set(alias.VALUE_FORMATTERS) \
                == set(ref_alias.VALUE_FORMATTERS)
            continue
        fn, ref_fn = getattr(alias, name), getattr(ref_alias, name)
        args = ("mean", value) if name == "fmt_stat" else \
            (value, 0.5) if name == "alert_class" else (value,)
        assert fn(*args) == ref_fn(*args), (name, value)


def test_base_to_html_and_templates_layout(same_version):
    """base.to_html(sample, stats) and templates.template(name) work from
    the port's shim, as the reference's, and render the reference's
    bytes."""
    from tpuprof_torch.spark_df_profiling import base, templates

    df = pd.DataFrame({"x": [1.0, 2.0, 3.0], "c": ["marker_one",
                                                   "marker_two",
                                                   "marker_three"]})
    stats = base.describe(df, **CPU)
    html = base.to_html(df.head(2), stats)
    assert "var-x" in html and "var-c" in html
    assert "marker_one" in html and "marker_two" in html
    assert base.to_html(None, stats).count("marker_three") > \
        html.count("marker_three")
    assert html == ref_shim.base.to_html(df.head(2), stats)
    assert base.to_html(None, stats) == ref_shim.base.to_html(None, stats)
    tpl = templates.template("row_num")
    assert hasattr(tpl, "render") and tpl.name == "row_num.html"
    page = templates.template("base.html").render(
        title="t", version="v", content="BODY")
    assert page.find("BODY") >= 0
    assert page == ref_shim.templates.template("base.html").render(
        title="t", version="v", content="BODY")
    from tpuprof_torch.report.render import get_env
    assert templates.template("report") is \
        get_env().get_template("report.html")


def test_surface_is_the_references():
    assert sorted(spark_df_profiling.__all__) == sorted(ref_shim.__all__)
    assert spark_df_profiling.ProfileReport is tpuprof_torch.ProfileReport
    assert spark_df_profiling.describe is tpuprof_torch.describe
    assert spark_df_profiling.base.describe is tpuprof_torch.describe
    assert spark_df_profiling.ProfilerConfig is tpuprof_torch.ProfilerConfig
    assert sorted(tpuprof_torch.__all__) == sorted(
        set(tpuprof.__all__) | {"StreamingProfiler", "resume_profiler"})
    assert tpuprof_torch.InputError is tpuprof_torch.errors.InputError


def test_raises_without_a_cuda_device(monkeypatch):
    """Like the port's ProfileReport, the drop-in runs on cuda:0 and never
    falls back to the CPU unless asked."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    df = pd.DataFrame({"x": [1.0, 2.0, 3.0]})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        spark_df_profiling.ProfileReport(df, bins=10, corr_reject=0.9)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        spark_df_profiling.base.describe(df)


def test_import_loads_no_jax_and_no_reference():
    code = textwrap.dedent("""
        import sys
        import pandas as pd
        from tpuprof_torch import spark_df_profiling
        r = spark_df_profiling.ProfileReport(
            pd.DataFrame({"x": [1.0, 2.0, 3.0]}), bins=10, corr_reject=0.9,
            device="cpu")
        assert "var-x" in r.html
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "tpuprof",
                                            "spark_df_profiling"))
        print("LOADED", bad)
        sys.exit(1 if bad else 0)
    """)
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "LOADED []" in out.stdout
