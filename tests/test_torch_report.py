"""The port's HTML report against the reference's.

The cases of ``tests/test_report.py``, one for one, on
``tpuprof_torch.ProfileReport(df, device="cpu")``; then byte parity: for the
same stats dict and config, ``to_html`` / ``to_standalone_html`` of the port
give exactly the reference's bytes (its ``__version__`` set to the port's),
on the port's stats and on the reference's own; ``svg`` and ``formatters``
on a table of values; the footer from ``_phases``; ``drift_to_html``."""

import math

import jax  # noqa: F401  (JAX stays on the CPU: tests/conftest.py)
import numpy as np
import pandas as pd
import pytest

import tpuprof
import tpuprof_torch
from tpuprof import ProfilerConfig as RefConfig
from tpuprof.artifact.render import drift_to_html as ref_drift_to_html
from tpuprof.backends.tpu import TPUStatsBackend
from tpuprof.report import formatters as ref_formatters
from tpuprof.report import render as ref_render
from tpuprof.report import svg as ref_svg
from tpuprof_torch import ProfileReport, ProfilerConfig
from tpuprof_torch.artifact.render import drift_to_html
from tpuprof_torch.report import formatters, render, svg
from torch_route import same_hash_route  # noqa: F401  (autouse)


@pytest.fixture
def report(taxi_like_df):
    return ProfileReport(taxi_like_df, device="cpu")


@pytest.fixture
def same_version(monkeypatch):
    """The reference renders its own version string; set it to the port's
    so the two renderers' bytes are comparable."""
    monkeypatch.setattr(tpuprof, "__version__", tpuprof_torch.__version__)


# ---- the cases of tests/test_report.py ------------------------------------

def test_html_sections(report):
    html = report.html
    for section in ("Overview", "Variables", "Correlations (Pearson)",
                    "Sample", "Warnings"):
        assert section in html, f"missing section {section!r}"
    for col in report.description["variables"]:
        assert f'id="var-{col}"' in html
    assert "<svg" in html and "base64" not in html


def test_variable_type_badges(report):
    html = report.html
    for badge in ("Numeric", "Categorical", "Boolean", "Date",
                  "Constant", "Unique", "Rejected"):
        assert badge in html


def test_key_values_present(report):
    html = report.html
    v = report.description["variables"]["trip_distance"]
    assert formatters.fmt_value(v["mean"]) in html
    assert formatters.fmt_value(v["max"]) in html
    assert "CMT" in html


def test_to_file_standalone(report, tmp_path):
    out = tmp_path / "report.html"
    report.to_file(str(out))
    page = out.read_text()
    assert page.startswith("<!DOCTYPE html>")
    assert "<style>" in page
    assert "</html>" in page
    assert "http://" not in page.replace("http://www.w3.org", "")
    assert page == render.to_standalone_html(report.description,
                                             report.config)


def test_repr_html_is_cached(report):
    html1 = report._repr_html_()
    html2 = report._repr_html_()
    assert html1 is html2


def test_histogram_svg_shapes():
    counts = np.array([1, 5, 2])
    edges = np.array([0.0, 1.0, 2.0, 3.0])
    full = svg.histogram_svg((counts, edges))
    mini = svg.histogram_svg((counts, edges), mini=True)
    assert full.count("<rect") == 3 and mini.count("<rect") == 3
    assert "hist-label" in full and "hist-label" not in mini
    assert svg.histogram_svg(None) == ""


def test_freq_table_other_row():
    n = 100
    df = pd.DataFrame({
        "c": ["v%d" % (i % 20) for i in range(n)],
        "x": np.arange(n, dtype="float64"),
    })
    r = ProfileReport(df, config=ProfilerConfig(top_freq=5), device="cpu")
    assert "Other values" in r.html
    assert len(r.description["freq"]["c"]) == 5


def test_formatters():
    assert formatters.fmt_percent(0.1234) == "12.3%"
    assert formatters.fmt_bytesize(2048) == "2.0 KiB"
    assert formatters.fmt_number(1234567) == "1,234,567"
    assert formatters.fmt_number(float("inf")) == "∞"
    assert formatters.fmt_number(np.nan) == "NaN"
    assert formatters.fmt_number(0.000123456) == "0.00012346"
    assert formatters.alert_class(0.5, 0.3) == "alert-value"
    assert formatters.alert_class(0.1, 0.3) == ""


def test_empty_frame_renders(same_version):
    df = pd.DataFrame({"x": pd.Series([], dtype="float64")})
    r = ProfileReport(df, device="cpu")
    assert "Overview" in r.html
    assert r.html == ref_render.to_html(r.description, RefConfig())


# ---- byte parity with the reference's renderer ----------------------------

def _both_pages(stats, port_config, ref_config):
    return ((render.to_html(stats, port_config),
             ref_render.to_html(stats, ref_config)),
            (render.to_standalone_html(stats, port_config),
             ref_render.to_standalone_html(stats, ref_config)))


def test_render_parity_on_port_stats(report, same_version):
    """The port's CPU stats of the mixed frame: numeric, categorical, date,
    bool, constant, unique and correlated columns with NaNs, and a footer
    from the port's phase seconds."""
    stats = report.description
    assert stats["_phases"]["scan_a"] > 0
    cfg = dict(missing_threshold=0.05, skewness_threshold=1.0)
    for port_page, ref_page in _both_pages(stats, ProfilerConfig(**cfg),
                                           RefConfig(**cfg)):
        assert port_page == ref_page


@pytest.mark.parametrize("backend", ["oracle", "device"])
def test_render_parity_on_reference_stats(taxi_like_df, backend,
                                          same_version):
    """The reference's own stats: its CPU oracle's (no phases: no footer
    line) and its device backend's on CPU devices (a footer from its
    phases)."""
    if backend == "oracle":
        stats = tpuprof.describe(taxi_like_df, backend="cpu")
    else:
        stats = TPUStatsBackend().collect(
            taxi_like_df, RefConfig(backend="tpu", batch_rows=512))
        assert stats["_phases"]
    for port_page, ref_page in _both_pages(stats, ProfilerConfig(),
                                           RefConfig()):
        assert port_page == ref_page


FORMAT_VALUES = [
    None, 0, 0.0, -0.0, 1, -7, 1234567, 2 ** 60, 0.1234, 0.000123456,
    1e-300, 1e15, 1e16, -2.5e9, float("nan"), float("inf"), float("-inf"),
    np.float32(3.25), np.float64(np.nan), np.int64(-42), True, np.bool_(False),
    1023, 1024, 1025, 1024 ** 2 - 1, 1024 ** 2, 1024 ** 3 * 1.5,
    1024 ** 6 * 3, -2048, "text", pd.Timestamp("2019-01-31 23:59:59.5"),
    np.datetime64("2020-02-29T12:00:00"), pd.NaT, pd.Timedelta("3h 2s"),
    np.timedelta64(90, "s")]


def _outcome(fn, *args):
    """What ``fn(*args)`` returns, or the type of what it raises."""
    try:
        return fn(*args)
    except Exception as exc:                # noqa: BLE001 (compared)
        return type(exc)


@pytest.mark.parametrize("value", FORMAT_VALUES, ids=repr)
def test_formatters_match_reference(value):
    for fn in ("fmt_number", "fmt_value", "fmt_timestamp", "fmt_timedelta"):
        assert _outcome(getattr(formatters, fn), value) == \
            _outcome(getattr(ref_formatters, fn), value), fn
    for fn in ("fmt_percent", "fmt_bytesize"):
        assert _outcome(getattr(formatters, fn), value) == \
            _outcome(getattr(ref_formatters, fn), value), fn
    for name in ("p_missing", "memorysize", "cv", "mean"):
        assert _outcome(formatters.fmt_stat, name, value) == \
            _outcome(ref_formatters.fmt_stat, name, value), name
    for threshold in (0.0, 0.5, 1e6):
        assert formatters.alert_class(value, threshold) == \
            ref_formatters.alert_class(value, threshold)


SVG_CASES = [
    (np.array([1, 5, 2]), np.array([0.0, 1.0, 2.0, 3.0])),
    (np.array([0, 0, 0]), np.array([-1.0, 0.0, 1.0, 2.0])),
    (np.array([7]), np.array([2.5, 2.5])),
    (np.array([3, 0, 1_000_000, 9]), np.array([-1e20, -1.0, 0.0, 1e-7, 1e20])),
    (np.array([], dtype=np.int64), np.array([0.0])),
    None,
]


@pytest.mark.parametrize("hist", SVG_CASES)
def test_svg_matches_reference(hist):
    for mini in (False, True):
        assert svg.histogram_svg(hist, mini=mini) == \
            ref_svg.histogram_svg(hist, mini=mini)
    for frac in (0.0, 0.5, 1.0, 1.5, -0.2, float("nan"), float("inf")):
        assert svg.bar_svg(frac) == ref_svg.bar_svg(frac)
    for rho in (0.0, -0.0, 0.25, -0.999, 1.0, float("nan"), float("-inf")):
        assert svg.corr_cell_style(rho) == ref_svg.corr_cell_style(rho)


def test_footer_from_phases(report, same_version):
    stats = dict(report.description)
    n = stats["table"]["n"]
    stats["_phases"] = {"scan_a": 0.5, "merge": 0.25, "scan_b": 1.5,
                        "render": 3.0}
    line = render._perf_line(stats)
    assert line == (f"{n / 2.0:,.0f} rows/s · merge 0.25s · render 3.00s"
                    " · scan_a 0.50s · scan_b 1.50s")
    assert line == ref_render._perf_line(stats)
    assert line in render.to_html(stats, ProfilerConfig())
    stats["_phases"] = {"merge": 1.0}       # no scan phase: no footer line
    assert render._perf_line(stats) == ""
    stats.pop("_phases")
    assert render._perf_line(stats) == ""
    assert render.to_html(stats, ProfilerConfig()) == \
        ref_render.to_html(stats, RefConfig())


def test_drift_to_html_matches_reference(same_version):
    def col(status, **kw):
        base = {"status": status, "reason": None, "type": "NUM",
                "type_base": "NUM", "psi": 0.31, "ks": 0.12,
                "mean_shift": 1.0, "missing_delta": 0.0,
                "distinct_base": 10, "distinct_current": 12,
                "distinct_ratio": 1.2, "distinct_approx": True,
                "topk_churn": None, "topk_entered": [], "topk_exited": []}
        base.update(kw)
        return base
    drift = {
        "schema": "tpuprof-drift-v1",
        "baseline": {"path": "a.json", "rows": 10, "columns": 3,
                     "degraded": False, "tpuprof_version": "0.1.0"},
        "current": {"path": "b.json", "rows": 12, "columns": 3,
                    "degraded": True, "tpuprof_version": "0.1.0"},
        "summary": {"rows_base": 10, "rows_current": 12, "row_delta": 2,
                    "columns_compared": 4, "columns_added": ["new"],
                    "columns_dropped": ["old"], "types_changed": ["c"],
                    "n_drift": 3, "n_warn": 0, "n_ok": 1,
                    "verdict": "drift"},
        "thresholds": {"psi_warn": 0.1, "psi_drift": 0.25},
        "columns": {
            "x": col("drift"),
            "c": col("drift", reason="type_changed", type="CAT",
                     psi=None, ks=None, topk_churn=0.5,
                     topk_entered=["<b>", 3], topk_exited=[None]),
            "new": col("drift", reason="added", type_base=None),
            "ok": col("ok", psi=math.nan, ks=0.0),
        },
    }
    assert drift_to_html(drift) == ref_drift_to_html(drift)
    assert "&lt;b&gt;" in drift_to_html(drift)
