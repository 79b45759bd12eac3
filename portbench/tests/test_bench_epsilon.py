"""The ``epsilon`` cell at a size the CPU holds: its configuration cut to
520 columns (past K1's 512, so pass A takes K3's tier) and 3,000 rows in
batches of 1,024 (the last one partial), run through the harness's real
path (``run.run_cell``).  A sound run is correct; a planted fault is not.
K3's roofline share reads only where K3's launch counter moved, and its
yardstick is pass A's bound, as K1's share has it."""

import importlib

import pytest

from portbench import roofline, run, tracing
from portbench.tests import conftest
from portbench.tests.test_bench_correct import FAULTS

SEED = 2 ** 31 + 2003
COLS = 520


def _cut(config):
    wide = dict(config["columns"][0], count=COLS, shared_columns=COLS // 4)
    config.update(columns=[wide], rows=3000, batch_rows=1024)


@pytest.fixture
def epsilon(monkeypatch):
    """``run_tiny`` builds the cell through ``conftest.tiny``: give it the
    cut above."""
    orig = conftest.tiny

    def tiny(workload):
        bench, spec, config, traffic = orig(workload)
        if spec["config"] == "epsilon":
            _cut(config)
        return bench, spec, config, traffic
    monkeypatch.setattr(conftest, "tiny", tiny)


def test_configuration_and_traffic():
    from tpuprof_torch.kernels import fused
    config = run.load("configs", "epsilon")
    assert config["rows"] == 400000 and config["reduced"] == {}
    assert config["columns"][0]["count"] == 2000
    assert config["columns"][0]["nan_share"] == 0.0
    s = config["columns"][0]["shared_strength"]
    rho = s * s / (1 + s * s)
    assert abs(rho - config["corr_reject"]) >= 0.02
    traffic = run.load("traffic", "describe_wide")
    assert traffic["launches_per_batch"]["fused_wide"] == 1
    assert traffic["launches_per_batch"]["fused_a"] == 0
    assert fused.MAX_FUSED_COLS < COLS <= fused.MAX_FUSED_COLS_WIDE


def test_sound_run_is_correct(epsilon, capsys):
    res = conftest.run_tiny("epsilon.describe", SEED, capsys)
    assert res["correct"] is True, res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 1
    assert res["checks"]["work_missing"]["value"] == 0


@pytest.mark.parametrize("fault", ["half_batch", "answer_altered"])
def test_fault_is_not_correct(fault, epsilon, capsys, monkeypatch):
    from tpuprof_torch.backends import gpu
    from tpuprof_torch.runtime import runner
    FAULTS[fault](monkeypatch, gpu, runner)
    res = conftest.run_tiny("epsilon.describe", SEED, capsys)
    assert res["correct"] is False
    over = [k for k, c in res["checks"].items() if c["value"] > c["limit"]]
    assert over, res["checks"]


def _reader(name):
    return importlib.import_module(f"portbench.metrics.{name}").read


class _Cell:
    def __init__(self, counts):
        self.window_counts = counts
        self.profiles = [{"source": 0}, {"source": 0}]
        self.batches = [[65536] * 6 + [6784]]


def _ctx(counts):
    doc = {"traceEvents": [
        {"cat": "user_annotation", "name": tracing.WINDOW, "ts": 0,
         "dur": 10 ** 6},
        {"cat": "kernel", "name": "void tpt::gram_tc<1>(float const*)",
         "ts": 10, "dur": 60000},
        {"cat": "kernel", "name": "(anonymous namespace)::stats_partial()",
         "ts": 70000, "dur": 2000},
    ]}
    return {"cell": _Cell(counts), "config": run.load("configs", "epsilon"),
            "trace": tracing.summarize(doc)}


def test_wide_roofline_reads_none_without_a_k3_launch():
    read = _reader("pass_a_wide_roofline")
    assert read(_ctx({"fused_wide": 0, "fused_a": 14})) is None
    ctx = _ctx({"fused_wide": 14})
    ctx["trace"] = None
    assert read(ctx) is None


def test_wide_roofline_is_pass_a_bound_over_k3_time():
    got = _reader("pass_a_wide_roofline")(_ctx({"fused_wide": 14}))
    bound_ms = 2 * sum(roofline.pass_a_bound(2000, r)
                       for r in [65536] * 6 + [6784])
    assert got == pytest.approx(100.0 * bound_ms / 1e3 / 0.062)
    # K1's share reads its own counter over the same kernel names
    assert _reader("pass_a_roofline")(_ctx({"fused_wide": 14})) is None


def test_corr_host_s_is_the_mean_span():
    read = _reader("corr_host_s")
    cell = _Cell({})
    cell.profiles = [{"phases": {"corr_host": 1.0}},
                     {"phases": {"corr_host": 3.0}}]
    ctx = {"cell": cell, "traffic": {"profile_passes": "two_pass"}}
    assert read(ctx) == pytest.approx(2.0)
    cell.profiles = [{"phases": {"merge": 1.0}}]
    assert read(ctx) is None
