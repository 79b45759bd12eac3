"""The readers of the program's per-batch spans and thread-seconds, and of
the share of idle time that no span explains: on a hand-made context, on
a hand-made trace, and on a tiny cell's profiles run on the CPU."""

import importlib
import shutil
import tempfile

import pytest

from portbench import tracing
from portbench.tests.conftest import tiny

# metric -> the spans it sums
SPANS = {
    "wait_a_s": ("wait_a",), "wait_b_s": ("wait_b",),
    "fold_host_a_s": ("sampler_a", "hll_host_a", "hostagg_a"),
    "stage_s": ("stage_a", "stage_b"), "launch_s": ("launch_a", "launch_b"),
    "decode_thread_s": ("decode_a", "decode_b"),
    "hash_thread_s": ("hash_a",), "ingest_open_s": ("ingest_open",),
    "assemble_s": ("assemble",),
}


def reader(name):
    return importlib.import_module(f"portbench.metrics.{name}").read


class Profiles:
    def __init__(self, phases):
        self.profiles = [{"phases": p} for p in phases]


def ctx(phases, passes="two_pass", trace=None):
    return {"cell": Profiles(phases), "traffic": {"profile_passes": passes},
            "trace": trace}


@pytest.mark.parametrize("name", sorted(SPANS))
def test_reader_sums_the_mean_of_each_span(name):
    names = SPANS[name]
    phases = [{n: 1.0 + k for k, n in enumerate(names)},
              {n: 3.0 + k for k, n in enumerate(names)}]
    want = sum(2.0 + k for k in range(len(names)))
    assert reader(name)(ctx(phases)) == pytest.approx(want)
    assert reader(name)(ctx([{"scan_a": 1.0}])) is None
    assert reader(name)(ctx(phases, passes="fused")) is None


def test_a_sum_reads_the_spans_a_profile_has():
    assert reader("stage_s")(ctx([{"stage_a": 0.5}])) == 0.5


def ev(cat, name, ts, dur):
    return {"cat": cat, "name": name, "ts": ts, "dur": dur}


def test_idle_unspanned_pct_is_the_unnamed_share_of_idle_time():
    doc = {"traceEvents": [
        ev("user_annotation", tracing.WINDOW, 0, 1000),
        ev("user_annotation", "scan_a", 0, 500),
        ev("user_annotation", "wait_a", 0, 200),
        ev("kernel", "k", 500, 100),
    ]}
    s = tracing.summarize(doc)
    # idle: [0, 200) wait_a, [200, 500) scan_a, [600, 1000) unspanned
    assert reader("idle_unspanned_pct")(ctx([], trace=s)) == \
        pytest.approx(100.0 * 400 / 900)
    assert reader("idle_unspanned_pct")(ctx([])) is None


def test_a_tiny_cell_reads_every_span_metric(capsys):
    import torch

    from portbench.loop import Cell
    _, _, config, traffic = tiny("synth200.describe")
    workdir = tempfile.mkdtemp(prefix="portbench-test-")
    cell = Cell(config, traffic, 2 ** 31 + 19, torch.device("cpu"),
                workdir)
    try:
        cell.setup()
        cell.window(0.5)
    finally:
        cell.close()
        shutil.rmtree(workdir, ignore_errors=True)
    assert cell.profiles and not cell.failed
    c = {"cell": cell, "traffic": traffic, "trace": None}
    for name in SPANS:
        value = reader(name)(c)
        assert value is not None and value > 0, name
