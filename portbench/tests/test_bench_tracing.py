"""The trace reduction on a hand-made Chrome trace."""

import pytest

from portbench import tracing


def ev(cat, name, ts, dur, **args):
    return {"cat": cat, "name": name, "ts": ts, "dur": dur, "args": args}


def test_summarize_union_idle_and_copies():
    doc = {"traceEvents": [
        ev("user_annotation", tracing.WINDOW, 0, 1000),
        ev("user_annotation", "scan_a", 0, 600),
        ev("user_annotation", "scan_b", 600, 400),
        ev("kernel", "void tpt::gram_tc<64>(float const*)", 100, 100),
        ev("kernel", "(anonymous namespace)::hist_partial(float*)", 150,
           100),
        ev("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", 700, 50,
           bytes=5000),
        ev("kernel", "outside", 2000, 10),
    ]}
    s = tracing.summarize(doc)
    assert s["window_s"] == pytest.approx(1e-3)
    assert s["busy_s"] == pytest.approx(200e-6)       # [100, 250] + [700, 750]
    assert s["kernels"]["gram_tc"] == (1, pytest.approx(1e-4))
    assert s["kernels"]["hist_partial"] == (1, pytest.approx(1e-4))
    assert s["h2d_bytes"] == 5000 and s["h2d_s"] == pytest.approx(5e-5)
    gaps = dict(s["idle_gaps"])
    # [0, 100) and [250, 600) in scan_a; [600, 700) and [750, 1000) in scan_b
    assert gaps["scan_a"] == pytest.approx(450e-6)
    assert gaps["scan_b"] == pytest.approx(350e-6)


def test_summarize_needs_one_window():
    with pytest.raises(ValueError):
        tracing.summarize({"traceEvents": []})
