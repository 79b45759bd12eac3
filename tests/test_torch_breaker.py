"""The port's circuit breaker (``tpuprof_torch/serve/breaker.py``) against
the reference's (``tpuprof/serve/breaker.py``).

Both breakers are driven through the same sequences of allows, outcomes
and clock steps (a stepped fake ``time.monotonic`` in each module), and
must end in the same states, take the same allow decisions, emit the same
``breaker_transition`` events and count the same
``tpuprof_breaker_transitions_total`` values.  The process-wide default
breaker is reset around every test.
"""

import json

import jax  # noqa: F401  (JAX stays on the CPU: tests/conftest.py)
import pytest

import tpuprof.serve.breaker as ref_breaker
import tpuprof_torch.serve.breaker as port_breaker
from tpuprof import config as ref_config
from tpuprof.obs import events as ref_events
from tpuprof.obs import metrics as ref_metrics
from tpuprof_torch import config as port_config
from tpuprof_torch.obs import events, metrics


class _Clock:
    def __init__(self):
        self.now = 1000.0

    def monotonic(self):
        return self.now


@pytest.fixture(autouse=True)
def clean(monkeypatch):
    for m, ev, br in ((metrics, events, port_breaker),
                      (ref_metrics, ref_events, ref_breaker)):
        m.set_enabled(False)
        m.registry().reset()
        ev.set_sink(None)
        br.reset_default()
    yield
    for m, ev, br in ((metrics, events, port_breaker),
                      (ref_metrics, ref_events, ref_breaker)):
        m.set_enabled(False)
        m.registry().reset()
        ev.set_sink(None)
        br.reset_default()


# (op, key[, seconds]): allow / ok / fail / tick
SEQUENCES = {
    "trip_and_recover": [
        ("fail", "a"), ("allow", "a"), ("fail", "a"), ("fail", "a"),
        ("allow", "a"), ("tick", None, 5.0), ("allow", "a"),
        ("tick", None, 30.0), ("allow", "a"), ("allow", "a"),
        ("ok", "a"), ("allow", "a")],
    "probe_fails_reopens": [
        ("fail", "s"), ("fail", "s"), ("fail", "s"), ("tick", None, 31.0),
        ("allow", "s"), ("fail", "s"), ("allow", "s"),
        ("tick", None, 29.0), ("allow", "s"), ("tick", None, 2.0),
        ("allow", "s"), ("ok", "s")],
    "success_resets_the_count": [
        ("fail", "k"), ("fail", "k"), ("ok", "k"), ("fail", "k"),
        ("fail", "k"), ("allow", "k"), ("fail", "k"), ("allow", "k")],
    "racing_failure_pushes_cooldown": [
        ("fail", "r"), ("fail", "r"), ("fail", "r"), ("tick", None, 20.0),
        ("fail", "r"), ("tick", None, 15.0), ("allow", "r"),
        ("tick", None, 16.0), ("allow", "r")],
    "keys_are_independent": [
        ("fail", "x"), ("fail", "x"), ("fail", "x"), ("allow", "y"),
        ("fail", "y"), ("allow", "x"), ("allow", "y"), ("ok", "y")],
}


def _drive(mod, clock, monkeypatch, seq, threshold=3, cooldown=30.0):
    monkeypatch.setattr(mod, "time", clock)
    b = mod.CircuitBreaker(threshold=threshold, cooldown_s=cooldown)
    trace = []
    for step in seq:
        op, key = step[0], step[1]
        if op == "tick":
            clock.now += step[2]
            continue
        if op == "allow":
            trace.append(("allow", key, b.allow(key)))
        elif op == "ok":
            b.record_success(key)
        else:
            b.record_failure(key)
        trace.append(("state", key, b.state(key)))
    return trace, b.snapshot()


def _events(path):
    with open(path) as fh:
        docs = [json.loads(line) for line in fh]
    return [{k: v for k, v in d.items() if k not in ("ts", "seq", "pid",
                                                      "t", "time")}
            for d in docs if d.get("kind") == "breaker_transition"]


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_same_states_events_and_metrics(name, tmp_path, monkeypatch):
    seq = SEQUENCES[name]
    out = {}
    for tag, mod, m, ev in (("port", port_breaker, metrics, events),
                            ("ref", ref_breaker, ref_metrics, ref_events)):
        m.set_enabled(True)
        path = str(tmp_path / f"{tag}.jsonl")
        ev.set_sink(path)
        trace, snap = _drive(mod, _Clock(), monkeypatch, seq)
        ev.set_sink(None)
        values = {s: m.registry()._instruments[
            "tpuprof_breaker_transitions_total"].value(state=s)
            for s in ("open", "half_open", "closed")}
        out[tag] = (trace, snap, _events(path), values)
        m.set_enabled(False)
    assert out["port"] == out["ref"]
    assert out["port"][2], "the sequence drives at least one transition"


@pytest.mark.parametrize("threshold,cooldown", [(1, 0.0), (2, 5.0),
                                                (5, 1.5)])
def test_thresholds_and_cooldowns(threshold, cooldown, monkeypatch):
    seq = [("fail", "a")] * 6 + [("allow", "a"), ("tick", None, 1.0),
                                 ("allow", "a"), ("tick", None, 5.0),
                                 ("allow", "a"), ("fail", "a"),
                                 ("allow", "a")]
    mine = _drive(port_breaker, _Clock(), monkeypatch, seq, threshold,
                  cooldown)
    ref = _drive(ref_breaker, _Clock(), monkeypatch, seq, threshold,
                 cooldown)
    assert mine == ref


def test_default_breaker_resolves_like_reference(monkeypatch):
    monkeypatch.setenv("TPUPROF_BREAKER_THRESHOLD", "7")
    monkeypatch.setenv("TPUPROF_BREAKER_COOLDOWN_S", "2.5")
    a, b = port_breaker.default_breaker(), ref_breaker.default_breaker()
    assert (a.threshold, a.cooldown_s) == (b.threshold, b.cooldown_s) \
        == (7, 2.5)
    assert port_breaker.default_breaker() is a
    port_breaker.reset_default()
    assert port_breaker.default_breaker() is not a
    for v in (None, 0, 4):
        assert port_config.resolve_breaker_threshold(v) \
            == ref_config.resolve_breaker_threshold(v)
    for v in (None, -1.0, 0.0, 9.5):
        assert port_config.resolve_breaker_cooldown(v) \
            == ref_config.resolve_breaker_cooldown(v)


def test_metrics_off_counts_nothing(monkeypatch):
    b = port_breaker.CircuitBreaker(threshold=1)
    b.record_failure("a")
    assert b.state("a") == "open"
    assert metrics.registry()._instruments[
        "tpuprof_breaker_transitions_total"].value(state="open") == 0
