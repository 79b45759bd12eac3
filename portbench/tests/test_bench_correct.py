"""``correct`` on the CPU, through the harness's real path at a tiny size:
a sound run passes; the control (the reference in bfloat16, put in the
program's place) and each fault a cell can have, planted in the timed
path underneath, fail.  The faults: a step that returns its state
unchanged; half of each batch left out, the statistics taken over the
rest; an answer altered where it is produced; an answer without its
histograms.  (One card: no exchange between chips to leave out.)"""

import pytest

from portbench import compare
from portbench.reference.stats import reference
from portbench.tests.conftest import run_tiny, tiny

# nyctaxi2019.describe is not in BENCHMARK.json (PERF.md, Open
# questions); its files stay, and stay correct
CELLS = ["synth200.describe", "nyctaxi2019.describe", "synth200.fused_warm",
         "synth200.serve"]
SEED = 2 ** 31 + 77


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell, capsys):
    res = run_tiny(cell, SEED, capsys)
    assert res["failed"] == 0 and res["attempted"] >= 1
    checks = res["checks"]
    assert checks["mismatches"]["value"] == 0
    assert checks["work_missing"]["value"] == 0
    for k, c in checks.items():
        if k != "hist_moved":   # one edge value is a share of 1/8,192 here
            assert c["value"] <= c["limit"], (k, c)


@pytest.mark.parametrize("name", ["synth200", "nyctaxi2019"])
def test_control_is_not_correct(name):
    from portbench.data import make_table
    _, _, config, _ = tiny(f"{name}.describe")
    failing = set()
    for seed in (11, 12, 13):
        df = make_table(config, config["rows"], seed)
        ref = reference(df, config["bins"], config["corr_reject"])
        low = reference(df, config["bins"], config["corr_reject"],
                        round_to="bfloat16")
        nums, _ = compare.numbers(low, ref)
        limits = config["limits"]
        over = {k for k, v in nums.items()
                if k in limits and v is not None and v > limits[k]}
        assert over, nums
        failing |= over
    assert "mismatches" in failing


def unchanged_b(self, state, *args, **kwargs):
    return state


def unchanged_ab(self, state, state_h, *args, **kwargs):
    return state, state_h


def half_batch(orig):
    def fold(self, state, xt, row_valid, hllt):
        rv = row_valid.clone()
        rv[rv.shape[0] // 2:] = 0
        return orig(self, state, xt, rv, hllt)
    return fold


def altered(orig):
    def stats(*args, **kwargs):
        out = orig(*args, **kwargs)
        out["mean"] = out["mean"] * (1 + 1e-4) + 1e-4
        return out
    return stats


def no_histogram(orig):
    def stats(*args, **kwargs):
        out = orig(*args, **kwargs)
        out["histogram"] = out["mini_histogram"] = None
        return out
    return stats


FAULTS = {
    "state_unchanged": lambda mp, gpu, runner: (
        mp.setattr(runner.Runner, "_fold_b", unchanged_b),
        mp.setattr(runner.Runner, "_fold_ab", unchanged_ab)),
    "half_batch": lambda mp, gpu, runner: mp.setattr(
        runner.Runner, "_fold_a", half_batch(runner.Runner._fold_a)),
    "answer_altered": lambda mp, gpu, runner: mp.setattr(
        gpu, "_numeric_stats", altered(gpu._numeric_stats)),
    "histograms_dropped": lambda mp, gpu, runner: mp.setattr(
        gpu, "_numeric_stats", no_histogram(gpu._numeric_stats)),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_not_correct(cell, fault, capsys, monkeypatch):
    from tpuprof_torch.backends import gpu
    from tpuprof_torch.runtime import runner
    FAULTS[fault](monkeypatch, gpu, runner)
    res = run_tiny(cell, SEED, capsys)
    assert res["correct"] is False
    over = [k for k, c in res["checks"].items() if c["value"] > c["limit"]]
    assert over or res["failed"], res["checks"]


def _sound(name):
    from portbench.data import make_table
    _, _, config, _ = tiny(f"{name}.describe")
    df = make_table(config, config["rows"], 5)
    return config, reference(df, config["bins"], config["corr_reject"])


@pytest.mark.parametrize("name", ["synth200", "nyctaxi2019"])
def test_answer_without_histograms_is_a_mismatch(name):
    _, ref = _sound(name)
    got = {**ref, "columns": {c: {k: v for k, v in f.items()
                                  if k != "histogram"}
                              for c, f in ref["columns"].items()}}
    nums, bad = compare.numbers(got, ref)
    lanes = sum(f["type"] == "NUM" for f in ref["columns"].values())
    assert lanes and nums["mismatches"] == lanes
    assert all("no histogram" in b for b in bad)


@pytest.mark.parametrize("name", ["synth200", "nyctaxi2019"])
def test_answer_without_a_pearson_column_is_a_mismatch(name):
    _, ref = _sound(name)
    names, rho = ref["rho"]
    assert len(names) >= 2
    got = {**ref, "rho": (names[1:], rho[1:, 1:])}
    nums, bad = compare.numbers(got, ref)
    assert nums["mismatches"] == 1 and "Pearson" in bad[0]
    nums, _ = compare.numbers({**ref, "rho": ([], rho[:0, :0])}, ref)
    assert nums["mismatches"] == len(names)


def test_a_limited_number_without_a_reading_fails(monkeypatch, capsys):
    from portbench import compare as cmp
    real = cmp.worst
    monkeypatch.setattr(cmp, "worst", lambda per: {
        **real(per), "hist_moved": None})
    res = run_tiny("synth200.describe", SEED, capsys)
    assert res["correct"] is False
    assert res["checks"]["hist_moved"]["value"] is None
