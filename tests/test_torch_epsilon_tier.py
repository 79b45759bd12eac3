"""A dense wide table in the K3 tier (``portbench/configs/epsilon.json``
cut to 520 columns x 3,000 rows) through ``tpuprof_torch.describe`` on the
CPU, against the benchmark's plain reference (``portbench/reference``)
through its comparison (``portbench/compare.py``), at the epsilon
configuration's limits.

520 numeric columns are past K1's 512, so pass A takes K3's tier; batches
of 1,024 rows leave the last one partial.  The correlated block's
coefficients (rho = 16/17) lie above ``corr_reject``, so the rejection
scan rejects all but the block's first column, as the reference does.  The
profile records the quiet span ``corr_host`` (the Pearson matrix's host
work)."""

import json
import os

import pytest

import tpuprof_torch
from portbench import compare, data
from portbench.reference.stats import reference
from tpuprof_torch import schema
from tpuprof_torch.kernels import fused

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COLS, ROWS, BATCH, BLOCK = 520, 3000, 1024, 24


def _config(nan_share):
    with open(os.path.join(ROOT, "portbench", "configs",
                           "epsilon.json")) as fh:
        config = json.load(fh)
    wide = dict(config["columns"][0], count=COLS, nan_share=nan_share,
                shared_columns=BLOCK, shared_strength=4.0)
    return dict(config, columns=[wide], rows=ROWS, batch_rows=BATCH)


@pytest.mark.parametrize("nan_share", [0.0, 0.02])
def test_k3_tier_matches_the_reference(nan_share):
    assert fused.MAX_FUSED_COLS < COLS <= fused.MAX_FUSED_COLS_WIDE
    config = _config(nan_share)
    df = data.make_table(config, ROWS, 2 ** 31 + 21)
    stats = tpuprof_torch.describe(
        df, device="cpu", bins=config["bins"],
        corr_reject=config["corr_reject"], batch_rows=BATCH,
        profile_passes="two_pass")
    ref = reference(df, config["bins"], config["corr_reject"])
    nums, bad = compare.numbers(compare.program_view(stats), ref)
    assert not bad, bad
    for k, limit in config["limits"].items():
        assert nums[k] is not None and nums[k] <= limit, (k, nums[k], limit)
    rejected = sorted(c for c, f in ref["columns"].items()
                      if f["type"] == "CORR")
    assert len(rejected) == BLOCK - 1
    assert sorted(schema.rejected_variables(stats)) == rejected
    assert stats["_phases"]["corr_host"] > 0
