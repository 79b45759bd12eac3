"""The hashing route of the port against the reference's.

Contract: each package hashes for HLL, the top-k store and the duplicate
tracker through its C++ library ("native") or through its numpy/pandas
fallback.  The two routes are two hash families: one value hashes
differently on each.  So a pair of packages on one route, (native, native)
or (fallback, fallback), gives the same ``distinct_count`` and top-k for
every column, and a mixed pair may differ in every HLL-derived count and is
never compared (``tests/torch_route.py`` holds the comparison tests to one
route).
"""

import jax  # noqa: F401  (JAX stays on the CPU: tests/conftest.py)
import numpy as np
import pandas as pd
import pytest

import tpuprof_torch
from tpuprof import ProfilerConfig as RefConfig
from tpuprof import native as ref_native
from tpuprof.backends.tpu import TPUStatsBackend
from tpuprof_torch import native as port_native

BATCH = 512


def _frame(seed=21, n=6000):
    """Numeric, integer and string columns whose distinct counts come from
    HLL (past the top-k capacity the tests set) and from the top-k store."""
    rng = np.random.default_rng(seed)
    df = pd.DataFrame({
        "amount": rng.gamma(2.0, 7.5, n),
        "qty": rng.integers(0, 5000, n).astype(np.int64),
        "small": rng.integers(0, 7, n).astype(np.int64),
        "sku": [f"sku_{v:05d}" for v in rng.integers(0, 3000, n)],
        "city": rng.choice(["ams", "ber", "cph", "dub"], n),
    })
    df.loc[rng.choice(n, 300, replace=False), "amount"] = np.nan
    df.loc[rng.choice(n, 200, replace=False), "sku"] = None
    return df


@pytest.mark.parametrize("route", ["native", "fallback"])
def test_one_route_gives_the_reference_counts(route, monkeypatch):
    mods = (ref_native, port_native)
    if route == "native":
        for mod in mods:
            if not mod.available():
                # a first load that lost a race with a concurrent build:
                # the library is there by now, load it again
                monkeypatch.setattr(mod, "_tried", False)
        assert all(mod.available() for mod in mods)
    else:
        for mod in mods:
            monkeypatch.setattr(mod, "_tried", True)
            monkeypatch.setattr(mod, "_lib", None)
        assert not any(mod.available() for mod in mods)
    df = _frame()
    ref = TPUStatsBackend().collect(
        df, RefConfig(backend="tpu", batch_rows=BATCH, topk_capacity=256))
    port = tpuprof_torch.describe(df, device="cpu", batch_rows=BATCH,
                                  topk_capacity=256)
    approx = set()
    for name, rv in ref["variables"].items():
        pv = port["variables"][name]
        for fld in ("type", "distinct_count", "distinct_approx",
                    "is_unique"):
            assert pv[fld] == rv[fld], (route, name, fld)
        if rv["distinct_approx"]:
            approx.add(name)
    # the HLL tier is what the routes change: the frame must reach it
    assert {"amount", "qty", "sku"} <= approx
    assert set(port["freq"]) == set(ref["freq"])
    for name, rf in ref["freq"].items():
        pd.testing.assert_series_equal(port["freq"][name].sort_index(),
                                       rf.sort_index(), check_names=False)
