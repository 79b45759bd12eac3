"""``TPUPROF_PASS_B_KERNEL`` on the port, against the reference.

The port resolves the pass-B formulation as the reference does
(``resolve_pass_b_kernel``: the config value, else the variable, else
``cumulative``; a bad value raises ``ValueError`` naming its origin), and
reads it where the reference does: when a runner is built, in the
runner-cache key and in the store's manifest.  Both names give the same
counts, so what is held here is the resolution, the error and the keys.
"""

import jax  # noqa: F401  (JAX stays on the CPU: tests/conftest.py)
import numpy as np
import pytest

from tpuprof import config as ref_config
from tpuprof.config import ProfilerConfig as RefConfig
from tpuprof.runtime.mesh import MeshRunner as RefMeshRunner
from tpuprof.serve import cache as ref_cache
from tpuprof_torch import config
from tpuprof_torch.config import ProfilerConfig
from tpuprof_torch.runtime.aot import AotStore
from tpuprof_torch.runtime.runner import Runner
from tpuprof_torch.serve import cache

VAR = "TPUPROF_PASS_B_KERNEL"

# (explicit value, the variable or None, the result or None: raises)
SCENARIOS = [
    (None, None, "cumulative"),
    ("legacy", None, "legacy"),
    (None, "legacy", "legacy"),
    ("cumulative", "legacy", "cumulative"),     # explicit beats the env
    ("legacy", "sideways", "legacy"),           # a set value never reads it
    (None, "sideways", None),
    ("sideways", None, None),
    (None, "", "cumulative"),                   # empty is unset
]


@pytest.mark.parametrize("value,env,want", SCENARIOS)
def test_resolve_pass_b_kernel_like_reference(monkeypatch, value, env, want):
    monkeypatch.delenv(VAR, raising=False)
    if env is not None:
        monkeypatch.setenv(VAR, env)
    if want is None:
        with pytest.raises(ValueError) as ref_exc:
            ref_config.resolve_pass_b_kernel(value)
        with pytest.raises(ValueError) as exc:
            config.resolve_pass_b_kernel(value)
        assert str(exc.value) == str(ref_exc.value)
        assert (VAR if value is None else "pass_b_kernel") in str(exc.value)
        return
    assert ref_config.resolve_pass_b_kernel(value) == want
    assert config.resolve_pass_b_kernel(value) == want
    assert ProfilerConfig(pass_b_kernel=value).pass_b == want


def test_pass_b_kernel_env_resolves_into_key(monkeypatch):
    """The reference's ``test_pass_b_kernel_env_resolves_into_key``
    through both packages: flipping the variable changes the key."""
    monkeypatch.delenv(VAR, raising=False)
    mine, ref = ProfilerConfig(batch_rows=1024), RefConfig(batch_rows=1024)
    k1 = cache.runner_key(mine, 3, 0, devices=["cpu"])
    r1 = ref_cache.runner_key(ref, 3, 0)
    monkeypatch.setenv(VAR, "legacy")
    k2 = cache.runner_key(mine, 3, 0, devices=["cpu"])
    r2 = ref_cache.runner_key(ref, 3, 0)
    assert r1 != r2 and k1 != k2
    assert "cumulative" in k1 and "legacy" in k2
    # an explicit value is keyed over the variable, in both
    assert cache.runner_key(ProfilerConfig(batch_rows=1024,
                                           pass_b_kernel="cumulative"),
                            3, 0, devices=["cpu"]) == k1


def test_bogus_variable_raises_where_a_runner_is_built(monkeypatch):
    monkeypatch.setenv(VAR, "bogus")
    with pytest.raises(ValueError, match=VAR):
        RefMeshRunner(RefConfig(batch_rows=64), n_num=2, n_hash=0)
    with pytest.raises(ValueError, match=VAR):
        Runner(ProfilerConfig(batch_rows=64), 2, 0, device="cpu")
    with pytest.raises(ValueError, match=VAR):
        cache.runner_key(ProfilerConfig(), 2, 0, devices=["cpu"])
    # an explicit value never reads the variable
    r = Runner(ProfilerConfig(batch_rows=64, pass_b_kernel="legacy"), 2, 0,
               device="cpu")
    assert r.pass_b_kernel == "legacy"


def test_runner_and_store_record_the_resolved_name(monkeypatch, tmp_path):
    monkeypatch.setenv(VAR, "legacy")
    cfg = ProfilerConfig(batch_rows=64)
    assert Runner(cfg, 2, 0, device="cpu").pass_b_kernel == "legacy"
    store = AotStore(str(tmp_path), [("cpu", None)])
    key = cache.runner_key(cfg, 2, 0, devices=["cpu"])
    store.touch_manifest(key, cfg, 2, 0)
    rows = list(store.read_manifest()["entries"].values())
    assert [r["config"]["pass_b_kernel"] for r in rows] == ["legacy"]


def test_both_names_count_the_same(monkeypatch):
    """The variable changes the name a runner carries, not its counts."""
    from tpuprof_torch.kernels import hist
    import torch
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(3, 500)).astype(np.float32))
    rv = torch.ones(500, dtype=torch.bool)
    lo, hi, mean = x.amin(1), x.amax(1), x.mean(1)
    got = {}
    for name in hist.KERNELS:
        monkeypatch.setenv(VAR, name)
        kernel = Runner(ProfilerConfig(batch_rows=500), 3, 0,
                        device="cpu").pass_b_kernel
        assert kernel == name
        got[name] = hist.histogram_batch(x, rv, lo, hi, mean, 16,
                                         kernel=kernel)
    assert torch.equal(got["cumulative"][0], got["legacy"][0])
    assert torch.equal(got["cumulative"][1], got["legacy"][1])
