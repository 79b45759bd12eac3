"""Pass A of the PyTorch port (kernel K1's module) against the reference's
Pallas kernel.

``tpuprof_torch.kernels.fused.update_plain`` — the plain version K1 is held
to on the card — against ``tpuprof.kernels.fused.update(...,
interpret=True)`` on the same numpy inputs, at the reference's own kernel
test shapes, with NaN, +-inf, zeros and invalid padding rows.  Tolerances
are the reference's kernel-vs-twin ones (tests/test_fused.py): counts and
min/max exact, moments rtol 5e-4 / atol 1e-5, rho atol 5e-4.  The K1-vs-
plain tests need the card and skip elsewhere."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuprof.kernels import corr as ref_corr
from tpuprof.kernels import fused as ref_fused
from tpuprof.kernels import moments as ref_moments
from tpuprof_torch.kernels import corr, fused, moments


def _mk_batch(rows, cols, seed=0, scale=10.0, mean=50.0):
    rng = np.random.default_rng(seed)
    x = rng.normal(mean, scale, (rows, cols)).astype(np.float32)
    x[rng.random((rows, cols)) < 0.07] = np.nan
    x[rng.random((rows, cols)) < 0.01] = np.inf
    x[rng.random((rows, cols)) < 0.01] = -np.inf
    x[rng.random((rows, cols)) < 0.03] = 0.0
    rv = np.ones(rows, dtype=bool)
    rv[-max(rows // 10, 1):] = False
    return x, rv


def _ref_init(cols, shift):
    mom = ref_moments.init(cols)
    mom["shift"] = jnp.asarray(shift, dtype=jnp.float32)
    co = ref_corr.init(cols)
    co["shift"] = jnp.asarray(shift, dtype=jnp.float32)
    co["set"] = jnp.ones((), dtype=jnp.int32)
    return mom, co


def _port_init(cols, shift, device="cpu"):
    mom = moments.init(cols, device)
    mom["shift"] = torch.as_tensor(shift, dtype=torch.float32,
                                   device=device)
    co = corr.init(cols, device)
    co["shift"] = mom["shift"].clone()
    co["set"].fill_(1)
    return mom, co


def _assert_states_match(mom_p, co_p, mom_r, co_r):
    fp = moments.finalize(mom_p)
    fr = ref_moments.finalize(jax.device_get(mom_r))
    for k in ("n", "n_zeros", "n_inf", "n_missing", "min", "max", "fmin",
              "fmax"):
        np.testing.assert_array_equal(fp[k], fr[k], err_msg=k)
    for k in ("mean", "variance", "skewness", "kurtosis", "sum"):
        np.testing.assert_allclose(fp[k], fr[k], rtol=5e-4, atol=1e-5,
                                   equal_nan=True, err_msg=k)
    np.testing.assert_array_equal(co_p["N"].numpy(),
                                  np.asarray(co_r["N"]))
    np.testing.assert_allclose(corr.finalize(co_p),
                               ref_corr.finalize(jax.device_get(co_r)),
                               rtol=0, atol=5e-4, equal_nan=True)


@pytest.mark.parametrize("rows,cols", [(256, 3), (1024, 40), (2048, 130)])
def test_plain_matches_pallas_interpret(rows, cols):
    x, rv = _mk_batch(rows, cols)
    shift = np.full(cols, 50.0, dtype=np.float32)
    xt = np.ascontiguousarray(x.T)
    mom_r, co_r = ref_fused.update(*_ref_init(cols, shift), jnp.asarray(xt),
                                   jnp.asarray(rv), interpret=True)
    mom_p, co_p = fused.update_plain(*_port_init(cols, shift),
                                     torch.from_numpy(xt),
                                     torch.from_numpy(rv))
    _assert_states_match(mom_p, co_p, mom_r, co_r)


def test_multi_batch_fold_matches_reference():
    cols = 5
    shift = np.zeros(cols, dtype=np.float32)
    ref = _ref_init(cols, shift)
    port = _port_init(cols, shift)
    for i in range(3):
        x, rv = _mk_batch(512, cols, seed=i, mean=3.0, scale=2.0)
        xt = np.ascontiguousarray(x.T)
        ref = ref_fused.update(*ref, jnp.asarray(xt), jnp.asarray(rv),
                               interpret=True)
        port = fused.update(*port, torch.from_numpy(xt),
                            torch.from_numpy(rv))
    _assert_states_match(port[0], port[1], ref[0], ref[1])


def test_cpu_update_is_the_plain_version():
    x, rv = _mk_batch(300, 7, seed=4)
    xt = torch.from_numpy(np.ascontiguousarray(x.T))
    rvt = torch.from_numpy(rv)
    shift = np.full(7, 50.0, dtype=np.float32)
    a = fused.update(*_port_init(7, shift), xt, rvt)
    b = fused.update_plain(*_port_init(7, shift), xt, rvt)
    for sa, sb in zip(a, b):
        for k in sa:
            assert torch.equal(sa[k], sb[k]), k


def test_empty_batch_keeps_identities():
    xt = torch.empty((4, 0), dtype=torch.float32)
    rv = torch.empty((0,), dtype=torch.bool)
    sums, counts, P, S1, S2, N = fused.tiles_plain(xt, rv, torch.zeros(4))
    assert torch.equal(sums[:, 4], torch.full((4,), float("inf")))
    assert torch.equal(sums[:, 5], torch.full((4,), float("-inf")))
    assert int(counts.sum()) == 0 and int(N.sum()) == 0


@pytest.mark.parametrize("bad", ["dtype", "rv_shape", "shift_shape",
                                 "noncontig", "wide"])
def test_update_rejects_bad_inputs(bad):
    cols, rows = 6, 64
    xt = torch.zeros((cols, rows))
    rv = torch.ones(rows, dtype=torch.bool)
    mom, co = _port_init(cols, np.zeros(cols, dtype=np.float32))
    err = ValueError
    if bad == "dtype":
        xt = xt.double()
    elif bad == "rv_shape":
        rv = rv[:-1]
    elif bad == "shift_shape":
        mom["shift"] = mom["shift"][:-1]
    elif bad == "noncontig":
        xt = torch.zeros((rows, cols)).T
    else:
        cols = fused.MAX_FUSED_COLS_WIDE + 1
        xt = torch.zeros((cols, rows))
        mom, co = _port_init(cols, np.zeros(cols, dtype=np.float32))
    with pytest.raises(err):
        fused.update(mom, co, xt, rv)


@pytest.mark.parametrize("C,R", [(200, 65536), (37, 65536), (512, 65536),
                                 (3, 1000)])
def test_splits_depend_only_on_shape(C, R):
    tile, tr = 64, 32           # gram.cuh's TC_TILE and TC_ROWS
    stat_s, stat_rows, gram_s, gram_rows = fused.splits(C, R, tile, tr)
    assert stat_s * stat_rows >= R > (stat_s - 1) * stat_rows
    assert gram_s * gram_rows >= R > (gram_s - 1) * gram_rows
    assert gram_rows % tr == 0 and gram_rows <= max(1 << 20, tr)
    # one block per tile pair of the upper triangle and split, at most
    # _TARGET_BLOCKS of them
    t = -(-C // tile)
    assert gram_s * t * (t + 1) // 2 <= fused._TARGET_BLOCKS
    assert fused.splits(C, R, tile, tr) == (stat_s, stat_rows, gram_s,
                                            gram_rows)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("kernel K1 runs only on a CUDA device")
    return torch.device("cuda:0")


@pytest.mark.cuda
@pytest.mark.parametrize("rows,cols", [(1000, 3), (65536, 200)])
def test_k1_matches_plain_on_card(cuda_device, rows, cols):
    x, rv = _mk_batch(rows, cols, seed=11)
    xt = torch.from_numpy(np.ascontiguousarray(x.T)).to(cuda_device)
    rvt = torch.from_numpy(rv).to(cuda_device)
    shift = torch.full((cols,), 50.0, device=cuda_device)
    got = fused.tiles_cuda(xt, rvt, shift)
    again = fused.tiles_cuda(xt, rvt, shift)
    ref = fused.tiles_plain(xt, rvt, shift)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert torch.equal(got[1], ref[1]) and torch.equal(got[5], ref[5])
    assert torch.equal(got[0][:, 4:], ref[0][:, 4:])
