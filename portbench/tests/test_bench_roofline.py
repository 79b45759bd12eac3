"""The copied bounds reproduce PERF.md's figures: K1 0.0491 ms and K2
0.0157 ms at 200 x 65,536, 10 bins; pass A is bound by its operations,
pass B by its bytes."""

import pytest

from portbench import roofline


def test_pass_a_bound_matches_k1():
    ms = roofline.pass_a_bound(200, 65536)
    assert ms == pytest.approx(0.0491, abs=5e-5)
    assert ms > roofline.bytes_ms(roofline.pass_a_bytes(200, 65536))


def test_pass_b_bound_matches_k2_and_is_its_bytes():
    ms = roofline.pass_b_bound(200, 65536, 10)
    assert ms == pytest.approx(0.0157, abs=5e-5)
    assert ms == roofline.bytes_ms(roofline.pass_b_bytes(200, 65536, 10))


def test_fused_bound_is_pass_a_operations():
    assert roofline.pass_ab_bound(200, 65536, 10) == pytest.approx(
        roofline.pass_a_bound(200, 65536))


@pytest.mark.parametrize("rows", [1, 80, 65535, 65536])
def test_bounds_grow_with_rows(rows):
    for fn in (lambda r: roofline.pass_a_bound(15, r),
               lambda r: roofline.pass_b_bound(15, r, 10),
               lambda r: roofline.pass_ab_bound(15, r, 10)):
        assert 0 < fn(rows) <= fn(rows + 1)
