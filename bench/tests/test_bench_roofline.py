"""The yardstick's counts for penguin and Art, worked by hand."""
import pytest

from bench import roofline


def test_penguin_halfstep_by_hand():
    # 16 x 500 x 333 labels of a byte read; unary 500*333*2 floats; the
    # 2 x 2 table; the larger parity (83,250 sites a chain) written
    nbytes = 2_664_000 + 1_332_000 + 16 + 16 * 83_250
    assert roofline.halfstep_bytes(16, 500, 333, 2) == nbytes == 5_328_016
    ops = 16 * 83_250 * 2 * 5 + 3_000_000 * 2
    assert roofline.halfstep_ops(16, 500, 333, 2, 3_000_000) == ops
    assert roofline.halfstep_least_time_s(16, 500, 333, 2, 3e6) == \
        pytest.approx(5_328_016 / 3.35e12)


def test_art_halfstep_by_hand():
    sites = 288 * 384                       # 110,592, even: 55,296 a parity
    nbytes = 16 * sites + sites * 16 * 4 + 16 * 16 * 4 + 16 * 55_296
    assert roofline.halfstep_bytes(16, 288, 384, 16) == nbytes == 9_733_120
    ops = 16 * 55_296 * 16 * 5
    assert roofline.halfstep_ops(16, 288, 384, 16, 0) == ops
    # bytes bound: 2.9 us; operations at 67 TFLOP/s far below it
    assert roofline.halfstep_least_time_s(16, 288, 384, 16, 5e6) == \
        pytest.approx(9_733_120 / 3.35e12)


def test_operations_bound_when_bits_dominate():
    t = roofline.halfstep_least_time_s(1, 2, 2, 2, 1e12)
    assert t == pytest.approx((1 * 2 * 2 * 5 + 2e12) / 67e12)
