"""The frozen byte model against hand counts."""

import pytest

from lpbench import roofline


def test_half_bytes_by_hand():
    # y-half over A, 3 x 5 with 7 entries, f32, one member: 7 entries of
    # 4 + 4 bytes, 4 row pointers, x_hat (5), 5 row tensors of 3 rows, and
    # a scalar, a counter and a mask.
    assert roofline.half_bytes(3, 5, 7, "f32", 1, "y") == \
        7 * 8 + 4 * 4 + 5 * 4 + 5 * 3 * 4 + (4 + 4 + 1)
    # x-half over A^T, 5 x 3, f64, 2 members.
    assert roofline.half_bytes(5, 3, 7, "f64", 2, "x") == \
        7 * 12 + 6 * 4 + 2 * 3 * 8 + 7 * 2 * 5 * 8 + 2 * (8 + 4 + 1)


def test_iteration_seconds_bytes_bound():
    m, n, nnz = 4284, 1092610, 11279748
    xb = roofline.half_bytes(n, m, nnz, "f32", 1, "x")
    yb = roofline.half_bytes(m, n, nnz, "f32", 1, "y")
    assert roofline.iteration_seconds(m, n, nnz, "f32") == \
        pytest.approx((xb + yb) / 3.35e12)


def test_operations_bound_where_bytes_are_few():
    # One row of many entries and a huge batch: the multiply-adds set it.
    s = roofline.half_seconds(1, 1, 10**6, "f64", 10**4, "y")
    assert s == pytest.approx((2 * 10**6 * 10**4 + 12 * 10**4) / 34e12)
