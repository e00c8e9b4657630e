"""The arithmetic of K4's roofline share (``portbench/roofline.py``)."""

import pytest

from portbench import roofline


def test_nearest_neighbor_ops_count_every_valid_pair():
    assert roofline.nearest_neighbor_ops(27201, 27316) == 8 * 27201 * 27316
    assert roofline.nearest_neighbor_ops(0, 27316) == 0


def test_least_time_is_the_tensor_core_bound_at_register_65k():
    # 27201 x 27316 valid points of a 32768-row pair: 6.01 us of bf16
    # tensor-core work, against 0.36 us of bytes.
    least = roofline.nearest_neighbor_least_s(27201, 27316, 32768, 32768)
    assert least == pytest.approx(8 * 27201 * 27316 / 989e12)
    assert least == pytest.approx(6.0105e-6, rel=1e-4)
    assert roofline.nearest_neighbor_bytes(32768, 32768) / 3.35e12 < least


def test_bytes_bound_decides_for_few_valid_points():
    least = roofline.nearest_neighbor_least_s(10, 10, 32768, 32768)
    assert least == roofline.nearest_neighbor_bytes(32768, 32768) / 3.35e12


def test_no_implementation_reads_over_100_percent():
    # At the K4 time of PERF.md's table (0.2906 ms a launch) the share is
    # ~2 %; a kernel would need the card's whole bf16 rate to reach 100 %.
    least = roofline.nearest_neighbor_least_s(27201, 27316, 32768, 32768)
    assert 100 * least / 0.2906e-3 == pytest.approx(2.068, rel=1e-3)
