"""Byte counts for shapes worked by hand."""
import pytest

import _helpers  # noqa: F401
from bench.yardstick import peaks, traffic


def test_stencil5_bytes():
    # 5 planes + x read, y written, per lane, 8-byte words
    assert traffic.stencil5_bytes(1_000_000) == 56_000_000
    assert traffic.stencil5_bytes(1_000_000, lanes=8) == 448_000_000
    assert traffic.stencil5_bytes(4, lanes=2, itemsize=4) == 7 * 4 * 2 * 4


@pytest.mark.parametrize("body, words", [
    ("fused_cg_update", 8), ("fused_cg_direction", 6),
    ("fused_cg_halfstep", 6), ("fused_cheb_step", 5), ("fused_dots2", 2),
    ("fused_bicg_p", 6), ("fused_bicg_s", 5), ("fused_bicg_tail", 8)])
def test_body_bytes(body, words):
    assert traffic.body_bytes(body, 1000) == words * 1000 * 8
    assert traffic.body_bytes(body, 1000, lanes=16) == words * 16000 * 8


def test_operator_nnz():
    # ng = 3: 9 centres, 12 interior faces counted twice
    assert traffic.operator_nnz(3) == 9 + 24
    assert traffic.operator_nnz(1000) == 4_996_000


def test_matrix_and_iteration_bytes():
    assert traffic.matrix_bytes("stencil", 1000) == 40_000_000
    # CSR: (value 8 + column 4) a nonzero, (n + 1) int32 row pointers
    assert traffic.matrix_bytes("coo", 1000) == \
        4_996_000 * 12 + 1_000_001 * 4
    assert traffic.pcg_iteration_bytes("stencil", 1000) == \
        40_000_000 + 6 * 8_000_000
    assert traffic.pcg_iteration_bytes("coo", 10, itemsize=4) == \
        traffic.operator_nnz(10) * 8 + 101 * 4 + 6 * 100 * 4
    with pytest.raises(ValueError):
        traffic.matrix_bytes("bell", 10)


def test_roofline_share():
    assert traffic.roofline_share(3.35e12, 1.0,
                                  peaks.HBM_BYTES_PER_S) == pytest.approx(100)
    assert traffic.roofline_share(1e9, 1e-3, 2e12) == pytest.approx(50)
