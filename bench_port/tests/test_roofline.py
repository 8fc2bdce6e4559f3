"""The operation and byte counters against the kernels' headers' counts
(52 a band cell, 232 a move, 26 + 4 (w - 1) a position), on shapes worked
out by hand."""
import pytest

from bench_port import roofline as RL


def test_align_banded():
    # 2 jobs, rows of 4, band 3, reads of 4 and 2 bases: 6 rows.
    ops, nbytes = RL.align_banded(2, 4, 3, 6)
    assert ops == 6 * 3 * 52
    assert nbytes == 2 * 4 + 2 * 4 + 2 * 7 + 20 + 2 * 29


def test_anneal_chains():
    ops, nbytes = RL.anneal_chains(1000, C=3, R=5, W=7, moves=100)
    assert ops == 100 * 232 + 3 * (7 + 5)
    assert nbytes == 1000 + 12 + 60 + 12


@pytest.mark.parametrize("S,cols_bytes", [(None, 2 * 186 * 6),
                                          (80, 2 * 80 * 6 + 8)])
def test_minimizer_front(S, cols_bytes):
    ops, nbytes = RL.minimizer_front(2, 200, 15, 10, S)
    assert ops == 2 * 186 * (26 + 4 * 9)
    assert nbytes == 400 + cols_bytes


def test_bound_names_the_peak():
    t, by = RL.bound_s(67e12, 1.0)
    assert by == "operations" and t == pytest.approx(1.0)
    t, by = RL.bound_s(1.0, 3.35e12)
    assert by == "bytes" and t == pytest.approx(1.0)
