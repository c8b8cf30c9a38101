"""Golden-value parity tests for the growth math core
(anchors from reference src/graph_broker/hist.rs:325-400)."""

import math

import numpy as np
import pytest

from panacus_jax.hist import Hist, choose_log2
from panacus_jax.utils import CountType, Threshold, ThresholdContainer


def assert_almost_eq(a, b, eps=1e-10):
    assert abs(a - b) <= eps, f"{a} vs {b}"


def factorial(n):
    return math.factorial(n)


def test_choose_function():
    assert_almost_eq(choose_log2(5, 0), 0.0)
    assert_almost_eq(choose_log2(5, 5), 0.0)
    assert_almost_eq(choose_log2(5, 1), math.log2(5.0))
    assert_almost_eq(choose_log2(5, 4), math.log2(5.0))
    expected = math.log2(factorial(5) / (factorial(2) * factorial(3)))
    assert_almost_eq(choose_log2(5, 2), expected)
    assert choose_log2(5, 6) == 0.0


def test_growth_union():
    hist = Hist(CountType.NODE, [0, 5, 3, 2])
    expected = [5.666666666666667, 8.333333333333334, 10.0]
    got = hist.calc_growth_union(Threshold.absolute(0))
    for g, e in zip(got, expected):
        assert_almost_eq(g, e)


def test_growth_core():
    hist = Hist(CountType.NODE, [0, 5, 3, 2])
    expected = [5.666666666666666, 3.0, 2.0]
    got = hist.calc_growth_core(Threshold.absolute(0))
    for g, e in zip(got, expected):
        assert_almost_eq(g, e)


def test_growth_quorum():
    hist = Hist(CountType.NODE, [0, 5, 3, 2, 3, 5, 0, 4, 2, 1])
    expected = [
        11.88888888888889,
        7.027777777777777,
        4.761904761904761,
        3.4444444444444438,
        2.5952380952380953,
        2.0,
        1.5555555555555545,
        1.2222222222222217,
        1.0,
    ]
    got = hist.calc_growth_quorum(Threshold.absolute(0), Threshold.rel(0.9))
    for g, e in zip(got, expected):
        assert_almost_eq(g, e)


def test_calc_growth_dispatch():
    hist = Hist(CountType.NODE, [0, 5, 3, 2])
    union = hist.calc_growth(Threshold.absolute(1), Threshold.rel(0.0))
    assert_almost_eq(union[-1], 10.0)
    core = hist.calc_growth(Threshold.absolute(1), Threshold.rel(1.0))
    assert_almost_eq(core[-1], 2.0)


def test_threshold_container_broadcast():
    tc = ThresholdContainer.parse_params("0,0.5,1.0", "1")
    assert len(tc.coverage) == 3
    assert len(tc.quorum) == 3
    with pytest.raises(ValueError):
        ThresholdContainer.parse_params("0,0.5", "1,2,3")
    with pytest.raises(ValueError):
        ThresholdContainer.parse_params("", "1")
    # coverage must be integer
    with pytest.raises(ValueError):
        ThresholdContainer.parse_params("0", "0.5")


def test_quorum_matches_bruteforce():
    """Cross-check the quorum formula against exhaustive subset enumeration."""
    import itertools

    rng = np.random.default_rng(0)
    n = 6
    # random item -> subset-of-groups instance
    n_items = 40
    memberships = [
        set(rng.choice(n, size=rng.integers(1, n + 1), replace=False))
        for _ in range(n_items)
    ]
    hist = np.zeros(n + 1, dtype=int)
    for m in memberships:
        hist[len(m)] += 1
    h = Hist(CountType.NODE, hist.tolist())
    quorum = 0.6
    got = h.calc_growth_quorum(Threshold.absolute(0), Threshold.rel(quorum))
    for m in range(1, n + 1):
        m_quorum = math.ceil(m * quorum)
        tot = 0.0
        cnt = 0
        for subset in itertools.combinations(range(n), m):
            cnt += 1
            s = set(subset)
            tot += sum(
                1 for mem in memberships if len(mem & s) >= max(m_quorum, 1)
            )
        assert_almost_eq(got[m - 1], tot / cnt, eps=1e-8)
