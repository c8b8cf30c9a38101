"""Growth weight-matrix paths (ops/growth_device.py) vs the
recurrence-exact host math (hist.py) — the two must agree to ~1e-9
relative, and bit-identically after the TSV writer's floor().

The matmul path is production-reachable: Hist.calc_growth auto-routes
union/core growths through it above GROWTH_MATMUL_MIN_N groups
(tunable via PANACUS_GROWTH_MATMUL_N)."""

import math

import numpy as np
import pytest

from panacus_jax.hist import Hist
from panacus_jax.ops.growth_device import (
    growth_matmul,
    growth_weight_matrix,
)
from panacus_jax.utils import CountType, Threshold


PAIRS = [
    (Threshold.absolute(1), Threshold.rel(0.0)),
    (Threshold.absolute(2), Threshold.rel(0.0)),
    (Threshold.absolute(1), Threshold.rel(1.0)),
    (Threshold.absolute(1), Threshold.rel(0.6)),
    (Threshold.absolute(3), Threshold.rel(0.35)),
]


def test_growth_weight_matrix_matches_exact():
    """Full weight matrix (incl. general quorum) vs the recurrences."""
    rng = np.random.default_rng(5)
    n = 20
    hist = np.zeros(n + 1, dtype=np.int64)
    hist[1:] = rng.integers(0, 100, n)
    h = Hist(CountType.NODE, hist.tolist())
    for cov, q in PAIRS:
        exact = np.array(h.calc_growth(cov, q))
        W = growth_weight_matrix(n, cov, q)
        matmul = W @ hist.astype(np.float64)
        assert np.allclose(matmul, exact, atol=1e-7, rtol=1e-9), (cov, q)


def test_growth_matmul_large_n_floor_parity():
    """Chunked union/core matmul at a production-relevant group count:
    1e-9 relative agreement with the recurrences, floor()-identical."""
    rng = np.random.default_rng(11)
    n = 1500
    hist = np.zeros(n + 1, dtype=np.int64)
    hist[1:] = rng.integers(0, 5000, n)
    h = Hist(CountType.NODE, hist.tolist())
    for cov, q in [
        (Threshold.absolute(1), Threshold.rel(0.0)),
        (Threshold.absolute(3), Threshold.rel(0.0)),
        (Threshold.rel(0.1), Threshold.rel(0.0)),
        (Threshold.absolute(1), Threshold.rel(1.0)),
        (Threshold.absolute(2), Threshold.rel(1.0)),
    ]:
        exact = np.array(h.calc_growth_union(cov))
        if max(1, q.to_absolute(n)) >= n:
            exact = np.array(h.calc_growth_core(cov))
        got = growth_matmul(hist.astype(np.float64), cov, q)
        assert got is not None
        np.testing.assert_allclose(got, exact, rtol=1e-9, atol=1e-6)
        # floor parity, except where the true value IS an integer (both
        # sides then sit an ulp either side of the boundary — e.g. the
        # m=n union value equals the covered-item total exactly)
        for g, e in zip(got, exact):
            if math.floor(g) != math.floor(e):
                assert abs(e - round(e)) < 1e-3, (cov, q, g, e)


def test_growth_matmul_declines_general_quorum():
    hist = np.arange(12, dtype=np.float64)
    assert (
        growth_matmul(hist, Threshold.absolute(1), Threshold.rel(0.5)) is None
    )


def test_calc_growth_auto_routes_above_threshold(monkeypatch):
    """Hist.calc_growth selects the matmul path above the env threshold
    and produces floor-identical results either way."""
    rng = np.random.default_rng(3)
    n = 64
    hist = np.zeros(n + 1, dtype=np.int64)
    hist[1:] = rng.integers(0, 1000, n)
    h = Hist(CountType.NODE, hist.tolist())
    cov, q = Threshold.absolute(1), Threshold.rel(0.0)
    monkeypatch.setenv("PANACUS_GROWTH_MATMUL_N", str(1 << 40))
    via_recurrence = h.calc_growth(cov, q)
    monkeypatch.setenv("PANACUS_GROWTH_MATMUL_N", "8")
    via_matmul = h.calc_growth(cov, q)
    assert [math.floor(x) for x in via_matmul] == [
        math.floor(x) for x in via_recurrence
    ]
    # general quorum still runs (falls back to the recurrence) with the
    # low threshold active
    qq = h.calc_growth(Threshold.absolute(1), Threshold.rel(0.5))
    assert len(qq) == n
