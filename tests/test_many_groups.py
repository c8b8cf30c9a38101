"""Group counts beyond one machine word (n_groups >> 32): multi-word
packing, growth math stability at n=1000."""

import numpy as np

from panacus_jax.hist import Hist
from panacus_jax.ops.engine import CountingEngine
from panacus_jax.utils import CountType, Threshold


def test_thousand_groups_coverage_and_hist():
    rng = np.random.default_rng(123)
    n_groups, n_items = 1000, 500
    # item i is in a random set of groups
    items, gids = [], []
    expected_cov = np.zeros(n_items + 1, dtype=np.int64)
    for i in range(1, n_items + 1):
        k = int(rng.integers(0, 60))
        gs = rng.choice(n_groups, size=k, replace=False)
        expected_cov[i] = k
        items.extend([i] * k)
        gids.extend(gs.tolist())
    e = CountingEngine(n_items, n_groups)
    e.build(np.array(items, dtype=np.int64), np.array(gids, dtype=np.int64))
    assert e.n_words == 32
    cov = e.coverage()
    assert cov[1:].tolist() == expected_cov[1:].tolist()
    w = np.ones(n_items + 1, dtype=np.int32)
    w[0] = 0
    hist = e.hist(w)
    want = np.bincount(expected_cov[1:], minlength=n_groups + 1)
    assert hist.tolist() == want.tolist()


def test_growth_large_n_stability():
    rng = np.random.default_rng(5)
    n = 1000
    coverage = np.zeros(n + 1, dtype=np.int64)
    coverage[1:] = rng.integers(0, 50, n)
    h = Hist(CountType.NODE, coverage.tolist())
    tot = int(coverage[1:].sum())
    union = h.calc_growth_union(Threshold.absolute(1))
    assert len(union) == n
    # monotone nondecreasing, saturating at the union size
    assert all(b >= a - 1e-6 for a, b in zip(union, union[1:]))
    assert abs(union[-1] - tot) < 1e-6
    core = h.calc_growth_core(Threshold.absolute(1))
    assert all(b <= a + 1e-6 for a, b in zip(core, core[1:]))
    assert abs(core[-1] - coverage[n]) < 1e-6
