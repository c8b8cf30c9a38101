"""Differential oracle for the growth math core: exhaustive enumeration
over all m-subsets of groups on random membership matrices, checked
against the log2-domain recurrences (reference semantics:
src/graph_broker/hist.rs:51-187).

The oracle counts items directly from subset-membership, fully
independent of the binomial-weight formulation:
- union (effective quorum 1):   item counts at m iff it appears in >= 1
  chosen group AND its global coverage i >= max(1, c)      (hist.rs:89-113)
- core (effective quorum >= n): item counts iff it appears in ALL m
  chosen groups AND i >= max(1, c_over_n_plus_1)           (hist.rs:116-138,
  note the reference computes c via to_absolute(n + 1) here)
- general quorum: with X = #chosen groups containing the item and
  m_quorum = ceil(m * quorum): counts iff X == m and i >= max(m, c)
  (the yl term) or max(m_quorum, c) <= X < m (the yr term — the coverage
  threshold applies to the WITHIN-SUBSET count here)       (hist.rs:140-187)
"""

import itertools
import math

import numpy as np

from panacus_jax.hist import Hist
from panacus_jax.utils import CountType, Threshold


def oracle_growth(member: np.ndarray, t_cov: Threshold, t_quo: Threshold):
    n_items, n = member.shape
    i_glob = member.sum(axis=1)
    quorum_eff = max(1, t_quo.to_absolute(n))
    out = []
    for m in range(1, n + 1):
        total = 0.0
        n_subsets = 0
        m_quorum = math.ceil(m * t_quo.to_relative(n))
        for S in itertools.combinations(range(n), m):
            X = member[:, S].sum(axis=1)
            if quorum_eff == 1:
                c = max(1, t_cov.to_absolute(n))
                ok = (X >= 1) & (i_glob >= c)
            elif quorum_eff >= n:
                c = max(1, t_cov.to_absolute(n + 1))
                ok = (X == m) & (i_glob >= c)
            else:
                c = max(1, t_cov.to_absolute(n))
                full = (X == m) & (i_glob >= max(m, c))
                part = (X >= max(m_quorum, c)) & (X < m)
                ok = full | part
            total += int(ok.sum())
            n_subsets += 1
        out.append(total / n_subsets)
    return out


def test_growth_matches_subset_enumeration():
    rng = np.random.default_rng(1234)
    thresholds = [
        (Threshold.absolute(1), Threshold.rel(0.0)),  # union
        (Threshold.absolute(2), Threshold.rel(0.0)),  # union + coverage
        (Threshold.absolute(1), Threshold.rel(1.0)),  # core
        (Threshold.absolute(3), Threshold.rel(1.0)),  # core + coverage
        (Threshold.absolute(1), Threshold.rel(0.5)),  # general quorum
        (Threshold.absolute(2), Threshold.rel(0.4)),  # quorum + coverage
        (Threshold.absolute(1), Threshold.rel(0.75)),
        (Threshold.rel(0.5), Threshold.rel(0.6)),  # relative coverage
    ]
    for trial in range(6):
        n_groups = int(rng.integers(3, 8))
        n_items = int(rng.integers(5, 60))
        density = rng.uniform(0.15, 0.85)
        member = (rng.random((n_items, n_groups)) < density).astype(np.int64)
        cov = member.sum(axis=1)
        hist = np.bincount(cov, minlength=n_groups + 1)
        hist[0] = 0  # items in no group are not in the graph's hist
        h = Hist(CountType.NODE, [int(x) for x in hist])
        for t_cov, t_quo in thresholds:
            want = oracle_growth(member, t_cov, t_quo)
            got = h.calc_growth(t_cov, t_quo)
            assert len(got) == len(want)
            for m, (g, w) in enumerate(zip(got, want), start=1):
                assert abs(g - w) <= 1e-9 * max(1.0, abs(w)), (
                    f"trial={trial} n={n_groups} c={t_cov} q={t_quo} "
                    f"m={m}: {g} vs oracle {w}"
                )
