"""Growth as a matmul: precomputed binomial weight matrices.

growth[m] = sum_i hist[i] * W[m-1, i] where W encodes the exact
expected-growth probabilities (the closed form behind the reference's
incremental recurrences, src/graph_broker/hist.rs:89-187):

  union:  W[m-1,i] = [i>=c] * (1 - C(n-i,m)/C(n,m))
  core:   W[m-1,i] = [i>=max(m,c)] * C(i,m)/C(n,m)
  quorum: W[m-1,i] = sum_{j=max(ceil(m q),c)}^{m} C(i,j) C(n-i,m-j) / C(n,m)

W is built host-side in f64 via log-gamma and shipped to the device; the
hist @ W product is one dense matrix product, which the sharded pipeline
runs after its psum. The recurrence-exact host path (hist.py) remains the
bit-parity reference; this path agrees to ~1e-9 relative.
"""

from __future__ import annotations

import math
from typing import List

import numpy as np
from scipy.special import gammaln

from ..utils import Threshold


def _lg_choose(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """log C(a, b); -inf outside 0 <= b <= a."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    with np.errstate(invalid="ignore"):
        v = gammaln(a + 1.0) - gammaln(b + 1.0) - gammaln(a - b + 1.0)
    return np.where((b < 0) | (b > a), -np.inf, v)


def growth_weight_matrix(
    n: int, t_coverage: Threshold, t_quorum: Threshold
) -> np.ndarray:
    """[n, n+1] f64 weight matrix for one (coverage, quorum) pair."""
    if n <= 0:
        return np.zeros((0, 1))
    quorum_abs = max(1, t_quorum.to_absolute(n))
    mm = np.arange(1, n + 1, dtype=np.float64).reshape(-1, 1)  # m axis
    ii = np.arange(0, n + 1, dtype=np.float64).reshape(1, -1)  # i axis
    lg_nm = _lg_choose(np.full_like(mm, n), mm)  # log C(n, m)

    if quorum_abs == 1:  # union
        c = max(1, t_coverage.to_absolute(n))
        with np.errstate(invalid="ignore"):
            p_absent = np.exp(_lg_choose(n - ii, mm) - lg_nm)
        p_absent = np.nan_to_num(p_absent, nan=0.0, posinf=0.0)
        W = (1.0 - p_absent) * (ii >= c)
        return W

    if quorum_abs >= n:  # core
        c = max(1, t_coverage.to_absolute(n + 1))
        with np.errstate(invalid="ignore"):
            p_all = np.exp(_lg_choose(ii, mm) - lg_nm)
        p_all = np.nan_to_num(p_all, nan=0.0, posinf=0.0)
        W = p_all * (ii >= np.maximum(mm, c))
        return W

    # general quorum — mirrors the reference's asymmetric coverage gating
    # (hist.rs:152-184): the full-containment term requires total coverage
    # i >= max(m, c); the partial terms require in-subset count j >= max(mq, c)
    c = max(1, t_coverage.to_absolute(n))
    q_rel = t_quorum.to_relative(n)
    W = np.zeros((n, n + 1), dtype=np.float64)
    i_ax = np.arange(0, n + 1, dtype=np.float64)
    for m in range(1, n + 1):
        m_quorum = int(math.ceil(m * q_rel))
        j_lo = max(m_quorum, c)
        lgnm = _lg_choose(np.float64(n), np.float64(m))
        with np.errstate(invalid="ignore"):
            full = np.exp(_lg_choose(i_ax, np.float64(m)) - lgnm)
        acc = np.nan_to_num(full, nan=0.0, posinf=0.0) * (
            i_ax >= max(m, c)
        )
        for j in range(j_lo, m):
            with np.errstate(invalid="ignore"):
                term = np.exp(
                    _lg_choose(i_ax, np.float64(j))
                    + _lg_choose(n - i_ax, np.float64(m - j))
                    - lgnm
                )
            acc += np.nan_to_num(term, nan=0.0, posinf=0.0)
        W[m - 1] = acc
    return W


def growth_weight_stack(
    n: int, coverages: List[Threshold], quorums: List[Threshold]
) -> np.ndarray:
    """[n_pairs, n, n+1] stacked weight matrices for a ThresholdContainer."""
    return np.stack(
        [growth_weight_matrix(n, c, q) for c, q in zip(coverages, quorums)]
    )


# production auto-select: hist.Hist.calc_growth routes union/core growths
# through the weight-matrix product above this group count (the per-m
# recurrences are a Python loop over m — O(n) interpreter steps — while
# the weight rows are closed-form and vectorize over the whole (m, i)
# grid). Tunable: PANACUS_GROWTH_MATMUL_N; 0 disables.
GROWTH_MATMUL_MIN_N = 2048
_CHUNK_ROWS = 1 << 20  # elements per W chunk (bounds peak memory ~16 MB)


def matmul_threshold() -> int:
    import os

    v = os.environ.get("PANACUS_GROWTH_MATMUL_N")
    return int(v) if v else GROWTH_MATMUL_MIN_N


def growth_matmul(
    hist: np.ndarray, t_coverage: Threshold, t_quorum: Threshold
) -> "np.ndarray | None":
    """growth[m] for m in 1..n via chunked rows of the f64 weight matrix —
    the production large-n path (union/core only; the general-quorum W
    build is O(n^3), where the memoized recurrence stays cheaper).
    Returns None when the pair is a general quorum. Agrees with the
    recurrence-exact path to ~1e-9 relative (tests/test_growth_device.py);
    the TSV writer floors cells, absorbing the ulps."""
    n = len(hist) - 1
    if n <= 0:
        return np.zeros(0)
    quorum_abs = max(1, t_quorum.to_absolute(n))
    if 1 < quorum_abs < n:
        return None
    h = np.asarray(hist, dtype=np.float64)
    out = np.empty(n, dtype=np.float64)
    rows = max(1, _CHUNK_ROWS // (n + 1))
    # 1D log-factorial table: lgC(a, b) = t[a] - t[b] - t[a-b] becomes
    # three table lookups per grid cell (one gammaln call per integer,
    # not per cell — the grid is O(n^2) cells)
    t = gammaln(np.arange(n + 1, dtype=np.float64) + 1.0)

    def lgC(a, b):
        """log C(a, b) for integer index arrays, -inf outside 0<=b<=a."""
        ok = (b >= 0) & (b <= a)
        a_c = np.where(ok, a, 0)
        b_c = np.where(ok, b, 0)
        return np.where(ok, t[a_c] - t[b_c] - t[a_c - b_c], -np.inf)

    ii = np.arange(0, n + 1, dtype=np.int64).reshape(1, -1)
    for m0 in range(1, n + 1, rows):
        m1 = min(m0 + rows, n + 1)
        mm = np.arange(m0, m1, dtype=np.int64).reshape(-1, 1)
        lg_nm = lgC(np.full_like(mm, n), mm)
        with np.errstate(invalid="ignore"):
            if quorum_abs == 1:  # union
                c = max(1, t_coverage.to_absolute(n))
                p_absent = np.exp(lgC(n - ii, mm) - lg_nm)
                W = (
                    1.0 - np.nan_to_num(p_absent, nan=0.0, posinf=0.0)
                ) * (ii >= c)
            else:  # core (reference's to_absolute(n+1) quirk, hist.rs:118)
                c = max(1, t_coverage.to_absolute(n + 1))
                p_all = np.exp(lgC(ii, mm) - lg_nm)
                W = np.nan_to_num(p_all, nan=0.0, posinf=0.0) * (
                    ii >= np.maximum(mm, c)
                )
        out[m0 - 1 : m1 - 1] = W @ h
    return out
