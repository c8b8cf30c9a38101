"""Oracle tests for the group-stage device programs: ordered growth
(cummax threshold formulation + group-scaled blocks, ops/engine.py) and
similarity (int32 block products, lo/hi plane recombination), against
independent numpy oracles. Each case runs on the default device here and,
under `-m gpu`, compiled for the card.

Reference semantics: ordered growth src/graph_broker/abacus.rs:988-1032,
similarity accumulation similarity.rs:119-150.
"""

from __future__ import annotations

import numpy as np
import pytest

import jax

from panacus_jax.ops.engine import (
    ITEM_ALIGN,
    ordered_block_for,
    ordered_growth,
    similarity_intersections,
)

def _unpack(M: np.ndarray, n_groups: int) -> np.ndarray:
    """[G, N] 0/1 presence from the packed word rows."""
    n_words, n = M.shape
    P = np.zeros((n_words * 32, n), dtype=np.int64)
    for w in range(n_words):
        for b in range(32):
            P[w * 32 + b] = (M[w] >> np.uint32(b)) & np.uint32(1)
    return P[:n_groups]


def _oracle_ordered(M, w, quorum, c_min, n_groups):
    """Reference recurrence in plain numpy (abacus.rs:988-1032): item
    counts at position j iff coverage-so-far >= ceil((last-present+1)*q),
    >= 1, and total coverage >= c_min."""
    P = _unpack(M, n_groups)
    cum = np.cumsum(P, axis=0)
    gidx = np.arange(n_groups).reshape(-1, 1)
    lp = np.maximum.accumulate(np.where(P > 0, gidx, -1), axis=0)
    thr = np.ceil((lp + 1) * quorum)
    thr[lp < 0] = np.inf
    total = cum[-1]
    ok = (cum >= thr) & (cum >= 1) & (total >= c_min).reshape(1, -1)
    return (ok * w.astype(np.int64).reshape(1, -1)).sum(axis=1)


def _case(rng, n_groups, n_items_pad, sparse=False):
    n_words = (n_groups + 31) // 32
    M = rng.integers(0, 2**32, size=(n_words, n_items_pad), dtype=np.uint32)
    if sparse:  # low coverage: exercises the lp == -1 (never seen) region
        M &= rng.integers(0, 2**32, size=M.shape, dtype=np.uint32)
        M &= rng.integers(0, 2**32, size=M.shape, dtype=np.uint32)
    # mask padding bits beyond n_groups in the last word
    tail_bits = n_words * 32 - n_groups
    if tail_bits:
        M[-1] &= np.uint32((1 << (32 - tail_bits)) - 1)
    M[:, 0] = 0  # sentinel column
    return M


ORDERED_CASES = [
    # (n_groups, quorum, c_min, sparse)
    (90, 0.0, 1, False),  # bench shape, no quorum
    (90, 0.3, 2, True),  # quorum + c_min + lp==-1 coverage holes
    (520, 0.5, 1, False),  # past where an unrolled select chain stops scaling
    (2100, 0.9, 3, True),  # group-scaled block path (B shrinks to 512)
]


def _check_ordered(n_groups, quorum, c_min, sparse, device):
    # the shrunken-block path must genuinely differ from the default
    assert ordered_block_for(2100) < ordered_block_for(90)
    rng = np.random.default_rng(n_groups)
    n_items_pad = ITEM_ALIGN
    M_host = _case(rng, n_groups, n_items_pad, sparse)
    w = rng.integers(0, 100, n_items_pad).astype(np.int32)
    w[0] = 0
    M = jax.device_put(M_host, device)
    got = ordered_growth(M, w, quorum, c_min, n_groups)
    want = _oracle_ordered(M_host, w, quorum, c_min, n_groups)
    np.testing.assert_array_equal(np.asarray(got).astype(np.int64), want)


@pytest.mark.parametrize("n_groups,quorum,c_min,sparse", ORDERED_CASES)
def test_ordered_growth_matches_oracle(n_groups, quorum, c_min, sparse):
    _check_ordered(n_groups, quorum, c_min, sparse, jax.devices()[0])


@pytest.mark.gpu
@pytest.mark.parametrize("n_groups,quorum,c_min,sparse", ORDERED_CASES)
def test_ordered_growth_matches_oracle_gpu(
    n_groups, quorum, c_min, sparse, gpu
):
    _check_ordered(n_groups, quorum, c_min, sparse, gpu)


SIM_CASES = [
    # (n_groups, weight style)
    (90, "ones"),
    (90, "bp"),  # 16-bit weights: lo plane only
    (64, "wide"),  # >16-bit weights: hi-half matmul engages
    (90, "carry"),  # concentrated mass: lo-plane partials carry
]


@pytest.mark.parametrize("n_groups,weight_style", SIM_CASES)
def test_similarity_matches_oracle(n_groups, weight_style):
    """Int16 lo/hi plane recombination (engine _sim_all scan carries the
    running sum as two int32 planes) vs an exact numpy co-occurrence
    matmul."""
    _check_similarity(n_groups, weight_style, jax.devices()[0])


@pytest.mark.gpu
@pytest.mark.parametrize("n_groups,weight_style", SIM_CASES)
def test_similarity_matches_oracle_gpu(n_groups, weight_style, gpu):
    _check_similarity(n_groups, weight_style, gpu)


def _check_similarity(n_groups, weight_style, device):
    rng = np.random.default_rng(17 + n_groups)
    n_items_pad = ITEM_ALIGN
    M_host = _case(rng, n_groups, n_items_pad)
    if weight_style == "ones":
        w = np.ones(n_items_pad, dtype=np.int64)
    elif weight_style == "bp":
        w = rng.integers(0, 1 << 16, n_items_pad).astype(np.int64)
    elif weight_style == "wide":
        w = rng.integers(0, 1 << 20, n_items_pad).astype(np.int64)
    else:  # carry: all-max weights, near-full coverage
        M_host[:] = 0xFFFFFFFF
        tail = (n_groups + 31) // 32 * 32 - n_groups
        if tail:
            M_host[-1] &= np.uint32((1 << (32 - tail)) - 1)
        M_host[:, 0] = 0
        w = np.full(n_items_pad, 0xFFFF, dtype=np.int64)
    w[0] = 0
    M = jax.device_put(M_host, device)
    got = similarity_intersections(M, w, n_groups)
    P = _unpack(M_host, n_groups)
    want = (P * w.reshape(1, -1)) @ P.T
    np.testing.assert_array_equal(np.asarray(got).astype(np.int64), want)
