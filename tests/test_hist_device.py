"""Oracle tests for the coverage histogram (CountingEngine.hist).

One device path remains: popcount coverage fused with an int32 scatter-add
while the total weight stays below 2^31, and the device popcount plus an
exact host bincount above it. The cases below cross that boundary, carry
one to many bins, weights of 1 to 24 bits, two weight vectors over one M
(node + bp share an engine), and concentrated mass in few bins. Each runs
on the default device here and, under `-m gpu`, compiled for the card.

Reference histogram semantics: src/graph_broker/abacus.rs:746-787
(weighted bincount of per-item coverage).
"""

from __future__ import annotations

import numpy as np
import pytest

import jax

from panacus_jax.abacus import AbacusByTotal, construct_hists
from panacus_jax.ops.engine import CountingEngine, fused_hist_scatter
from panacus_jax.utils import CountType

BLOCK = 1 << 14


def _oracle_hist(M: np.ndarray, w: np.ndarray, n_bins: int) -> np.ndarray:
    """Independent host recomputation: popcount coverage -> weighted
    bincount, exact in int64."""
    cov = np.bitwise_count(M).astype(np.int64).sum(axis=0)
    h = np.zeros(max(n_bins, int(cov.max(initial=0)) + 1), dtype=np.int64)
    np.add.at(h, cov, w.astype(np.int64))
    return h[:n_bins]


def _weights(rng, n_items, style):
    if style == "ones":
        w = np.ones(n_items, dtype=np.int64)
    elif style == "w8":
        w = rng.integers(0, 1 << 8, n_items)
    elif style == "w16":  # bp node-length weights
        w = rng.integers(0, 1 << 16, n_items)
    elif style == "w24":  # total far above 2^31: the exact host bincount
        w = rng.integers(0, 1 << 24, n_items)
    elif style == "mass":  # max weights piled into three bins
        w = np.full(n_items, 0xFFFFFF, dtype=np.int64)
    else:  # pragma: no cover
        raise AssertionError(style)
    # sentinel slot 0 carries zero weight; so does a tail of zero-length
    # items, except for "ones", the engine's device-built all-ones vector
    w[0] = 0
    if style != "ones":
        w[-7:] = 0
    return w


def _membership(rng, n_groups, n_items, style):
    n_words = (n_groups + 31) // 32
    M = rng.integers(0, 2**32, size=(n_words, n_items), dtype=np.uint32)
    if style == "mass":
        M[:] = 0
        M[0] = rng.integers(0, 4, n_items, dtype=np.uint32)  # cov in 0..2
    tail = n_words * 32 - n_groups
    if tail:
        M[-1] &= np.uint32((1 << (32 - tail)) - 1)
    M[:, 0] = 0
    return M


CASES = [
    # (n_groups, n_items, n_vecs, weight style)
    (32, BLOCK, 1, "ones"),
    (32, BLOCK, 1, "w8"),
    (64, BLOCK, 2, "w24"),  # two weight vectors over one M
    (1024, 2 * BLOCK, 1, "w24"),  # 1026 bins
    (1024, BLOCK, 2, "w8"),
    (96, BLOCK, 2, "w16"),
    (32, 2 * BLOCK, 1, "mass"),
]
IDS = [f"{c[3]}-g{c[0]}-n{c[1]}-v{c[2]}" for c in CASES]


def _engine(M_host, n_groups, device):
    """An engine over M_host (n_items = its width - 1), M on `device`."""
    e = CountingEngine(M_host.shape[1] - 1, n_groups)
    M = np.zeros((e.n_words, e.n_items_pad), dtype=np.uint32)
    M[:, : M_host.shape[1]] = M_host
    e.M = jax.device_put(M, device)
    return e


def _run_case(n_groups, n_items, n_vecs, style, device):
    rng = np.random.default_rng(n_groups * 1000 + n_items + n_vecs)
    M_host = _membership(rng, n_groups, n_items, style)
    e = _engine(M_host, n_groups, device)
    for v in range(n_vecs):
        w = _weights(rng, n_items, style)
        got = e.hist(None if style == "ones" else w)
        want = _oracle_hist(M_host, w, n_groups + 1)
        np.testing.assert_array_equal(
            got, want, err_msg=f"vector {v} of {style}/{n_groups} groups"
        )


@pytest.mark.parametrize("n_groups,n_items,n_vecs,style", CASES, ids=IDS)
def test_hist_matches_oracle(n_groups, n_items, n_vecs, style):
    _run_case(n_groups, n_items, n_vecs, style, jax.devices()[0])


@pytest.mark.gpu
@pytest.mark.parametrize("n_groups,n_items,n_vecs,style", CASES, ids=IDS)
def test_hist_matches_oracle_gpu(n_groups, n_items, n_vecs, style, gpu):
    _run_case(n_groups, n_items, n_vecs, style, gpu)


class _Graph:
    def __init__(self, node_lens):
        self.node_lens = node_lens


def test_node_and_bp_hists_share_an_engine():
    """construct_hists over node + bp abaci on ONE engine (the streamed
    build's layout): both hists equal the oracle, bp weighted by node
    length."""
    rng = np.random.default_rng(5)
    n_groups, n_items = 90, 3 * BLOCK
    M_host = _membership(rng, n_groups, n_items, "ones")
    e = _engine(M_host, n_groups, jax.devices()[0])
    lens = rng.integers(1, 1 << 12, n_items).astype(np.uint32)
    g = _Graph(lens)
    abaci = {
        ct: AbacusByTotal(ct, e, [str(i) for i in range(n_groups)], {}, g)
        for ct in (CountType.NODE, CountType.BP)
    }
    hists = construct_hists(abaci)
    ones = np.ones(n_items, dtype=np.int64)
    ones[0] = 0
    bp = lens.astype(np.int64)
    bp[0] = 0
    np.testing.assert_array_equal(
        hists[CountType.NODE], _oracle_hist(M_host, ones, n_groups + 1)
    )
    np.testing.assert_array_equal(
        hists[CountType.BP], _oracle_hist(M_host, bp, n_groups + 1)
    )


def test_scatter_drops_out_of_range_coverage():
    """Bins past n_bins are dropped, not clamped into the last bin."""
    M = np.full((1, 64), 0xFFFFFFFF, dtype=np.uint32)  # coverage 32
    w = np.ones(64, dtype=np.int32)
    h = np.asarray(fused_hist_scatter(jax.device_put(M), jax.device_put(w), 8))
    assert h.sum() == 0
