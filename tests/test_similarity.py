"""Similarity: device matmul intersections vs a direct oracle
(reference: src/analyses/similarity.rs:119-163)."""

import numpy as np

from panacus_jax.ops.engine import CountingEngine


def oracle_similarity(memberships, n_groups, weights):
    inter = np.zeros((n_groups, n_groups))
    for i, gs in enumerate(memberships):
        for a in gs:
            for b in gs:
                inter[a, b] += weights[i]
    return inter


def test_similarity_random():
    rng = np.random.default_rng(9)
    n_groups, n_items = 13, 300
    memberships = [
        sorted(
            rng.choice(
                n_groups, size=int(rng.integers(0, n_groups + 1)), replace=False
            ).tolist()
        )
        for _ in range(n_items)
    ]
    weights = rng.integers(1, 2000, size=n_items).astype(np.float64)
    items, gids = [], []
    for i, gs in enumerate(memberships):
        for g in gs:
            items.append(i + 1)
            gids.append(g)
    e = CountingEngine(n_items, n_groups)
    e.build(np.array(items, dtype=np.int64), np.array(gids, dtype=np.int64))
    w_full = np.zeros(n_items + 1, dtype=np.float32)
    w_full[1:] = weights
    got = e.similarity(w_full)
    want = oracle_similarity(memberships, n_groups, weights)
    assert np.allclose(got, want), np.abs(got - want).max()


def test_jaccard_and_cluster_order():
    from panacus_jax.analyses.similarity import _cluster_order

    table = np.array(
        [
            [1.0, 0.9, 0.1],
            [0.9, 1.0, 0.2],
            [0.1, 0.2, 1.0],
        ],
        dtype=np.float32,
    )
    for method in (
        "single",
        "complete",
        "average",
        "weighted",
        "ward",
        "centroid",
        "median",
    ):
        order = _cluster_order(table, method)
        assert sorted(order) == [0, 1, 2]
        # the two similar groups (0, 1) must end up adjacent
        pos = {g: i for i, g in enumerate(order)}
        assert abs(pos[0] - pos[1]) == 1
