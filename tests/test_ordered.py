"""Ordered growth: device scan vs a direct port of the reference's
CSC-walk algorithm (abacus.rs:988-1032) on random instances."""

import math

import numpy as np

from panacus_jax.ops.engine import CountingEngine
from panacus_jax.utils import Threshold


def reference_ordered_growth(memberships, n_groups, weights, c_abs, q_rel):
    """Oracle: literal reimplementation of AbacusByGroup::calc_growth's
    interval walk, from per-item sorted group lists."""
    res = np.zeros(n_groups)
    c = max(1, c_abs)
    q = max(0.0, q_rel)
    for item, groups in enumerate(memberships):
        groups = sorted(groups)
        if len(groups) < c or not groups:
            continue
        k = 0
        for j in range(groups[0], n_groups):
            if k < len(groups) - 1 and groups[k + 1] <= j:
                k += 1
            if k + 1 >= math.ceil((groups[k] + 1) * q):
                res[j] += weights[item]
    return res


def build_engine(memberships, n_groups):
    items = []
    gids = []
    for i, gs in enumerate(memberships):
        for g in gs:
            items.append(i + 1)
            gids.append(g)
    e = CountingEngine(len(memberships), n_groups)
    e.build(np.array(items, dtype=np.int64), np.array(gids, dtype=np.int64))
    return e


def test_ordered_growth_random_instances():
    rng = np.random.default_rng(42)
    for trial in range(4):
        n_groups = int(rng.integers(2, 40))
        n_items = int(rng.integers(5, 200))
        memberships = [
            sorted(
                rng.choice(
                    n_groups,
                    size=int(rng.integers(0, n_groups + 1)),
                    replace=False,
                ).tolist()
            )
            for _ in range(n_items)
        ]
        weights = rng.integers(1, 50, size=n_items)
        e = build_engine(memberships, n_groups)
        for c_abs, q_rel in [(1, 0.0), (2, 0.0), (1, 1.0), (1, 0.5), (3, 0.7)]:
            w_full = np.zeros(n_items + 1, dtype=np.int64)
            w_full[1:] = weights
            got = e.ordered_growth(w_full, q_rel, max(1, c_abs))
            want = reference_ordered_growth(
                memberships, n_groups, weights, c_abs, q_rel
            )
            assert got.tolist() == want.tolist(), (
                trial,
                c_abs,
                q_rel,
            )


def test_ordered_growth_thresholds_relative():
    # relative coverage thresholds resolve against n_groups
    memberships = [[0, 1, 2], [1], [0, 2], [2]]
    e = build_engine(memberships, 3)
    w = np.array([0, 1, 1, 1, 1], dtype=np.int64)
    got = e.ordered_growth(w, 0.0, Threshold.rel(0.5).to_absolute(3))
    want = reference_ordered_growth(memberships, 3, [1, 1, 1, 1], 2, 0.0)
    assert got.tolist() == want.tolist()


def test_order_with_fragmented_groups_rejected(tmp_path):
    # order files must keep each group contiguous (reference: the
    # "fragmented groups" check, src/graph_broker/abacus.rs:116-127)
    import pytest

    from panacus_jax.cli import run_cli

    gfa = tmp_path / "f.gfa"
    gfa.write_text(
        "H\tVN:Z:1.0\n"
        "S\t1\tA\nS\t2\tAC\n"
        "P\ta#0#c\t1+\t*\n"
        "P\tb#0#c\t2+\t*\n"
        "P\ta#1#c\t1+,2+\t*\n"
        "P\tb#1#c\t2+\t*\n"
    )
    order = tmp_path / "order.txt"
    # a..b..a..b: group b is re-entered after being left -> rejected
    order.write_text("a#0#c\nb#0#c\na#1#c\nb#1#c\n")
    with pytest.raises(ValueError, match="fragmented groups"):
        run_cli(
            ["ordered-histgrowth", str(gfa), "-S", "-O", str(order)]
        )
    # quirk replicated from the reference (abacus.rs:116-126): the FIRST
    # group is never marked visited, so re-entering it (a..b..a..a) passes
    order.write_text("a#0#c\nb#0#c\nb#1#c\na#1#c\n")
    run_cli(["ordered-histgrowth", str(gfa), "-S", "-O", str(order)])
    # a contiguous order is fine
    order.write_text("b#0#c\nb#1#c\na#0#c\na#1#c\n")
    run_cli(["ordered-histgrowth", str(gfa), "-S", "-O", str(order)])
