"""Coverage-count parity anchors: chrM golden vectors
(reference: src/graph_broker/abacus.rs:1480-1633, commented golden tests)
and t_groups hist (reference: tests/test_files/t_groups.hist.tsv)."""

import numpy as np
import pytest

from panacus_jax.abacus import AbacusByTotal, path_order_groups
from panacus_jax.gfa import GraphStorage
from panacus_jax.itemize import itemize_paths
from panacus_jax.mask import GraphMask, GraphMaskParameters
from panacus_jax.utils import CountType

CHRM_NODE_COUNTABLE = [
    3, 2, 1, 3, 1, 2, 3, 1, 2, 3, 2, 3, 2, 1, 3, 1, 3, 2, 3, 2, 3, 4,
    2, 2, 4, 3, 1, 4, 2, 2, 4, 3, 1, 4, 2, 2, 4, 1, 4, 1, 3, 4, 1, 3,
    4, 2, 2, 4, 1, 3, 4, 1, 3, 4, 1, 3, 4, 1, 3, 4, 1, 3, 4, 1, 3, 4,
    2, 2, 4, 1, 3, 4, 1, 3, 4, 2, 2, 4, 3, 1, 4, 1, 3, 4, 1, 3, 4, 1,
    3, 4, 1, 3, 4, 2, 2, 4, 1, 3, 4, 1, 3, 4, 1, 3, 4, 1, 3, 4, 1, 3,
    4, 1, 3, 4, 1, 3, 4, 1, 3, 4, 1, 3, 4, 2, 2, 4, 1, 3, 4, 2, 2, 4,
    2, 2, 4, 2, 2, 4, 3, 1, 4, 3, 1, 4, 3, 1, 4, 3, 1, 4, 3, 1, 4, 1,
]


def build_abaci(gfa_file, count_types, groupby_sample=False, **mask_kwargs):
    needs_edges = CountType.EDGE in count_types
    g = GraphStorage(gfa_file, index_edges=needs_edges)
    params = GraphMaskParameters(groupby_sample=groupby_sample, **mask_kwargs)
    mask = GraphMask.from_datamgr(params, g)
    itemized = itemize_paths(g, mask, count_types)
    path_order, groups = path_order_groups(mask, g.path_segments)
    abaci = {
        ct: AbacusByTotal.from_itemization(
            ct, i, itemized, path_order, groups, g
        )
        for i, ct in enumerate(count_types)
    }
    return abaci, groups, itemized


def test_chrm_node_countable_and_hist(chrm_gfa):
    abaci, groups, _ = build_abaci(
        chrm_gfa, [CountType.NODE], groupby_sample=True
    )
    ab = abaci[CountType.NODE]
    assert groups == ["chm13", "grch38", "HG00438", "HG00621"]
    countable = ab.countable
    assert countable[1:].tolist() == CHRM_NODE_COUNTABLE
    hist = ab.construct_hist()
    assert hist.tolist() == [0, 39, 29, 41, 45]


def test_chrm_edge_hist(chrm_gfa):
    abaci, groups, _ = build_abaci(
        chrm_gfa, [CountType.EDGE], groupby_sample=True
    )
    hist = abaci[CountType.EDGE].construct_hist()
    assert hist.tolist() == [0, 80, 59, 66, 0]


def test_chrm_bp_hist(chrm_gfa):
    abaci, groups, _ = build_abaci(chrm_gfa, [CountType.BP], groupby_sample=True)
    hist = abaci[CountType.BP].construct_hist_bps()
    assert hist.tolist() == [0, 616, 31, 601, 15949]


def test_chrm_all_counts_single_pass(chrm_gfa):
    abaci, groups, _ = build_abaci(
        chrm_gfa,
        [CountType.NODE, CountType.BP, CountType.EDGE],
        groupby_sample=True,
    )
    assert abaci[CountType.NODE].construct_hist().tolist() == [0, 39, 29, 41, 45]
    assert abaci[CountType.BP].construct_hist_bps().tolist() == [
        0,
        616,
        31,
        601,
        15949,
    ]
    assert abaci[CountType.EDGE].construct_hist().tolist() == [0, 80, 59, 66, 0]


def test_cdbg_node_countable(cdbg_gfa):
    abaci, groups, _ = build_abaci(cdbg_gfa, [CountType.NODE])
    ab = abaci[CountType.NODE]
    assert groups == [
        "a#1#h1",
        "b#1#h1",
        "c#1#h1",
        "c#1#h2",
        "c#2#h1",
        "d#1#h1",
    ]
    assert ab.countable[1:].tolist() == [6, 4, 4, 2, 1]


def test_t_groups_hist(t_groups_gfa):
    abaci, groups, _ = build_abaci(t_groups_gfa, [CountType.NODE])
    hist = abaci[CountType.NODE].construct_hist()
    # reference fixture: tests/test_files/t_groups.hist.tsv
    assert hist.tolist() == [5, 0, 10, 0, 0, 0, 0]


def test_t_groups_grouped_by_sample(t_groups_gfa):
    abaci, groups, itemized = build_abaci(
        t_groups_gfa, [CountType.NODE, CountType.BP], groupby_sample=True
    )
    assert groups == ["y", "x"]
    # all 10 path-traversed nodes are in both sample groups; 5 nodes untouched
    assert abaci[CountType.NODE].construct_hist().tolist() == [5, 0, 10]
    # group totals (reference: tests/info.rs:36-50): each group has
    # 50 bp / 10 nodes
    from panacus_jax.gfa import PathSegment

    lens = itemized.paths_len
    x = PathSegment.from_str("x")
    assert lens[x] == (10, 50)
