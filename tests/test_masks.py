"""Subset/exclude (BED) interval semantics, replicating the reference's
interval-walking behavior (src/graph_broker/util.rs:412-795) including its
partial-coverage bp corrections."""

import numpy as np
import pytest

from panacus_jax.abacus import AbacusByTotal, path_order_groups
from panacus_jax.gfa import GraphStorage
from panacus_jax.itemize import itemize_paths
from panacus_jax.mask import GraphMask, GraphMaskParameters
from panacus_jax.utils import CountType


def write_gfa(tmp_path, name="g.gfa"):
    # one path a#1#c over nodes 1(3bp), 2(2bp), 3(4bp); plus path b#1#c
    # over nodes 2, 3
    gfa = tmp_path / name
    gfa.write_text(
        "H\tVN:Z:1.0\n"
        "S\t1\tAAA\n"
        "S\t2\tCC\n"
        "S\t3\tGGGG\n"
        "L\t1\t+\t2\t+\t0M\n"
        "L\t2\t+\t3\t+\t0M\n"
        "P\ta#1#c\t1+,2+,3+\t*\n"
        "P\tb#1#c\t2+,3+\t*\n"
    )
    return str(gfa)


def run(gfa, count_types, subset="", exclude=""):
    need_edge = CountType.EDGE in count_types
    g = GraphStorage(gfa, index_edges=need_edge)
    mask = GraphMask.from_datamgr(
        GraphMaskParameters(positive_list=subset, negative_list=exclude), g
    )
    itemized = itemize_paths(g, mask, count_types)
    path_order, groups = path_order_groups(mask, g.path_segments)
    abaci = {
        ct: AbacusByTotal.from_itemization(
            ct, i, itemized, path_order, groups, g
        )
        for i, ct in enumerate(count_types)
    }
    return abaci, groups


def test_subset_full_node_coverage(tmp_path):
    gfa = write_gfa(tmp_path)
    bed = tmp_path / "inc.bed"
    bed.write_text("a#1#c\t0\t5\n")  # covers node1 (0-3), node2 (3-5) fully
    abaci, groups = run(gfa, [CountType.NODE, CountType.BP], subset=str(bed))
    # only path a is included; nodes 1, 2 covered; node 3 not
    assert abaci[CountType.NODE].countable[1:].tolist() == [1, 1, 0]
    hist = abaci[CountType.NODE].construct_hist()
    assert hist.tolist()[:2] == [1, 2]
    bp_hist = abaci[CountType.BP].construct_hist_bps()
    # covered bp: 3 + 2 = 5; uncovered: 4
    assert bp_hist.tolist()[:2] == [4, 5]


def test_subset_partial_node(tmp_path):
    gfa = write_gfa(tmp_path)
    bed = tmp_path / "inc.bed"
    bed.write_text("a#1#c\t0\t4\n")  # node2 covered only on [0,1) of its 2bp
    abaci, groups = run(gfa, [CountType.NODE, CountType.BP], subset=str(bed))
    # node count: partially covered node2 still counts (reference comment
    # src/graph_broker/util.rs:599-620)
    assert abaci[CountType.NODE].countable[1:].tolist() == [1, 1, 0]
    bp_hist = abaci[CountType.BP].construct_hist_bps()
    # bp: node1 3 + node2 1 covered; 1 bp of node2 + node3's 4 uncovered
    assert bp_hist.tolist()[:2] == [5, 4]


def test_exclude_whole_path(tmp_path):
    gfa = write_gfa(tmp_path)
    bed = tmp_path / "exc.bed"
    bed.write_text("b#1#c\n")  # exclude path b entirely (1-column form)
    abaci, groups = run(gfa, [CountType.NODE], exclude=str(bed))
    # nodes 2,3 are excluded everywhere (also in path a)
    assert abaci[CountType.NODE].countable[1:].tolist() == [1, 0, 0]
    assert abaci[CountType.NODE].construct_hist().tolist()[:2] == [2, 1]


def test_exclude_interval(tmp_path):
    gfa = write_gfa(tmp_path)
    bed = tmp_path / "exc.bed"
    bed.write_text("a#1#c\t3\t9\n")  # excludes nodes 2 and 3 of path a
    abaci, groups = run(gfa, [CountType.NODE], exclude=str(bed))
    assert abaci[CountType.NODE].countable[1:].tolist() == [1, 0, 0]


def test_backward_orientation_interval_flip(tmp_path):
    # path traverses node 3 backward; include covers first 2bp of the
    # traversal, which map to the LAST 2bp of the node
    gfa = tmp_path / "rev.gfa"
    gfa.write_text(
        "H\tVN:Z:1.0\n"
        "S\t1\tGGGG\n"
        "P\ta#1#c\t1-\t*\n"
    )
    bed = tmp_path / "inc.bed"
    bed.write_text("a#1#c\t0\t2\n")
    g = GraphStorage(str(gfa), index_edges=False)
    mask = GraphMask.from_datamgr(
        GraphMaskParameters(positive_list=str(bed)), g
    )
    itemized = itemize_paths(g, mask, [CountType.BP])
    assert itemized.subset_covered_bps is not None
    assert itemized.subset_covered_bps.get(1) == [(2, 4)]


def test_chrm_bed_subset(chrm_gfa):
    import os

    bed = "/root/reference/test/bed_chrM/inclusion.bed1"
    if not os.path.exists(bed):
        pytest.skip("bed fixture missing")
    abaci, groups = run(chrm_gfa, [CountType.NODE, CountType.BP], subset=bed)
    full, _ = run(chrm_gfa, [CountType.NODE, CountType.BP])
    h_sub = abaci[CountType.NODE].construct_hist()
    h_full = full[CountType.NODE].construct_hist()
    # subsetting can only reduce coverage mass
    assert h_sub.sum() == h_full.sum()  # total nodes unchanged
    assert (
        np.arange(len(h_sub)) @ h_sub <= np.arange(len(h_full)) @ h_full
    )
    bp_sub = abaci[CountType.BP].construct_hist_bps()
    bp_full = full[CountType.BP].construct_hist_bps()
    assert bp_sub.sum() == bp_full.sum()
    assert (
        np.arange(len(bp_sub)) @ bp_sub <= np.arange(len(bp_full)) @ bp_full
    )


def test_chrm_bed_exclude(chrm_gfa):
    import os

    bed = "/root/reference/test/bed_chrM/exclusion.bed3"
    if not os.path.exists(bed):
        pytest.skip("bed fixture missing")
    abaci, groups = run(chrm_gfa, [CountType.NODE], exclude=bed)
    full, _ = run(chrm_gfa, [CountType.NODE])
    h_exc = abaci[CountType.NODE].construct_hist()
    h_full = full[CountType.NODE].construct_hist()
    assert h_exc.sum() == h_full.sum()
    assert (
        np.arange(len(h_exc)) @ h_exc <= np.arange(len(h_full)) @ h_full
    )


def test_regex_subset(capsys, tmp_path):
    # a subset string that is not a file is treated as a regex over path
    # names (reference: src/graph_broker/abacus.rs:212-240)
    gfa = tmp_path / "r.gfa"
    gfa.write_text(
        "H\tVN:Z:1.0\n"
        "S\t1\tA\nS\t2\tAC\nS\t3\tACG\n"
        "P\talpha#0#c\t1+,2+\t*\n"
        "P\tbeta#0#c\t2+,3+\t*\n"
    )
    from panacus_jax.cli import run_cli

    run_cli(["hist", str(gfa), "-s", "^alpha#"])
    out = capsys.readouterr().out
    rows = [l.split("\t") for l in out.splitlines() if l and l[0].isdigit()]
    hist = {int(r[0]): int(r[1]) for r in rows}
    # only alpha's nodes {1,2} are in the subset, each covered once
    assert hist[1] == 2 and hist.get(2, 0) == 0


def test_bed12_block_mode(tmp_path):
    from io import BytesIO

    from panacus_jax.io_utils import parse_bed_to_path_segments

    # blockSizes 2,3 at blockStarts 0,5 from chromStart 10 -> [10,12), [15,18)
    bed = b"p#0#c\t10\t30\tname\t0\t+\t10\t30\t0\t2\t2,3\t0,5\n"
    segs = parse_bed_to_path_segments(BytesIO(bed), use_block_info=True)
    coords = [(s.start, s.end) for s in segs]
    assert coords == [(10, 12), (15, 18)]
    # without block info: one interval [10, 30)
    segs = parse_bed_to_path_segments(BytesIO(bed), use_block_info=False)
    assert [(s.start, s.end) for s in segs] == [(10, 30)]


def test_subset_by_group_name(capsys, tmp_path):
    # a 1-column subset entry naming a GROUP expands to all its paths
    # (reference: complement_with_group_assignments, abacus.rs:152-201)
    gfa = tmp_path / "g.gfa"
    gfa.write_text(
        "H\tVN:Z:1.0\n"
        "S\t1\tA\nS\t2\tAC\nS\t3\tACG\n"
        "P\ts1#0#c\t1+\t*\n"
        "P\ts1#1#c\t1+,2+\t*\n"
        "P\ts2#0#c\t3+\t*\n"
    )
    sub = tmp_path / "sub.txt"
    sub.write_text("s1\n")
    from panacus_jax.cli import run_cli

    run_cli(["hist", str(gfa), "-S", "-s", str(sub)])
    out = capsys.readouterr().out
    rows = [l.split("\t") for l in out.splitlines() if l and l[0].isdigit()]
    hist = {int(r[0]): int(r[1]) for r in rows}
    # group s1 covers nodes {1, 2} once (sample grouping merges haplotypes)
    assert hist[1] == 2
