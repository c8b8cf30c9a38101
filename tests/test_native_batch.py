"""Parity tests for the native batch tokenizer / edge lookup against the
pure-numpy fallbacks (the reference's chunk-invariance tests play the same
role for its rayon scanner, src/graph_broker/util.rs:1250-1307)."""

import contextlib

import numpy as np
import pytest

import panacus_jax.native as native
from panacus_jax.gfa import GraphStorage
from panacus_jax.itemize import itemize_paths
from panacus_jax.mask import GraphMask, GraphMaskParameters
from panacus_jax.utils import CountType


@contextlib.contextmanager
def no_native():
    lib, tried = native._LIB, native._TRIED
    native._LIB, native._TRIED = None, True
    try:
        yield
    finally:
        native._LIB, native._TRIED = lib, tried


def _write(tmp_path, name, text):
    p = tmp_path / name
    p.write_text(text)
    return str(p)


MIXED_GFA = """H\tVN:Z:1.0
S\t7\tAC
S\t12\tG
S\t3\tTTTT
S\t900\tA
L\t7\t+\t12\t-\t0M
L\t12\t-\t3\t+\t0M
L\t3\t+\t900\t+\t0M
L\t900\t+\t7\t+\t0M
P\ta#1#c1\t7+,12-,3+\t*
W\tb\t1\tc1\t0\t8\t>7<12>3>900
P\ta#2#c1\t900+,7+\t*
P\tempty#1#c\t7+\t*
"""


@pytest.fixture
def mixed_graph(tmp_path):
    return _write(tmp_path, "mixed.gfa", MIXED_GFA)


def _itemize(gfa, counts, index_edges):
    g = GraphStorage(gfa, index_edges=index_edges)
    mask = GraphMask.from_datamgr(GraphMaskParameters(), g)
    return itemize_paths(g, mask, counts)


@pytest.mark.parametrize("counts,edges", [
    ([CountType.NODE], False),
    ([CountType.NODE, CountType.BP], False),
    ([CountType.EDGE], True),
    ([CountType.NODE, CountType.BP, CountType.EDGE], True),
])
def test_batch_matches_fallback_mixed_names(mixed_graph, counts, edges):
    if native.get_lib() is None:
        pytest.skip("native lib unavailable")
    it_native = _itemize(mixed_graph, counts, edges)
    with no_native():
        it_py = _itemize(mixed_graph, counts, edges)
    for tn, tp in zip(it_native.item_tables, it_py.item_tables):
        assert np.array_equal(tn.items, tp.items)
        assert np.array_equal(tn.prefsum, tp.prefsum)
    assert it_native.paths_len == it_py.paths_len


def test_batch_walks_and_sorted_names(mixed_graph):
    """Non-contiguous integer names exercise the sorted-lookup C mode."""
    g = GraphStorage(mixed_graph, index_edges=False)
    assert g._int_name_mode == "sorted"
    res = g.all_path_item_runs()
    if res is None:
        pytest.skip("native lib unavailable")
    ids, orient, prefsum, bp = res
    # path 0: 7+,12-,3+ -> dense ids of nodes 7,12,3 (S-line order 1,2,3)
    assert ids[prefsum[0]:prefsum[1]].tolist() == [1, 2, 3]
    assert orient[prefsum[0]:prefsum[1]].tolist() == [0, 1, 0]
    # walk: >7<12>3>900
    assert ids[prefsum[1]:prefsum[2]].tolist() == [1, 2, 3, 4]
    assert orient[prefsum[1]:prefsum[2]].tolist() == [0, 1, 0, 0]
    # bp per path = sum of node lens
    assert bp[0] == 2 + 1 + 4
    assert bp[1] == 2 + 1 + 4 + 1


def test_unknown_node_in_path_raises(tmp_path):
    gfa = _write(
        tmp_path,
        "bad.gfa",
        "H\tVN:Z:1.0\nS\t1\tA\nS\t2\tC\nP\tp#1#c\t1+,5+\t*\n",
    )
    with pytest.raises(ValueError):
        _itemize(gfa, [CountType.NODE], False)
    with no_native():
        with pytest.raises(ValueError):
            _itemize(gfa, [CountType.NODE], False)


def test_unknown_edge_raises(tmp_path):
    gfa = _write(
        tmp_path,
        "noedge.gfa",
        "H\tVN:Z:1.0\nS\t1\tA\nS\t2\tC\nL\t1\t+\t2\t+\t0M\n"
        "P\tp#1#c\t2+,1+\t*\n",
    )
    # edge 2+,1+ canonicalizes to 1-,2- which is NOT in the L set
    with pytest.raises(ValueError):
        _itemize(gfa, [CountType.EDGE], True)
    with no_native():
        with pytest.raises(ValueError):
            _itemize(gfa, [CountType.EDGE], True)


def test_interval_walk_parity_random_masks(tmp_path):
    """C interval walker vs Python fallback under random BED subsets and
    exclusions, forward and reverse orientations."""
    if native.get_lib() is None:
        pytest.skip("native lib unavailable")
    rng = np.random.default_rng(11)
    n_nodes = 80
    lines = ["H\tVN:Z:1.0"]
    lens = rng.integers(1, 12, size=n_nodes)
    for i in range(n_nodes):
        lines.append(f"S\t{i + 1}\t{'C' * int(lens[i])}")
    for p in range(6):
        visit = rng.permutation(n_nodes)[:40] + 1
        orient = rng.integers(0, 2, size=len(visit))
        toks = ",".join(
            f"{n}{'-' if o else '+'}" for n, o in zip(visit, orient)
        )
        lines.append(f"P\ts{p % 3}#{p}#c\t{toks}\t*")
    gfa = _write(tmp_path, "m.gfa", "\n".join(lines) + "\n")

    g0 = GraphStorage(gfa, index_edges=False)
    segs = [s.id() for s in g0.path_segments]
    sub = tmp_path / "sub.bed"
    sub.write_text(
        "".join(
            f"{s}\t{int(a)}\t{int(a + w)}\n"
            for s in segs[:4]
            for a, w in [(rng.integers(0, 60), rng.integers(5, 80))]
        )
    )
    exc = tmp_path / "exc.bed"
    exc.write_text(f"{segs[1]}\t10\t40\n{segs[4]}\t0\t25\n")

    for params in [
        GraphMaskParameters(positive_list=str(sub)),
        GraphMaskParameters(negative_list=str(exc)),
        GraphMaskParameters(
            positive_list=str(sub), negative_list=str(exc)
        ),
    ]:
        for counts in ([CountType.BP], [CountType.NODE, CountType.BP]):
            g = GraphStorage(gfa, index_edges=False)
            mask = GraphMask.from_datamgr(params, g)
            it_c = itemize_paths(g, mask, counts)
            g = GraphStorage(gfa, index_edges=False)
            mask = GraphMask.from_datamgr(params, g)
            with no_native():
                it_py = itemize_paths(g, mask, counts)
            for tn, tp in zip(it_c.item_tables, it_py.item_tables):
                assert np.array_equal(tn.items, tp.items)
                assert np.array_equal(tn.prefsum, tp.prefsum)
            assert it_c.paths_len == it_py.paths_len
            mc = (
                it_c.subset_covered_bps.map
                if it_c.subset_covered_bps is not None
                else None
            )
            mp = (
                it_py.subset_covered_bps.map
                if it_py.subset_covered_bps is not None
                else None
            )
            assert mc == mp
            for en, ep in zip(it_c.exclude_tables, it_py.exclude_tables):
                if en is None or ep is None:
                    assert en is None and ep is None
                    continue
                assert np.array_equal(en.items, ep.items)
                an = en.annotation.map if en.annotation else None
                ap = ep.annotation.map if ep.annotation else None
                assert an == ap


def test_larger_random_graph_parity(tmp_path):
    if native.get_lib() is None:
        pytest.skip("native lib unavailable")
    rng = np.random.default_rng(3)
    n_nodes = 500
    lines = ["H\tVN:Z:1.0"]
    for i in range(n_nodes):
        lines.append(f"S\t{i + 1}\t{'A' * int(rng.integers(1, 9))}")
    edge_set = set()
    paths = []
    for p in range(9):
        visit = rng.permutation(n_nodes)[: int(rng.integers(2, n_nodes))] + 1
        orient = rng.integers(0, 2, size=len(visit))
        for k in range(len(visit) - 1):
            u, o1, v, o2 = visit[k], orient[k], visit[k + 1], orient[k + 1]
            if u > v or (u == v and o1):
                u, o1, v, o2 = v, o2 ^ 1, u, o1 ^ 1
            edge_set.add((u, o1, v, o2))
        toks = ",".join(
            f"{n}{'-' if o else '+'}" for n, o in zip(visit, orient)
        )
        paths.append(f"P\ts{p}#1#c\t{toks}\t*")
    for u, o1, v, o2 in sorted(edge_set):
        lines.append(
            f"L\t{u}\t{'-' if o1 else '+'}\t{v}\t{'-' if o2 else '+'}\t0M"
        )
    lines.extend(paths)
    gfa = _write(tmp_path, "rand.gfa", "\n".join(lines) + "\n")
    for counts, edges in [
        ([CountType.NODE, CountType.BP], False),
        ([CountType.EDGE], True),
    ]:
        it_native = _itemize(gfa, counts, edges)
        with no_native():
            it_py = _itemize(gfa, counts, edges)
        for tn, tp in zip(it_native.item_tables, it_py.item_tables):
            assert np.array_equal(tn.items, tp.items)
            assert np.array_equal(tn.prefsum, tp.prefsum)
        assert it_native.paths_len == it_py.paths_len


def test_edge_adj_matches_hash_lookup(tmp_path):
    """CSR adjacency lookup (the hot-path structure) vs the open hash on a
    random graph with mixed orientations, reversed traversals and a hub
    node — both must produce identical canonical edge ids."""
    rng = np.random.default_rng(17)
    n_nodes, n_paths = 300, 12
    lines = ["H\tVN:Z:1.0"]
    for v in range(1, n_nodes + 1):
        lines.append(f"S\t{v}\tAC")
    paths = []
    edge_set = set()
    hub = 1
    for p in range(n_paths):
        k = int(rng.integers(20, 120))
        visits = rng.integers(1, n_nodes + 1, size=k)
        # force hub-node traffic (a high-degree row exercises the binary
        # search branch) and some back-edges
        visits[:: max(k // 8, 1)] = hub
        orient = rng.integers(0, 2, size=k)
        paths.append((visits, orient))
        for i in range(k - 1):
            u, o1 = int(visits[i]), int(orient[i])
            v, o2 = int(visits[i + 1]), int(orient[i + 1])
            if u > v or (u == v and o1):
                u, o1, v, o2 = v, o2 ^ 1, u, o1 ^ 1
            edge_set.add((u, o1, v, o2))
    for u, o1, v, o2 in sorted(edge_set):
        lines.append(f"L\t{u}\t{'-' if o1 else '+'}\t{v}\t{'-' if o2 else '+'}\t0M")
    for p, (visits, orient) in enumerate(paths):
        toks = ",".join(
            f"{v}{'-' if o else '+'}" for v, o in zip(visits, orient)
        )
        lines.append(f"P\tp{p}\t{toks}\t*")
    gfa = _write(tmp_path, "adj.gfa", "\n".join(lines) + "\n")

    g = GraphStorage(gfa, index_edges=True)
    if g.edge_adj() is None or g.edge_hash() is None:
        pytest.skip("native library unavailable")
    pids = np.arange(n_paths, dtype=np.int64)
    batch = g.all_path_item_runs(pids)
    assert batch is not None
    ids, orient, prefsum, _bp = batch
    r_hash = native.lookup_edges(ids, orient, prefsum, g.edge_hash(), 2)
    r_adj = native.lookup_edges_adj(ids, orient, prefsum, g.edge_adj(), 2)
    assert r_hash is not None and r_adj is not None
    np.testing.assert_array_equal(r_adj[0], r_hash[0])
    np.testing.assert_array_equal(r_adj[1], r_hash[1])
    # a hub row really is large enough to hit the binary-search branch
    row_off = g.edge_adj()[0]
    assert int((row_off[hub + 1] - row_off[hub])) > 32


def test_edge_adj_unknown_edge_raises(tmp_path):
    gfa = _write(
        tmp_path,
        "unk.gfa",
        "H\tVN:Z:1.0\nS\t1\tA\nS\t2\tC\nS\t3\tG\n"
        "L\t1\t+\t2\t+\t0M\n"
        "P\tp0\t1+,2+,3+\t*\n",
    )
    g = GraphStorage(gfa, index_edges=True)
    if g.edge_adj() is None:
        pytest.skip("native library unavailable")
    batch = g.all_path_item_runs(np.arange(1, dtype=np.int64))
    ids, orient, prefsum, _bp = batch
    with pytest.raises(ValueError, match="unknown edge"):
        native.lookup_edges_adj(ids, orient, prefsum, g.edge_adj(), 1)
