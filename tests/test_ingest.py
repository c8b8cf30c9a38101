"""Multi-host ingest invariant: partitioning the path set across hosts and
OR-merging partial membership matrices equals the single-host build."""

import numpy as np

from panacus_jax.abacus import (
    AbacusByTotal,
    build_membership_host,
    path_order_groups,
)
from panacus_jax.gfa import GraphStorage
from panacus_jax.itemize import itemize_paths
from panacus_jax.mask import GraphMask, GraphMaskParameters
from panacus_jax.ops import CountingEngine
from panacus_jax.parallel.ingest import (
    host_path_slice,
    merge_partials,
    partial_membership,
)
from panacus_jax.utils import CountType

from conftest import reference_file


def _full_M(graph, mask):
    itemized = itemize_paths(graph, mask, [CountType.NODE])
    path_order, groups = path_order_groups(mask, graph.path_segments)
    eng = CountingEngine(graph.node_count, len(groups))
    M = build_membership_host(
        itemized.item_tables[0],
        path_order,
        itemized.exclude_tables[0],
        graph.node_count,
        len(groups),
        eng.n_items_pad,
    )
    return M, eng, groups


def test_partition_merge_equals_full():
    gfa = reference_file("test/chrM_test.gfa")
    g = GraphStorage(gfa, index_edges=False)
    mask = GraphMask.from_datamgr(
        GraphMaskParameters(groupby_sample=True), g
    )
    M_full, eng, groups = _full_M(g, mask)

    for n_hosts in (2, 3):
        partials = []
        for h in range(n_hosts):
            sl = host_path_slice(len(g.path_segments), h, n_hosts)
            Mh, gh = partial_membership(
                g, mask, sl, g.node_count, eng.n_items_pad
            )
            assert gh == groups
            partials.append(Mh)
        merged = merge_partials(partials)
        assert np.array_equal(merged, M_full), f"{n_hosts}-host merge differs"


def test_sliced_hist_matches():
    gfa = reference_file("test/chrM_test.gfa")
    g = GraphStorage(gfa, index_edges=False)
    mask = GraphMask.from_datamgr(
        GraphMaskParameters(groupby_sample=True), g
    )
    M_full, eng, groups = _full_M(g, mask)
    partials = [
        partial_membership(
            g,
            mask,
            host_path_slice(len(g.path_segments), h, 2),
            g.node_count,
            eng.n_items_pad,
        )[0]
        for h in range(2)
    ]
    eng.build_from_host_matrix(merge_partials(partials))
    w = np.ones(g.node_count + 1, dtype=np.int32)
    w[0] = 0
    hist = eng.hist(w)
    assert hist.tolist() == [0, 39, 29, 41, 45]


def test_host_path_slice_partitions():
    for n, k in [(6, 2), (7, 3), (1, 4), (0, 2)]:
        all_idx = np.concatenate(
            [host_path_slice(n, h, k) for h in range(k)]
        )
        assert all_idx.tolist() == list(range(n))


def test_group_cuts_balanced_hprc_shape():
    """90 haplotype groups over 8 processes (the HPRC shape that starves a
    whole-word partition: 3 words, 5 idle hosts) must give every process a
    payload share, with per-word contributor slots covering each group's
    owner exactly once."""
    from panacus_jax.parallel.ingest import (
        group_cuts,
        word_slots,
        words_of_range,
    )

    rng = np.random.default_rng(3)
    for n_groups, n_proc in [(90, 8), (40, 2), (3, 4), (128, 3), (1, 2)]:
        payload = rng.integers(1, 1000, size=n_groups).astype(np.int64)
        cuts = group_cuts(payload, n_proc)
        assert cuts[0] == 0 and cuts[-1] == n_groups
        assert all(cuts[i] <= cuts[i + 1] for i in range(n_proc))
        total = payload.sum()
        shares = [
            payload[cuts[p] : cuts[p + 1]].sum() / total
            for p in range(n_proc)
        ]
        # balanced up to one group's granularity
        gmax = payload.max() / total
        assert max(shares) <= 1.0 / n_proc + gmax + 1e-9, (shares, gmax)
        if n_groups >= n_proc:
            assert all(cuts[p] < cuts[p + 1] for p in range(n_proc)), cuts

        n_words = (n_groups + 31) // 32
        wpp2 = max(
            len(words_of_range(cuts[p], cuts[p + 1]))
            for p in range(n_proc)
        ) or 1
        slots = word_slots(cuts, n_words, wpp2)
        # every word has >= 1 contributor; slots are unique global rows
        assert (slots[:, 0] >= 0).all()
        flat = slots[slots >= 0]
        assert len(np.unique(flat)) == len(flat)
        # a word's contributors are exactly the processes whose group
        # range overlaps it
        for w in range(n_words):
            want = {
                p
                for p in range(n_proc)
                if cuts[p] < cuts[p + 1]
                and cuts[p] < min((w + 1) * 32, n_groups)
                and cuts[p + 1] > w * 32
            }
            got = {int(s) // wpp2 for s in slots[w] if s >= 0}
            assert got == want, (w, got, want)


def test_assemble_bitdisjoint_add_equals_or():
    """Partial rows from a group partition are bit-disjoint per word, so
    the assembly's add must equal the OR merge of the same partials."""
    rng = np.random.default_rng(5)
    n_words, n_pad = 2, 256
    n_groups = 40
    # simulate 3 processes owning group ranges [0,13) [13,30) [30,40)
    cuts = [0, 13, 30, 40]
    rows = []
    for p in range(3):
        R = np.zeros((n_words, n_pad), dtype=np.uint32)
        for g in range(cuts[p], cuts[p + 1]):
            items = rng.integers(1, n_pad, size=8)
            R[g >> 5, items] |= np.uint32(1 << (g & 31))
        rows.append(R)
    add = rows[0] + rows[1] + rows[2]
    orr = rows[0] | rows[1] | rows[2]
    assert (add == orr).all()
