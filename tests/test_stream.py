"""Streamed membership build (panacus_jax/stream.py) must be semantically
identical to the classic itemize -> build -> upload path on unmasked runs:
same hists, same ordered growth, same similarity, same paths_len, same
per-path slices. Runs on the 8-device virtual mesh (conftest), so the
sharded placement of streamed rows is exercised too."""

import os

import numpy as np
import pytest

from panacus_jax.abacus import AbacusByTotal, path_order_groups
from panacus_jax.broker import GraphBroker, GraphState, Req
from panacus_jax.config import Grouping
from panacus_jax.gfa import GraphStorage
from panacus_jax.itemize import itemize_paths
from panacus_jax.mask import GraphMask, GraphMaskParameters
from panacus_jax.stream import streamed_total_abaci
from panacus_jax.utils import CountType


def classic_abaci(graph, mask, count_types):
    itemized = itemize_paths(graph, mask, count_types)
    path_order, groups = path_order_groups(mask, graph.path_segments)
    abaci = {
        ct: AbacusByTotal.from_itemization(
            ct, slot, itemized, path_order, groups, graph
        )
        for slot, ct in enumerate(count_types)
    }
    return abaci, itemized


@pytest.mark.parametrize("groupby", ["sample", "haplotype", None])
def test_stream_matches_classic_chrm(chrm_gfa, groupby):
    counts = [CountType.NODE, CountType.BP, CountType.EDGE]
    g = GraphStorage(chrm_gfa, index_edges=True)
    params = GraphMaskParameters(
        groupby_sample=groupby == "sample",
        groupby_haplotype=groupby == "haplotype",
    )
    mask = GraphMask.from_datamgr(params, g)
    res = streamed_total_abaci(g, mask, counts)
    assert res is not None, "chrM should take the streamed path"
    s_abaci, s_itemized, s_order, s_groups = res
    c_abaci, c_itemized = classic_abaci(g, mask, counts)

    for ct in counts:
        s, c = s_abaci[ct], c_abaci[ct]
        if ct == CountType.BP:
            np.testing.assert_array_equal(
                s.construct_hist_bps(), c.construct_hist_bps()
            )
        else:
            np.testing.assert_array_equal(
                s.construct_hist(), c.construct_hist()
            )
        np.testing.assert_array_equal(s.countable, c.countable)
    # node and bp share one engine (and one device matrix)
    assert s_abaci[CountType.NODE].engine is s_abaci[CountType.BP].engine
    assert s_itemized.paths_len == c_itemized.paths_len
    # slab-table slices match the classic CSR per path
    for slot in range(len(counts)):
        st, ct_ = s_itemized.item_tables[slot], c_itemized.item_tables[slot]
        for pid in range(len(g.path_segments)):
            np.testing.assert_array_equal(
                st.path_slice(pid), ct_.path_slice(pid)
            )


def test_stream_not_applicable_with_masks(chrm_gfa, tmp_path):
    bed = tmp_path / "inc.bed"
    bed.write_text("chm13#chrM\t0\t2000\n")
    g = GraphStorage(chrm_gfa, index_edges=False)
    mask = GraphMask.from_datamgr(
        GraphMaskParameters(groupby_sample=True, positive_list=str(bed)), g
    )
    assert streamed_total_abaci(g, mask, [CountType.NODE]) is None


def test_stream_env_kill_switch(chrm_gfa, monkeypatch):
    monkeypatch.setenv("PANACUS_NO_STREAM", "1")
    g = GraphStorage(chrm_gfa, index_edges=False)
    mask = GraphMask.from_datamgr(GraphMaskParameters(groupby_sample=True), g)
    assert streamed_total_abaci(g, mask, [CountType.NODE]) is None


def test_broker_group_abacus_shares_engine(chrm_gfa):
    gb = GraphBroker()
    reqs = {
        Req.NODE,
        Req.HIST,
        Req.abacus_by_group(CountType.NODE),
        Req.graph(chrm_gfa),
    }
    gb.change_graph_state(
        GraphState(graph=chrm_gfa, grouping=Grouping("sample")), reqs, False
    )
    assert gb.group_abacus is not None
    assert gb.group_abacus.engine is gb.total_abaci[CountType.NODE].engine
    # ordered growth through the shared engine still works
    from panacus_jax.utils import Threshold

    res = gb.group_abacus.calc_growth(Threshold.absolute(1), Threshold.rel(0.0))
    assert len(res) == len(gb.group_abacus.groups)
    assert res[-1] > 0


def test_stream_ordered_and_similarity_match(t_groups_gfa):
    counts = [CountType.NODE]
    g = GraphStorage(t_groups_gfa, index_edges=False)
    mask = GraphMask.from_datamgr(GraphMaskParameters(groupby_sample=True), g)
    res = streamed_total_abaci(g, mask, counts)
    assert res is not None
    s_abaci, _, _, _ = res
    c_abaci, _ = classic_abaci(g, mask, counts)
    se, ce = s_abaci[CountType.NODE].engine, c_abaci[CountType.NODE].engine
    w = np.ones(se.n_items + 1, dtype=np.int64)
    w[0] = 0
    np.testing.assert_array_equal(
        se.ordered_growth(w, 0.0, 1), ce.ordered_growth(w, 0.0, 1)
    )
    np.testing.assert_array_equal(
        se.similarity(w.astype(np.float32)),
        ce.similarity(w.astype(np.float32)),
    )


def test_serial_schedule_matches_sharded(chrm_gfa, monkeypatch):
    """The single-device host-placement schedule (phase A tokenize/node,
    phase B edge after joining the async edge index) must produce the
    same hists as the default sharded build. CI runs on the 8-device
    mesh where the serial path is never chosen, so force it."""
    from panacus_jax.ops import engine as eng

    cts = [CountType.NODE, CountType.BP, CountType.EDGE]

    def hists_of(res):
        from panacus_jax.abacus import construct_hists

        return {
            ct: [int(x) for x in h]
            for ct, h in construct_hists(res[0]).items()
        }

    g = GraphStorage(chrm_gfa, index_edges=True)
    mask = GraphMask.from_datamgr(GraphMaskParameters(groupby_sample=True), g)
    base = streamed_total_abaci(g, mask, cts)
    assert base is not None

    monkeypatch.setattr(eng, "_items_sharding", lambda: None)
    g2 = GraphStorage(chrm_gfa, index_edges=True)
    mask2 = GraphMask.from_datamgr(
        GraphMaskParameters(groupby_sample=True), g2
    )
    ser = streamed_total_abaci(g2, mask2, cts)
    assert ser is not None
    # the forced path really is the serial one
    assert all(
        ab.engine._m_device() is not None for ab in ser[0].values()
    )
    assert hists_of(base) == hists_of(ser)
    # paths_len parity between the two schedules
    assert base[1].paths_len == ser[1].paths_len


def test_pipelined_schedule_matches_serial(chrm_gfa, monkeypatch):
    """Force the pipelined (device-upload) schedule on one device by
    pretending the rows are not host-placed; results must match the
    serial schedule bit-for-bit."""
    from panacus_jax.ops import engine as eng

    cts = [CountType.NODE, CountType.BP, CountType.EDGE]
    monkeypatch.setattr(eng, "_items_sharding", lambda: None)

    def hists_of(res):
        from panacus_jax.abacus import construct_hists

        return {
            ct: [int(x) for x in h]
            for ct, h in construct_hists(res[0]).items()
        }

    g = GraphStorage(chrm_gfa, index_edges=True)
    mask = GraphMask.from_datamgr(GraphMaskParameters(groupby_sample=True), g)
    ser = streamed_total_abaci(g, mask, cts)
    assert ser is not None

    orig_init = eng.MembershipStream.__init__

    def no_host_init(self, n_items, n_groups):
        orig_init(self, n_items, n_groups)
        self._host_np = False

    monkeypatch.setattr(eng.MembershipStream, "__init__", no_host_init)
    from panacus_jax import stream as stream_mod

    monkeypatch.setattr(stream_mod, "rows_on_host", lambda: False)
    g2 = GraphStorage(chrm_gfa, index_edges=True)
    mask2 = GraphMask.from_datamgr(
        GraphMaskParameters(groupby_sample=True), g2
    )
    pipe = streamed_total_abaci(g2, mask2, cts)
    assert pipe is not None
    assert hists_of(ser) == hists_of(pipe)
    assert ser[1].paths_len == pipe[1].paths_len


def test_serial_edge_only(chrm_gfa, monkeypatch):
    """Edge-only runs in the serial schedule: phase A only tokenizes and
    stashes (no node stream exists), phase B builds the edge rows. Must
    match the classic itemizer's edge abacus."""
    from panacus_jax.ops import engine as eng

    monkeypatch.setattr(eng, "_items_sharding", lambda: None)
    cts = [CountType.EDGE]
    g = GraphStorage(chrm_gfa, index_edges=True)
    mask = GraphMask.from_datamgr(GraphMaskParameters(groupby_sample=True), g)
    res = streamed_total_abaci(g, mask, cts)
    assert res is not None
    classic, _ = classic_abaci(g, mask, cts)
    import numpy as np

    got = np.asarray(res[0][CountType.EDGE].countable)
    want = np.asarray(classic[CountType.EDGE].countable)
    assert np.array_equal(got, want)
