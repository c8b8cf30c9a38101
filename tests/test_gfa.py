"""Host parser parity: node/edge/path indexing and PanSN path names."""

import numpy as np

from panacus_jax.gfa import GraphStorage, PathSegment


def test_t_groups_counts(t_groups_gfa):
    g = GraphStorage(t_groups_gfa, index_edges=True)
    assert g.node_count == 15
    assert len(g.path_segments) == 6
    assert g.edge_count == 20
    # node lens: S lines in order
    assert g.node_lens[1] == 8  # CAAATAAG
    assert g.node_lens[9] == 19
    assert g.node_lens[15] == 11


def test_t_groups_path_items(t_groups_gfa):
    g = GraphStorage(t_groups_gfa, index_edges=False)
    ids, orient = g.path_item_run(0)  # P y#1: 1+,3+
    assert ids.tolist() == [1, 3]
    assert orient.tolist() == [0, 0]
    ids, orient = g.path_item_run(5)  # P x: all ten nodes
    assert ids.tolist() == [1, 3, 5, 6, 8, 9, 11, 12, 14, 15]


def test_pansn_parsing():
    p = PathSegment.from_str("sample#hap#seq:4-8")
    assert (p.sample, p.haplotype, p.seqid, p.start, p.end) == (
        "sample",
        "hap",
        "seq",
        4,
        8,
    )
    p = PathSegment.from_str("sample#hap")
    assert (p.sample, p.haplotype, p.seqid) == ("sample", "hap", None)
    p = PathSegment.from_str("sample")
    assert (p.sample, p.haplotype, p.seqid) == ("sample", None, None)
    p = PathSegment.from_str("sample:1-5")
    assert (p.sample, p.start, p.end) == ("sample", 1, 5)
    assert PathSegment.from_str("a#1#c").id() == "a#1#c"
    assert str(PathSegment.from_str("a#1#c:1-2")) == "a#1#c:1-2"


def test_pansn_id_forms():
    # reference graph.rs:558-579
    assert PathSegment("s", "h", "c", None, None).id() == "s#h#c"
    assert PathSegment("s", "h", None, None, None).id() == "s#h"
    assert PathSegment("s", None, None, None, None).id() == "s"


def test_chrm_parse(chrm_gfa):
    g = GraphStorage(chrm_gfa, index_edges=True)
    assert len(g.path_segments) == 4
    samples = sorted({p.sample for p in g.path_segments})
    assert samples == ["HG00438", "HG00621", "chm13", "grch38"]
    assert g.node_count == 154
    assert g.edge_count == 205


def test_walk_lines(tmp_path):
    gfa = tmp_path / "w.gfa"
    gfa.write_text(
        "H\tVN:Z:1.0\n"
        "S\t1\tAAA\n"
        "S\t2\tCC\n"
        "S\t3\tG\n"
        "W\tsampleA\t1\tchr1\t0\t6\t>1>2<3\n"
        "W\tsampleB\t1\tchr1\t*\t*\t>3<1\n"
    )
    g = GraphStorage(str(gfa), index_edges=False)
    assert len(g.path_segments) == 2
    p = g.path_segments[0]
    assert (p.sample, p.haplotype, p.seqid, p.start, p.end) == (
        "sampleA",
        "1",
        "chr1",
        0,
        6,
    )
    ids, orient = g.path_item_run(0)
    assert ids.tolist() == [1, 2, 3]
    assert orient.tolist() == [0, 0, 1]
    p2 = g.path_segments[1]
    assert p2.coords() is None
    ids, orient = g.path_item_run(1)
    assert ids.tolist() == [3, 1]
    assert orient.tolist() == [0, 1]


def test_non_integer_node_names(tmp_path):
    gfa = tmp_path / "named.gfa"
    gfa.write_text(
        "S\tfoo\tAAA\n"
        "S\tbar\tCC\n"
        "L\tfoo\t+\tbar\t-\t0M\n"
        "P\tp1\tfoo+,bar-\t*\n"
    )
    g = GraphStorage(str(gfa), index_edges=True)
    assert g.node_count == 2
    ids, orient = g.path_item_run(0)
    assert ids.tolist() == [1, 2]
    assert orient.tolist() == [0, 1]
    assert g.edge_count == 1
    assert g.node_name(1) == "foo"


def test_gzip_input(tmp_path, t_groups_gfa):
    import gzip
    import shutil

    dst = tmp_path / "t.gfa.gz"
    with open(t_groups_gfa, "rb") as fin, gzip.open(dst, "wb") as fout:
        shutil.copyfileobj(fin, fout)
    g = GraphStorage(str(dst), index_edges=True)
    assert g.node_count == 15
    assert g.edge_count == 20


def test_edge_lookup_without_l_lines(tmp_path, monkeypatch):
    # a graph whose paths imply edges that were never declared must raise
    # the reference's unknown-edge error, not an IndexError, also on the
    # numpy fallback path (no native edge hash)
    import pytest

    from panacus_jax.gfa import GraphStorage

    gfa = tmp_path / "noedges.gfa"
    gfa.write_text(
        "H\tVN:Z:1.0\n"
        "S\t1\tAC\n"
        "S\t2\tGG\n"
        "P\ta#0#x\t1+,2+\t*\n"
    )
    g = GraphStorage(str(gfa), index_edges=True)
    g._edge_hash = None  # force the searchsorted fallback
    import numpy as np

    with pytest.raises(ValueError, match="unknown edge"):
        g.edge_ids_for_pairs(
            np.array([1]), np.array([0]), np.array([2]), np.array([0])
        )


def test_s_spans_native_matches_fallback(t_groups_gfa, monkeypatch):
    # same S-line name/len extraction whether pt_s_spans or the numpy
    # tab-index fallback parses (lazy _tabs property materializes only
    # for the fallback)
    from panacus_jax import native

    g_native = GraphStorage(t_groups_gfa, index_edges=True)
    monkeypatch.setattr(native, "s_spans", lambda *a, **k: None)
    g_fb = GraphStorage(t_groups_gfa, index_edges=True)
    assert g_fb._tabs_arr is not None  # fallback materialized the index
    assert g_native.node_lens.tolist() == g_fb.node_lens.tolist()
    assert g_native.node_count == g_fb.node_count
    for iid in (1, 7, 15):
        assert g_native.node_name(iid) == g_fb.node_name(iid)
    assert g_native.edge_count == g_fb.edge_count


def test_s_line_optional_tags(tmp_path):
    # sequence length must stop at the tag field tab, not the line end
    gfa = tmp_path / "tags.gfa"
    gfa.write_text(
        "H\tVN:Z:1.0\n"
        "S\t1\tACGT\tLN:i:4\tSN:Z:chr1\n"
        "S\t2\tGG\n"
        "P\ta#0#x\t1+,2+\t*\n"
        "L\t1\t+\t2\t+\t0M\n"
    )
    g = GraphStorage(str(gfa), index_edges=True)
    assert g.node_lens[1] == 4
    assert g.node_lens[2] == 2
    assert g.node_name(1) == "1"


def test_malformed_s_line_raises(tmp_path):
    import pytest

    gfa = tmp_path / "bad.gfa"
    gfa.write_text("H\tVN:Z:1.0\nS\tnotab\nP\ta#0#x\t1+\t*\n")
    with pytest.raises(ValueError, match="malformed S record"):
        GraphStorage(str(gfa), index_edges=False)


def test_walk_metadata_star_spans(tmp_path):
    # W-line '*' start/end columns parse to open-ended PathSegments with
    # the per-line find parser (no global tab index)
    gfa = tmp_path / "w.gfa"
    gfa.write_text(
        "H\tVN:Z:1.1\n"
        "S\t1\tAC\n"
        "S\t2\tGG\n"
        "W\tsamp\t1\tchr1\t*\t*\t>1>2\n"
        "W\tsamp\t2\tchr1\t5\t9\t>1\n"
    )
    g = GraphStorage(str(gfa), index_edges=False)
    assert len(g.path_segments) == 2
    p0, p1 = g.path_segments
    assert (p0.sample, p0.haplotype, p0.seqid) == ("samp", "1", "chr1")
    assert (p0.start, p0.end) == (None, None)
    assert (p1.start, p1.end) == (5, 9)
    ids, orient = g.path_item_run(0)
    assert ids.tolist() == [1, 2]
