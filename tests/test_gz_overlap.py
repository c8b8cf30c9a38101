"""Overlapped gz ingest (gz_pipeline): the follower's products — line
classify, S-line index, tokenize cache — must be bit-identical to the
classic post-inflate indexing on every input shape, and every degradation
path must fall back silently."""

import gzip

import numpy as np
import pytest

from panacus_jax.gfa import GraphStorage
from panacus_jax.gz_pipeline import read_gz_overlapped
from panacus_jax.mask import GraphMask, GraphMaskParameters
from panacus_jax.stream import streamed_total_abaci
from panacus_jax.utils import CountType


def make_graph_text(n_nodes=60_000, n_paths=12, int_names=True, walks=True):
    """Synthetic GFA big enough (~10 MB) that the follower processes real
    chunks; deterministic."""
    rng = np.random.default_rng(11)
    lines = ["H\tVN:Z:1.0"]
    name = (lambda i: str(i + 1)) if int_names else (lambda i: f"s{i + 1}")
    for i in range(n_nodes):
        lines.append(f"S\t{name(i)}\t{'ACGT'[i % 4] * (1 + i % 7)}")
    for p in range(n_paths):
        ids = rng.integers(0, n_nodes, size=9000)
        ori = rng.integers(0, 2, size=9000)
        if walks and p % 2:
            body = "".join(
                ("<" if o else ">") + name(i) for i, o in zip(ids, ori)
            )
            lines.append(f"W\tsample{p}\t0\tchr1\t0\t100\t{body}")
        else:
            body = ",".join(
                name(i) + ("-" if o else "+") for i, o in zip(ids, ori)
            )
            lines.append(f"P\tsample{p}#0#chr1\t{body}\t*")
    return ("\n".join(lines) + "\n").encode()


def write_pair(tmp_path, data, tag="g"):
    plain = tmp_path / f"{tag}.gfa"
    gz = tmp_path / f"{tag}.gfa.gz"
    plain.write_bytes(data)
    with gzip.open(gz, "wb", compresslevel=1) as f:
        f.write(data)
    return str(plain), str(gz)


def storages_equal(a: GraphStorage, b: GraphStorage):
    assert a.node_count == b.node_count
    np.testing.assert_array_equal(a.node_lens, b.node_lens)
    np.testing.assert_array_equal(a._line_starts, b._line_starts)
    np.testing.assert_array_equal(a._line_ends, b._line_ends)
    assert a._int_name_mode == b._int_name_mode
    assert [str(s) for s in a.path_segments] == [
        str(s) for s in b.path_segments
    ]
    ra = a.all_path_item_runs()
    rb = b.all_path_item_runs()
    if ra is None or rb is None:
        assert ra is None and rb is None
        return
    for xa, xb in zip(ra, rb):
        if xa is None:
            assert xb is None
        else:
            np.testing.assert_array_equal(np.asarray(xa), np.asarray(xb))


def hist_pair(plain, gz):
    out = []
    for p in (plain, gz):
        g = GraphStorage(p, index_edges=False)
        mask = GraphMask.from_datamgr(
            GraphMaskParameters(groupby_sample=True), g
        )
        res = streamed_total_abaci(g, mask, [CountType.NODE, CountType.BP])
        if res is None:
            pytest.skip("native batch tokenizer unavailable")
        out.append(
            (res[0][CountType.NODE].construct_hist(), g)
        )
    return out


def test_identity_names_pretok_parity(tmp_path):
    data = make_graph_text()
    plain, gz = write_pair(tmp_path, data)
    (h_p, g_p), (h_g, g_g) = hist_pair(plain, gz)
    np.testing.assert_array_equal(h_p, h_g)
    storages_equal(g_p, g_g)
    # the identity graph must actually have produced a tokenize cache
    assert g_g._pretok is not None


def test_sorted_int_names_pretok_parity(tmp_path):
    """Non-dense integer names: mode-2 (sorted lookup) tokenize cache."""
    data = make_graph_text(n_nodes=30_000).replace(b"S\t1\t", b"S\t900001\t")
    # renaming node 1 -> 900001 breaks identity; fix the path references too
    data = (
        data.replace(b">1<", b">900001<")
        .replace(b"<1>", b"<900001>")
        .replace(b",1+", b",900001+")
        .replace(b",1-", b",900001-")
        .replace(b"\t1+", b"\t900001+")
        .replace(b"\t1-", b"\t900001-")
        .replace(b">1>", b">900001>")
        .replace(b"<1<", b"<900001<")
    )
    plain, gz = write_pair(tmp_path, data, "sorted")
    (h_p, g_p), (h_g, g_g) = hist_pair(plain, gz)
    assert g_g._int_name_mode == "sorted"
    np.testing.assert_array_equal(h_p, h_g)
    storages_equal(g_p, g_g)


def test_string_names_fallback_parity(tmp_path):
    """String names: no tokenize cache, but the follower's line classify
    and S spans are still adopted — outputs identical to plain."""
    data = make_graph_text(n_nodes=20_000, int_names=False)
    plain, gz = write_pair(tmp_path, data, "str")
    g_p = GraphStorage(plain, index_edges=False)
    g_g = GraphStorage(gz, index_edges=False)
    assert g_g._int_name_mode is None
    assert g_g._pretok is None
    storages_equal(g_p, g_g)


def test_late_s_line_falls_back(tmp_path):
    """An S line after the first P line invalidates the follower's S
    products; indexing must still be correct."""
    data = make_graph_text(n_nodes=5_000, n_paths=4)
    # append one more S line AFTER the paths, and a path using it
    extra = b"S\t5001\tACGT\nP\tlate#0#c\t5001+\t*\n"
    data += extra
    plain, gz = write_pair(tmp_path, data, "late")
    g_p = GraphStorage(plain, index_edges=False)
    g_g = GraphStorage(gz, index_edges=False)
    assert g_g.node_count == 5001
    storages_equal(g_p, g_g)


def test_crlf_and_no_trailing_newline(tmp_path):
    data = make_graph_text(n_nodes=3_000, n_paths=2)
    data = data.replace(b"\n", b"\r\n")[:-2] + b"\r\nS\t3001\tACGT"
    plain, gz = write_pair(tmp_path, data, "crlf")
    g_p = GraphStorage(plain, index_edges=False)
    g_g = GraphStorage(gz, index_edges=False)
    assert g_g.node_count == g_p.node_count == 3001
    storages_equal(g_p, g_g)


def test_content_0xff_stalls_but_correct(tmp_path):
    """A 0xFF byte in the content (invalid ASCII, but the indexer doesn't
    care) can stall the frontier — never corrupt the result."""
    data = make_graph_text(n_nodes=3_000, n_paths=2)
    data = data.replace(b"S\t2\tC", b"S\t2\t\xff", 1)
    plain, gz = write_pair(tmp_path, data, "ff")
    g_p = GraphStorage(plain, index_edges=False)
    g_g = GraphStorage(gz, index_edges=False)
    storages_equal(g_p, g_g)


def test_multi_member_overlap(tmp_path):
    data = make_graph_text(n_nodes=20_000, n_paths=6)
    gz = tmp_path / "mm.gfa.gz"
    third = len(data) // 3
    with open(gz, "wb") as f:
        f.write(gzip.compress(data[:third], 1))
        f.write(gzip.compress(data[third : 2 * third], 1))
        f.write(gzip.compress(data[2 * third :], 1))
    plain = tmp_path / "mm.gfa"
    plain.write_bytes(data)
    g_p = GraphStorage(str(plain), index_edges=False)
    g_g = GraphStorage(str(gz), index_edges=False)
    storages_equal(g_p, g_g)


def test_partial_cache_falls_back_to_tokenizer(tmp_path):
    """A cache-invalidated path makes _runs_from_pretok defer to the full
    tokenizer; results must be unchanged."""
    data = make_graph_text(n_nodes=10_000, n_paths=4)
    plain, gz = write_pair(tmp_path, data, "part")
    g_g = GraphStorage(gz, index_edges=False)
    g_p = GraphStorage(plain, index_edges=False)
    if g_g._pretok is None:
        pytest.skip("no cache built (native unavailable)")
    before = g_g.all_path_item_runs()
    loc, batches = g_g._pretok
    loc[-1] = -1  # poison one entry: selection no longer fully covered
    after = g_g.all_path_item_runs()
    ref = g_p.all_path_item_runs()
    for xa, xb, xr in zip(before, after, ref):
        np.testing.assert_array_equal(np.asarray(xa), np.asarray(xb))
        np.testing.assert_array_equal(np.asarray(xa), np.asarray(xr))


def test_overlap_disable_env(tmp_path, monkeypatch):
    monkeypatch.setenv("PANACUS_NO_GZ_OVERLAP", "1")
    data = make_graph_text(n_nodes=2_000, n_paths=2)
    plain, gz = write_pair(tmp_path, data, "env")
    buf, follow = read_gz_overlapped(gz)
    assert follow is None
    assert bytes(buf) == data
