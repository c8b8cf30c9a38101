"""Streamed gzip ingest (gfa._read_gz_streamed): single- and multi-member
.gz inputs must index identically to the plain file (the reference reads
through MultiGzDecoder, src/io.rs:23-33, so concatenated gzip members are
valid input)."""

import gzip

import numpy as np

from panacus_jax.gfa import GraphStorage
from panacus_jax.mask import GraphMask, GraphMaskParameters
from panacus_jax.stream import streamed_total_abaci
from panacus_jax.utils import CountType


def hist_of(path):
    import pytest

    g = GraphStorage(path, index_edges=False)
    mask = GraphMask.from_datamgr(GraphMaskParameters(groupby_sample=True), g)
    res = streamed_total_abaci(g, mask, [CountType.NODE])
    if res is None:
        pytest.skip("native batch tokenizer unavailable (streamed build)")
    abaci = res[0]
    return g, abaci[CountType.NODE].construct_hist()


def test_gz_single_member(chrm_gfa, tmp_path):
    gz = tmp_path / "g.gfa.gz"
    with open(chrm_gfa, "rb") as src, gzip.open(gz, "wb") as dst:
        dst.write(src.read())
    g_plain, h_plain = hist_of(chrm_gfa)
    g_gz, h_gz = hist_of(str(gz))
    assert g_gz.node_count == g_plain.node_count
    np.testing.assert_array_equal(h_gz, h_plain)


def test_gz_multi_member(chrm_gfa, tmp_path):
    """Concatenated gzip members (bgzip-style) decompress as one stream."""
    data = open(chrm_gfa, "rb").read()
    half = len(data) // 2
    gz = tmp_path / "m.gfa.gz"
    with open(gz, "wb") as f:
        f.write(gzip.compress(data[:half]))
        f.write(gzip.compress(data[half:]))
    g_plain, h_plain = hist_of(chrm_gfa)
    g_gz, h_gz = hist_of(str(gz))
    assert g_gz.node_count == g_plain.node_count
    np.testing.assert_array_equal(h_gz, h_plain)


def test_corrupt_gz_raises(tmp_path):
    """A corrupt stream must fail loudly through the zlib fallback (the
    libdeflate fast path returns None on malformed input)."""
    import pytest

    bad = tmp_path / "bad.gfa.gz"
    data = gzip.compress(b"H\tVN:Z:1.0\nS\t1\tA\n")
    bad.write_bytes(data[:10] + b"\xde\xad\xbe\xef" + data[14:])
    with pytest.raises(Exception):
        GraphStorage(str(bad), index_edges=False)


def test_libdeflate_multimember_with_padding(chrm_gfa, tmp_path):
    """bgzip-style zero padding after the last member is accepted (the
    reference's MultiGzDecoder behavior, src/io.rs:23-33)."""
    data = open(chrm_gfa, "rb").read()
    gz = tmp_path / "pad.gfa.gz"
    with open(gz, "wb") as f:
        f.write(gzip.compress(data[: len(data) // 2]))
        f.write(gzip.compress(data[len(data) // 2 :]))
        f.write(b"\x00" * 28)
    g_plain, h_plain = hist_of(chrm_gfa)
    g_gz, h_gz = hist_of(str(gz))
    assert g_gz.node_count == g_plain.node_count
    np.testing.assert_array_equal(h_gz, h_plain)
