"""Parity between the streamed slab builder (stream.py) and the classic
interval-walking itemizer (itemize.py) on surfaces the two fill in
different loops — VERDICT r2 polish items:

- paths_len on a W-line-heavy fixture (stream.py fills it in the slab
  loop, itemize.py per path line),
- multi-member gzip ingest with members at non-trivial sizes (the
  libdeflate member loop + capacity-growth path; the tiny chrM fixture's
  members fit the first allocation).
"""

import gzip
import os

import numpy as np
import pytest

from panacus_jax.gfa import GraphStorage
from panacus_jax.itemize import itemize_paths
from panacus_jax.mask import GraphMask, GraphMaskParameters
from panacus_jax.stream import streamed_total_abaci
from panacus_jax.utils import CountType


def _walk_heavy_gfa(tmp_path, n_nodes=400, n_samples=6):
    """Graph where most haplotypes are W lines (plus one ungrouped-by-
    sample P line with a plain name, exercising the trailing no-bit
    slab)."""
    rng = np.random.default_rng(23)
    lens = rng.integers(1, 11, size=n_nodes + 1)
    lines = ["H\tVN:Z:1.0"]
    for v in range(1, n_nodes + 1):
        lines.append(f"S\t{v}\t{'G' * int(lens[v])}")
    for s in range(n_samples):
        for hap in (1, 2):
            k = int(rng.integers(n_nodes // 3, n_nodes))
            visits = np.sort(
                rng.choice(np.arange(1, n_nodes + 1), k, replace=False)
            )
            toks = "".join(f">{v}" for v in visits)
            lines.append(f"W\ts{s}\t{hap}\tchr1\t0\t{k}\t{toks}")
    # one P line with PanSN coords (clear_coords path)
    visits = np.arange(1, 50)
    toks = ",".join(f"{v}+" for v in visits)
    lines.append(f"P\tzz#0#chrX:100-200\t{toks}\t*")
    p = tmp_path / "walks.gfa"
    p.write_text("\n".join(lines) + "\n")
    return str(p)


def test_paths_len_parity_streamed_vs_classic(tmp_path):
    gfa = _walk_heavy_gfa(tmp_path)
    g = GraphStorage(gfa, index_edges=False)
    mask = GraphMask.from_datamgr(
        GraphMaskParameters(groupby_sample=True), g
    )
    res = streamed_total_abaci(g, mask, [CountType.NODE, CountType.BP])
    if res is None:
        pytest.skip("native batch tokenizer unavailable")
    _, streamed_itemized, path_order, groups = res
    classic = itemize_paths(g, mask, [CountType.NODE, CountType.BP])
    assert streamed_itemized.paths_len == classic.paths_len
    assert len(streamed_itemized.paths_len) == len(g.path_segments)


def test_gz_multimember_large_members(tmp_path):
    """Three concatenated gzip members, each tens of MB uncompressed (the
    chr22 shape: bgzip-style concatenation of big blocks). The hist must
    match the plain-file run and the libdeflate buffer must grow past its
    footer hint (the ISIZE of the LAST member only)."""
    rng = np.random.default_rng(5)
    n_nodes = 250_000
    lines = ["H\tVN:Z:1.0"]
    for v in range(1, n_nodes + 1):
        lines.append(f"S\t{v}\tACGTACGT")
    for p in range(4):
        visits = np.arange(1, n_nodes + 1, p + 1)
        toks = ",".join(f"{v}+" for v in visits)
        lines.append(f"P\ts{p}#0#chr1\t{toks}\t*")
    data = ("\n".join(lines) + "\n").encode()
    assert len(data) > 3 * (1 << 21)  # ~2.8 MB per member
    plain = tmp_path / "big.gfa"
    plain.write_bytes(data)
    gz = tmp_path / "big.gfa.gz"
    third = len(data) // 3
    with open(gz, "wb") as f:
        f.write(gzip.compress(data[:third], 1))
        f.write(gzip.compress(data[third : 2 * third], 1))
        f.write(gzip.compress(data[2 * third :], 1))

    def hist_of(path):
        g = GraphStorage(path, index_edges=False)
        mask = GraphMask.from_datamgr(
            GraphMaskParameters(groupby_sample=True), g
        )
        res = streamed_total_abaci(g, mask, [CountType.NODE])
        if res is None:
            pytest.skip("native batch tokenizer unavailable")
        return g, res[0][CountType.NODE].construct_hist()

    g_plain, h_plain = hist_of(str(plain))
    g_gz, h_gz = hist_of(str(gz))
    assert g_gz.node_count == g_plain.node_count == n_nodes
    np.testing.assert_array_equal(h_gz, h_plain)
