"""Randomized parser parity: native C paths vs numpy fallbacks.

The native surface (structural scan, S-span parser, batch tokenizer,
edge indexer/adjacency, membership/edge packers) and the numpy fallback
implementations must be indistinguishable through the public counting
results. Each seed generates a small random GFA — integer or string node
names, P and W lines, random orientations/lengths, duplicate L lines —
and compares hist/paths_len across:

  native+streamed  vs  native+classic  vs  all-fallback+classic

Monkeypatching native.get_lib to return None flips every binding to its
fallback (each binding re-resolves get_lib per call).
"""

import numpy as np
import pytest

from panacus_jax import native
from panacus_jax.abacus import construct_hists
from panacus_jax.gfa import GraphStorage
from panacus_jax.itemize import itemize_paths
from panacus_jax.mask import GraphMask, GraphMaskParameters
from panacus_jax.stream import streamed_total_abaci
from panacus_jax.utils import CountType

CTS = [CountType.NODE, CountType.BP, CountType.EDGE]


def _random_gfa(tmp_path, rng, int_names: bool, with_walks: bool):
    n_nodes = int(rng.integers(20, 120))
    if int_names:
        names = [str(v) for v in rng.permutation(np.arange(1, n_nodes + 1))]
    else:
        # adversarial string names: variable length, digit-heavy, shared
        # prefixes/suffixes (exercise the mode-3 name-hash memcmp)
        chars = list("abcXYZ0123456789_.")
        names = []
        seen = set()
        for v in range(n_nodes):
            nm = "".join(
                rng.choice(chars, size=int(rng.integers(1, 10)))
            )
            if nm in seen or nm.isdigit():
                nm = f"{nm}_u{v}"
            seen.add(nm)
            names.append(nm)
    lens = rng.integers(1, 12, size=n_nodes)
    lines = ["H\tVN:Z:1.0"]
    for i, nm in enumerate(names):
        tag = "\tSN:Z:c1" if rng.random() < 0.3 else ""
        lines.append(f"S\t{nm}\t{'ACGT'[int(rng.integers(4))] * int(lens[i])}{tag}")
    n_paths = int(rng.integers(2, 7))
    edge_set = set()
    paths = []
    for p in range(n_paths):
        k = int(rng.integers(2, max(3, n_nodes // 2)))
        visit = rng.integers(0, n_nodes, size=k)
        orient = rng.integers(0, 2, size=k)
        paths.append((visit, orient))
        for j in range(k - 1):
            u, o1 = int(visit[j]), int(orient[j])
            v, o2 = int(visit[j + 1]), int(orient[j + 1])
            cu, co1, cv, co2 = (
                (v, 1 - o2, u, 1 - o1)
                if (u > v or (u == v and o1))
                else (u, o1, v, o2)
            )
            edge_set.add((cu, co1, cv, co2))
    sym = "+-"
    for (u, o1, v, o2) in sorted(edge_set):
        lines.append(f"L\t{names[u]}\t{sym[o1]}\t{names[v]}\t{sym[o2]}\t0M")
        if rng.random() < 0.15:  # duplicate L line (reference warns + dedupes)
            lines.append(f"L\t{names[u]}\t{sym[o1]}\t{names[v]}\t{sym[o2]}\t0M")
    for p, (visit, orient) in enumerate(paths):
        if with_walks and p % 2 == 1:
            walk = "".join(
                ("<" if orient[j] else ">") + names[visit[j]]
                for j in range(len(visit))
            )
            lines.append(f"W\ts{p}\t1\tc1\t0\t{len(visit)}\t{walk}")
        else:
            seq = ",".join(
                names[visit[j]] + sym[orient[j]] for j in range(len(visit))
            )
            lines.append(f"P\ts{p}#1#c1\t{seq}\t*")
    f = tmp_path / "fuzz.gfa"
    f.write_text("\n".join(lines) + "\n")
    return str(f)


def _hists_classic(gfa):
    g = GraphStorage(gfa, index_edges=True)
    mask = GraphMask.from_datamgr(GraphMaskParameters(groupby_sample=True), g)
    from panacus_jax.abacus import AbacusByTotal, path_order_groups

    itemized = itemize_paths(g, mask, CTS)
    path_order, groups = path_order_groups(mask, g.path_segments)
    abaci = {
        ct: AbacusByTotal.from_itemization(
            ct, slot, itemized, path_order, groups, g
        )
        for slot, ct in enumerate(CTS)
    }
    hists = {
        str(ct): [int(x) for x in h]
        for ct, h in construct_hists(abaci).items()
    }
    plens = {
        seg.id(): v for seg, v in itemized.paths_len.items()
    }
    return hists, plens


def _hists_streamed(gfa):
    g = GraphStorage(gfa, index_edges=True)
    mask = GraphMask.from_datamgr(GraphMaskParameters(groupby_sample=True), g)
    res = streamed_total_abaci(g, mask, CTS)
    if res is None:
        return None
    hists = {
        str(ct): [int(x) for x in h]
        for ct, h in construct_hists(res[0]).items()
    }
    plens = {seg.id(): v for seg, v in res[1].paths_len.items()}
    return hists, plens


@pytest.mark.parametrize("seed", range(8))
def test_native_vs_fallback_random_graphs(tmp_path, monkeypatch, seed):
    rng = np.random.default_rng(seed)
    int_names = seed % 2 == 0
    gfa = _random_gfa(tmp_path, rng, int_names, with_walks=seed % 3 == 0)

    native_classic = _hists_classic(gfa)
    native_streamed = _hists_streamed(gfa)
    # the streamed build engages for int names AND (since the mode-3 name
    # hash) string names whenever the native lib is present
    assert native_streamed is not None
    assert native_streamed == native_classic

    # flip every native binding to its numpy fallback
    monkeypatch.setattr(native, "get_lib", lambda: None)
    fallback = _hists_classic(gfa)
    assert fallback == native_classic
