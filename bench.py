#!/usr/bin/env python
"""Benchmark: end-to-end histgrowth throughput on a seeded pangenome graph
at HPRC-chr22 scale, on the GPU.

Stages (all through the production broker path, M on the default device):
`histgrowth -c all` (node+bp+edge hists and growth curves,
`-q 0,0.5,1.0 -l 0,1,2`), node-only, edge-only and gzip-input node-only,
each reported as GFA MB/s beside the reference panacus's own CPU wall clock
on the 402 MB HPRC chr22 pggb graph (~17 s node, ~79 s edge; BASELINE.md).

Prints ONE JSON line naming the device it ran on: platform, device_kind,
device count, and the card's name and power limit. A run whose default
device is not a GPU fails. Run: `python bench.py`.

The synthetic graph (seeded, written under `.bench_data/`) mimics an HPRC
pggb GFA: P- and W-lines dominate the bytes, 45 samples x 2 haplotypes = 90
haplotype groups, integer node names, short segments.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import numpy as np

BASELINE_ALL_MBPS = 402.0 / (17.0 + 79.0)
BASELINE_NODE_MBPS = 402.0 / 17.0
BASELINE_EDGE_MBPS = 402.0 / 79.0

N_NODES = int(os.environ.get("PANACUS_BENCH_NODES", 900_000))
N_PATHS = int(os.environ.get("PANACUS_BENCH_PATHS", 90))
MAX_GAP = 4
SEED = 7
GEN_VERSION = 6  # bump when make_graph changes
DATA_DIR = os.path.join(ROOT, ".bench_data")
GRAPH = os.path.join(
    DATA_DIR, f"graph_v{GEN_VERSION}_{N_NODES}_{N_PATHS}_{SEED}.gfa"
)


def graph_draws(n_nodes=N_NODES, n_paths=N_PATHS, seed=SEED):
    """(node lengths [n_nodes], gap pool) — every random draw of the graph."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, 17, size=n_nodes)
    gap_pool = rng.integers(
        1, MAX_GAP + 1, size=n_nodes + n_paths, dtype=np.int64
    )
    return lens, gap_pool


def path_visits(gap_pool, p: int, n_nodes: int) -> np.ndarray:
    """Strictly increasing 1-based node ids that path p visits."""
    visits = 1 + np.cumsum(gap_pool[p : p + n_nodes])
    return visits[: np.searchsorted(visits, n_nodes, side="right")]


def make_graph(path: str, n_nodes=N_NODES, n_paths=N_PATHS, seed=SEED) -> None:
    """Deterministic pggb-like graph at chr22-pggb scale by default
    (337 MB; the reference baseline graph is 402 MB): path lines dominate
    the bytes, integer node names, short segments. n_paths/2 samples x 2
    haplotypes; haplotype 0 is a P line (PanSN name), haplotype 1 a W line
    — HPRC graphs carry both spellings. Each path walks the node line with
    gaps in 1..MAX_GAP and every (u, u+g) pair is declared as an L line, so
    paths are edge-consistent by construction."""
    t0 = time.time()
    lens, gap_pool = graph_draws(n_nodes, n_paths, seed)
    seq_pool = ("ACGT" * 5)[:16]
    n_edges = sum(n_nodes - g for g in range(1, MAX_GAP + 1))

    def join_lines(parts, sep=b"\n"):
        return sep.join(parts.tolist()) + sep

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path + ".tmp", "wb") as f:
        f.write(b"H\tVN:Z:1.0\n")
        names = np.arange(1, n_nodes + 1).astype("S12")
        seqs = np.array(
            [seq_pool[:k].encode() for k in range(1, 17)], dtype="S16"
        )[lens - 1]
        s_lines = np.char.add(np.char.add(b"S\t", names), b"\t")
        f.write(join_lines(np.char.add(s_lines, seqs)))
        del s_lines, seqs
        for g in range(1, MAX_GAP + 1):
            eu = names[: n_nodes - g]
            ev = names[g:]
            l_lines = np.char.add(
                np.char.add(np.char.add(b"L\t", eu), b"\t+\t"),
                np.char.add(ev, b"\t+\t0M"),
            )
            f.write(join_lines(l_lines))
            del l_lines
        for p in range(n_paths):
            sample, hap = p // 2, p % 2
            visits = path_visits(gap_pool, p, n_nodes)
            if hap == 0:
                toks = np.char.add(visits.astype("S12"), b"+")
                f.write(f"P\ts{sample}#0#chr1\t".encode())
                f.write(join_lines(toks, sep=b",")[:-1])
                f.write(b"\t*\n")
            else:
                toks = np.char.add(b">", visits.astype("S12"))
                f.write(f"W\ts{sample}\t1\tchr1\t*\t*\t".encode())
                f.write(b"".join(toks.tolist()))
                f.write(b"\n")
    os.replace(path + ".tmp", path)
    sys.stderr.write(
        f"[bench] generated {path}: {os.path.getsize(path) / 1e6:.1f} MB, "
        f"{n_edges} edges, in {time.time() - t0:.1f}s\n"
    )


def card_info() -> str:
    """`name, power.limit` of the visible cards, as nvidia-smi reports them."""
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        timeout=60,
        check=True,
    )
    return "; ".join(ln.strip() for ln in r.stdout.splitlines() if ln.strip())


def _broker_pieces(gfa: str, count_types, index_edges: bool):
    """GraphStorage -> mask -> streamed (or classic) abaci: the production
    counting path (panacus_jax/stream.py + broker.py)."""
    from panacus_jax.abacus import AbacusByTotal, path_order_groups
    from panacus_jax.gfa import GraphStorage
    from panacus_jax.itemize import itemize_paths
    from panacus_jax.mask import GraphMask, GraphMaskParameters
    from panacus_jax.stream import streamed_total_abaci

    t0 = time.time()
    g = GraphStorage(gfa, index_edges=index_edges)
    mask = GraphMask.from_datamgr(
        GraphMaskParameters(groupby_haplotype=True), g
    )
    t_index = time.time() - t0

    t1 = time.time()
    res = streamed_total_abaci(g, mask, count_types)
    if res is None:  # fallback: classic path
        itemized = itemize_paths(g, mask, count_types)
        path_order, groups = path_order_groups(mask, g.path_segments)
        abaci = {
            ct: AbacusByTotal.from_itemization(
                ct, slot, itemized, path_order, groups, g
            )
            for slot, ct in enumerate(count_types)
        }
    else:
        abaci = res[0]
    t_stream = time.time() - t1
    return g, abaci, (t_index, t_stream)


def placement_of(engine) -> str:
    """Where the membership matrix lives: its device's platform, or
    'sharded:<n>' when it is item-sharded over n devices."""
    dev = engine._m_device()
    if dev is None:
        return f"sharded:{len(engine.M.devices())}"
    return dev.platform


def run_histgrowth(gfa: str, count: str):
    """One histgrowth run. count: 'all' | 'node' | 'edge'. Returns
    (hists dict, growth count, phase times). Records the M placement of
    the last run in run_histgrowth.placement."""
    from panacus_jax.abacus import construct_hists
    from panacus_jax.hist import Hist
    from panacus_jax.utils import CountType, ThresholdContainer

    counts = {
        "all": [CountType.NODE, CountType.BP, CountType.EDGE],
        "node": [CountType.NODE],
        "edge": [CountType.EDGE],
    }[count]
    g, abaci, (t_index, t_stream) = _broker_pieces(
        gfa, counts, index_edges=CountType.EDGE in counts
    )
    run_histgrowth.placement = placement_of(next(iter(abaci.values())).engine)

    # device tail: every membership row is already resident after the
    # streamed build, so this is the fused hist dispatches + result fetch
    t2 = time.time()
    hists = {
        ct: Hist(ct, [int(x) for x in h])
        for ct, h in construct_hists(abaci).items()
    }
    t_tail = time.time() - t2

    t3 = time.time()
    tc = ThresholdContainer.parse_params("0,0.5,1.0", "0,1,2")
    n_growth = 0
    for h in hists.values():
        n_growth += len(h.calc_all_growths(tc))
    t_growth = time.time() - t3
    return hists, n_growth, (t_index, t_stream, t_tail, t_growth)


def _timed_stage(name, fn, size_mb, baseline, reps=6):
    """Warm-up + best-of-reps wall clock; logs phases; returns best MB/s."""
    import gc

    fn()  # warm-up: compile cache, transfer shapes, page heat
    best = None
    for rep in range(reps):
        gc.collect()
        t0 = time.time()
        _, _, phases = fn()
        wall = time.time() - t0
        sys.stderr.write(
            f"[bench] {name} pass {rep}: {size_mb:.1f} MB in {wall:.2f}s "
            f"(index {phases[0]:.2f}s, stream {phases[1]:.2f}s, "
            f"device-tail {phases[2]:.3f}s, growth {phases[3]:.2f}s)\n"
        )
        if best is None or wall < best:
            best = wall
    mbps = size_mb / best
    sys.stderr.write(
        f"[bench] {name}: {mbps:.1f} MB/s "
        f"(reference {baseline:.1f} MB/s => {mbps / baseline:.1f}x)\n"
    )
    return mbps


def main() -> None:
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench: needs a GPU, default device is {dev.platform}")
    card = card_info()
    gfa = GRAPH
    if not os.path.exists(gfa):
        make_graph(gfa)
    size_mb = os.path.getsize(gfa) / 1e6
    gz = gfa + ".gz"
    if not os.path.exists(gz):
        subprocess.run(["gzip", "-1", "-k", "-f", gfa], check=True)

    stages = {}
    for sname, count, src, baseline in (
        ("all", "all", gfa, BASELINE_ALL_MBPS),
        ("node", "node", gfa, BASELINE_NODE_MBPS),
        ("edge", "edge", gfa, BASELINE_EDGE_MBPS),
        ("gz_node", "node", gz, BASELINE_NODE_MBPS),
    ):
        stages[sname] = _timed_stage(
            f"histgrowth {sname}",
            lambda c=count, s=src: run_histgrowth(s, c),
            size_mb,
            baseline,
            reps=6 if sname == "all" else 4,
        )
    print(
        json.dumps(
            {
                "metric": "histgrowth_all_throughput",
                "value": stages["all"],
                "unit": "MB/s",
                "stages": stages,
                "placement": getattr(run_histgrowth, "placement", None),
                "platform": dev.platform,
                "device_kind": dev.device_kind,
                "count": len(jax.devices()),
                "card": card,
            }
        )
    )


if __name__ == "__main__":
    main()
