"""Multi-host ingest: partition the path set across hosts, tokenize only
the local slice, and merge partial membership matrices.

The reference is strictly single-process (rayon threads only,
src/lib.rs:55-67); this is a multi-process scale-out design from the
ground up: P/W lines are independent given the node table, and the membership
build is a commutative OR, so any partition of the path set produces the
same matrix. Each host:

  1. indexes the GFA structure (S lines + path spans — a cheap scan
     relative to tokenizing the path payload, which is 70-95% of the
     bytes),
  2. tokenizes ONLY the paths of its payload-balanced contiguous group
     range (`multihost_total_abaci` — the PRODUCTION path: GraphBroker
     routes here whenever `jax.process_count() > 1`),
  3. contributes its (bit-disjoint) partial word rows to the global M via
     `jax.make_array_from_single_device_arrays` + one jitted
     gather-and-add reshard (`assemble_global_matrix`).

`init_distributed()` wires `jax.distributed.initialize` from coordinator
env vars; `cli.run_cli` calls it on startup. tests/test_multihost.py
drives two REAL jax.distributed processes through the broker and the
CLI; tests/test_ingest.py covers the single-process partition/merge
invariants of the path-sliced helpers (`host_path_slice`,
`partial_membership`, `merge_partials`).
"""

from __future__ import annotations

import logging
import os
from typing import List, Tuple

import numpy as np

from ..gfa import GraphStorage
from ..mask import GraphMask

log = logging.getLogger("panacus")


def init_distributed() -> bool:
    """Initialize the JAX distributed runtime when multi-host env vars are
    present (JAX_COORDINATOR_ADDRESS + JAX_NUM_PROCESSES + JAX_PROCESS_ID,
    or a cluster environment jax.distributed discovers). Returns True when running
    multi-host."""
    import jax

    coord = os.environ.get("JAX_COORDINATOR_ADDRESS")
    nproc = os.environ.get("JAX_NUM_PROCESSES")
    if coord and nproc:
        jax.distributed.initialize(
            coordinator_address=coord,
            num_processes=int(nproc),
            process_id=int(os.environ.get("JAX_PROCESS_ID", "0")),
        )
        log.info(
            "distributed runtime: process %d/%s", jax.process_index(), nproc
        )
        return True
    try:
        if jax.process_count() > 1:
            return True
    except Exception:
        pass
    return False


def host_path_slice(n_paths: int, host_id: int, n_hosts: int) -> np.ndarray:
    """Contiguous, balanced partition of path indices across hosts."""
    bounds = np.linspace(0, n_paths, n_hosts + 1).astype(np.int64)
    return np.arange(bounds[host_id], bounds[host_id + 1], dtype=np.int64)


def partial_membership(
    graph: GraphStorage,
    mask: GraphMask,
    path_indices: np.ndarray,
    n_items: int,
    n_items_pad: int,
) -> Tuple[np.ndarray, List[str]]:
    """One host's contribution to the packed membership matrix: OR of the
    group bits of every path in `path_indices` (no masks — masked runs use
    the full itemizer). Returns (M_partial, ordered group names).

    The global group-index mapping comes from the mask's full path order,
    so every host assigns identical columns; the merge is a plain
    bitwise-OR (or a device psum of disjoint bits)."""
    from ..abacus import path_order_groups

    path_order, groups = path_order_groups(mask, graph.path_segments)
    group_of = {p: g for p, g in path_order}
    n_groups = len(groups)
    n_words = max((n_groups + 31) // 32, 1)
    M = np.zeros((n_words, n_items_pad), dtype=np.uint32)

    sel = np.asarray(
        [p for p in path_indices if p in group_of], dtype=np.int64
    )
    batch = graph.all_path_item_runs(sel)
    if batch is not None:
        ids, _orient, prefsum, _bp = batch
        for k, p in enumerate(sel):
            g = group_of[int(p)]
            run = ids[prefsum[k] : prefsum[k + 1]]
            M[g >> 5, run] |= np.uint32(1 << (g & 31))
    else:
        for p in sel:
            g = group_of[int(p)]
            run, _ = graph.path_item_run(int(p))
            M[g >> 5, run] |= np.uint32(1 << (g & 31))
    M[:, 0] = 0
    M[:, n_items + 1 :] = 0
    return M, groups


def merge_partials(partials: List[np.ndarray]) -> np.ndarray:
    """OR-merge host partials (single-process form of the cross-host
    reduction; on device shards this is a psum — disjoint bits make
    add == or only per (item, group), so the merge must stay bitwise-OR
    across hosts that may share paths' groups)."""
    out = partials[0].copy()
    for p in partials[1:]:
        np.bitwise_or(out, p, out=out)
    return out


# -- production multi-host build ----------------------------------------------
#
# Partition unit: a contiguous, payload-balanced GROUP range. Process p owns
# groups [cuts[p], cuts[p+1]) (cut points chosen on the cumulative path-
# payload so every host tokenizes ~1/n_proc of the bytes even when the
# group count is far from a multiple of 32 — a whole-word partition starves
# hosts as soon as n_words < n_proc, e.g. 90 haplotypes = 3 words).
# Each process packs its groups' bits into rows for the words its range
# touches. A word shared by several processes receives bit-DISJOINT
# contributions (each group's bit is set by exactly one owner), so the
# global row is the SUM of the partial rows — carry-free, add == or.
# Assembly: per-process row blocks form one global array with no transfer
# (make_array_from_single_device_arrays), then a single jitted
# gather-and-add reshards to the engine's item sharding (XLA inserts the
# collective; traffic per host ~ max_contributors * |M| / n_words extra
# over the minimal reshard).
#
# The reference has no multi-process substrate at all (rayon threads only,
# /root/reference/src/lib.rs:55-67); this is the SURVEY §5.8 design.


def group_cuts(group_payload: np.ndarray, n_proc: int) -> List[int]:
    """Contiguous group partition balanced on cumulative payload bytes:
    cuts[p]..cuts[p+1] is process p's group range."""
    n_groups = len(group_payload)
    cum = np.concatenate([[0], np.cumsum(group_payload)])
    total = int(cum[-1])
    cuts = [0]
    for p in range(1, n_proc):
        c = int(np.searchsorted(cum, total * p / n_proc, side="left"))
        cuts.append(min(max(c, cuts[-1]), n_groups))
    cuts.append(n_groups)
    return cuts


def words_of_range(g_lo: int, g_hi: int) -> range:
    """Word indices a contiguous group range touches (empty when empty)."""
    if g_lo >= g_hi:
        return range(0, 0)
    return range(g_lo >> 5, ((g_hi - 1) >> 5) + 1)


def word_slots(cuts: List[int], n_words: int, wpp2: int):
    """Per-word contributor slots: [n_words, max_k] of global row indices
    (p * wpp2 + local slot), -1 padded. Deterministic on every process."""
    contrib = [[] for _ in range(n_words)]
    for p in range(len(cuts) - 1):
        ws = words_of_range(cuts[p], cuts[p + 1])
        for w in ws:
            contrib[w].append(p * wpp2 + (w - ws.start))
    max_k = max((len(c) for c in contrib), default=1) or 1
    out = np.full((n_words, max_k), -1, dtype=np.int64)
    for w, c in enumerate(contrib):
        out[w, : len(c)] = c
    return out


def assemble_global_matrix(
    rows: np.ndarray, slots: np.ndarray, n_words: int, n_items_pad: int
) -> "object":
    """Per-process partial word rows [wpp2, n_items_pad] -> global M
    [n_words, n_items_pad] sharded over items across ALL devices.

    Stage 1: a global array with rows blocked by process and columns split
    over each process's local devices (make_array_from_single_device_arrays
    — no transfer, every shard is process-local). Stage 2: one jitted
    gather-and-add over `slots` (bit-disjoint partial rows, add == or) to
    the engine's item sharding (XLA inserts the collective)."""
    import jax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    n_proc = jax.process_count()
    local = jax.local_devices()
    n_local = len(local)
    wpp2 = rows.shape[0]
    assert rows.shape == (wpp2, n_items_pad), (rows.shape, n_items_pad)
    # every slot must address a row inside the global [n_proc * wpp2] block
    # layout — catches a rows block built with a different wpp2 than slots
    assert int(slots.max(initial=-1)) < n_proc * wpp2, (
        slots.max(),
        n_proc,
        wpp2,
    )
    assert n_items_pad % n_local == 0
    cols = n_items_pad // n_local
    mesh_rows = Mesh(
        np.array(jax.devices()).reshape(n_proc, n_local), ("w", "i")
    )
    shards = [
        jax.device_put(rows[:, k * cols : (k + 1) * cols], d)
        for k, d in enumerate(local)
    ]
    G = jax.make_array_from_single_device_arrays(
        (wpp2 * n_proc, n_items_pad),
        NamedSharding(mesh_rows, P("w", "i")),
        shards,
    )
    items_mesh = Mesh(np.array(jax.devices()), ("items",))
    max_k = slots.shape[1]
    idxs = [np.maximum(slots[:, j], 0) for j in range(max_k)]
    masks = [(slots[:, j] >= 0).astype(np.uint32) for j in range(max_k)]

    def to_items(x):
        out = x[idxs[0]] * masks[0][:, None]
        for j in range(1, max_k):
            out = out + x[idxs[j]] * masks[j][:, None]
        return out

    return jax.jit(
        to_items,
        out_shardings=NamedSharding(items_mesh, P(None, "items")),
    )(G)


def allgather_rows(arr: np.ndarray) -> List[np.ndarray]:
    """Allgather a per-process variable-length 2-D int64 array: gather the
    row counts first, pad to the max, gather, trim. Every process receives
    every process's rows (deterministic order by process id).

    int64 payloads travel as int32 PAIRS: process_allgather round-trips
    through jax arrays, and without jax_enable_x64 an int64 input is
    silently truncated to int32 — which scrambled the (path_id << 40)
    visit positions of the covered-bp merge until this view trick."""
    from jax.experimental import multihost_utils

    arr = np.ascontiguousarray(arr, dtype=np.int64).reshape(
        -1, arr.shape[1] if arr.ndim == 2 else 1
    )
    n_cols = arr.shape[1]
    ns = np.asarray(
        multihost_utils.process_allgather(
            np.array([arr.shape[0]], dtype=np.int32)
        )
    ).reshape(-1)
    m = int(ns.max()) if len(ns) else 0
    if m == 0:
        return [arr[:0] for _ in ns]
    pad = np.zeros((m, 2 * n_cols), dtype=np.int32)
    pad[: arr.shape[0]] = arr.view(np.int32).reshape(-1, 2 * n_cols)
    g = np.ascontiguousarray(
        np.asarray(multihost_utils.process_allgather(pad))
    ).reshape(len(ns), m, 2 * n_cols)
    return [
        np.ascontiguousarray(g[i, : ns[i]])
        .view(np.int64)
        .reshape(-1, n_cols)
        for i in range(len(ns))
    ]


def _serialize_intervals(cont) -> np.ndarray:
    return np.asarray(
        [(sid, a, b) for sid, ivs in cont.map.items() for a, b in ivs],
        dtype=np.int64,
    ).reshape(-1, 3)


def merge_covered_container(cont) -> None:
    """Exact cross-process merge of the subset covered-bp container.

    The container's remove-on-full-coverage (reference util.rs:444-463:
    a visit that covers a node completely FORGETS its earlier partial
    intervals, but later partials accumulate again) makes the final state
    order-dependent across paths, so a plain union of per-process maps is
    wrong. itemize records (position, sid, a, b) for every interval add
    and each node's last full-coverage position (position = path_id << 40
    | visit index — the same global order a single process walks). The
    merged state is then, per node: the union of adds whose position is
    AFTER the global last full cover — exactly the single-process
    semantics, because any full-coverage visit empties the node's state
    at its position regardless of what was present."""
    last_full, add_log = cont._mh_track
    adds = np.asarray(add_log, dtype=np.int64).reshape(-1, 4)
    all_adds = np.concatenate(allgather_rows(adds))
    interesting = (
        np.unique(all_adds[:, 1])
        if len(all_adds)
        else np.zeros(0, dtype=np.int64)
    )
    lf_local = np.column_stack([interesting, last_full[interesting]]) if len(
        interesting
    ) else np.zeros((0, 2), dtype=np.int64)
    lf_all = np.concatenate(allgather_rows(lf_local))
    gmax = {}
    for sid, posv in lf_all:
        if posv > gmax.get(int(sid), -1):
            gmax[int(sid)] = int(posv)
    cont.map.clear()
    if hasattr(cont, "_present"):  # itemize's cached presence bitmap
        del cont._present
    for pos, sid, a, b in all_adds:
        if int(pos) > gmax.get(int(sid), -1):
            cont.add(int(sid), int(a), int(b))


def merge_exclude_tables(exclude_tables, graph) -> None:
    """Allgather-OR ActiveTable states in place: boolean activation plus
    the bp exclude-interval annotations, replaying the full-coverage
    promotion of ActiveTable.activate_n_annotate so the merged state is
    exactly what one process walking every path would hold."""
    from jax.experimental import multihost_utils

    tabs = []
    seen = set()
    for t in exclude_tables:
        if t is not None and id(t) not in seen:
            seen.add(id(t))
            tabs.append(t)
    if not tabs:
        return
    packed = np.concatenate([np.packbits(t.items) for t in tabs])
    g = np.asarray(
        multihost_utils.process_allgather(packed)
    ).reshape(-1, len(packed))
    merged = np.bitwise_or.reduce(g, axis=0)
    off = 0
    for t in tabs:
        nb = (len(t.items) + 7) // 8
        t.items[:] = np.unpackbits(merged[off : off + nb])[
            : len(t.items)
        ].astype(bool)
        off += nb
    for t in tabs:
        ann = t.annotation
        if ann is None:
            continue
        parts = allgather_rows(_serialize_intervals(ann))
        ann.map.clear()
        for part in parts:
            for sid, a, b in part:
                ann.add(int(sid), int(a), int(b))
        for sid in list(ann.keys()):
            sid = int(sid)
            if t.items[sid]:  # promoted by another process
                ann.remove(sid)
                continue
            got = ann.get(sid)
            if got and got[0] == (0, graph.node_len(sid)):
                ann.remove(sid)
                t.items[sid] = True


def _partition_groups(graph, path_order, n_groups, n_words, n_proc):
    """Payload-balanced contiguous group partition + per-word slot layout,
    SHARED by the unmasked and masked multi-host builds — the two must
    compute identical cuts/slots or cross-process word-row assembly
    desynchronizes. Returns (span_len, total_payload, cuts, wpp2,
    slots)."""
    spans = np.asarray(graph._pw_seq_spans, dtype=np.int64)
    span_len = (
        spans[:, 1] - spans[:, 0]
        if len(spans)
        else np.zeros(0, dtype=np.int64)
    )
    total_payload = int(span_len.sum())
    group_payload = np.zeros(max(n_groups, 1), dtype=np.int64)
    if path_order:
        po_pids = np.fromiter(
            (p for p, _ in path_order), dtype=np.int64, count=len(path_order)
        )
        po_gidx = np.fromiter(
            (g for _, g in path_order), dtype=np.int64, count=len(path_order)
        )
        np.add.at(group_payload, po_gidx, span_len[po_pids])
    cuts = group_cuts(group_payload[:n_groups], n_proc)
    wpp2 = max(
        (len(words_of_range(cuts[p], cuts[p + 1])) for p in range(n_proc)),
        default=1,
    ) or 1
    slots = word_slots(cuts, n_words, wpp2)
    return span_len, total_payload, cuts, wpp2, slots


def _allgather_sum_paths(graph, node_len, bp_len, have) -> dict:
    """Sum per-path (node_len, bp_len, have) arrays across processes
    (each path is walked by exactly one) and rebuild the paths_len dict —
    int64-safe through allgather_rows."""
    n_paths = len(graph.path_segments)
    parts = allgather_rows(np.stack([node_len, bp_len, have], axis=1))
    tot = np.zeros((n_paths, 3), dtype=np.int64)
    for part in parts:
        tot += part
    return {
        graph.path_segments[p]: (int(tot[p, 0]), int(tot[p, 1]))
        for p in range(n_paths)
        if tot[p, 2]
    }


def _merge_paths_len(graph, paths_len) -> dict:
    """Allgather-merge per-path (node_len, bp_len) dicts."""
    n_paths = len(graph.path_segments)
    node_len = np.zeros(n_paths, dtype=np.int64)
    bp_len = np.zeros(n_paths, dtype=np.int64)
    have = np.zeros(n_paths, dtype=np.int64)
    for p, seg in enumerate(graph.path_segments):
        v = paths_len.get(seg)
        if v is not None:
            node_len[p], bp_len[p] = v
            have[p] = 1
    return _allgather_sum_paths(graph, node_len, bp_len, have)


def multihost_masked_abaci(graph, mask, count_types):
    """Path-sliced multi-host build for masked runs (subset BEDs,
    coordinate excludes) and group-table exports: each process runs the
    EXACT interval-walking itemizer (itemize.itemize_paths) over only its
    payload-balanced group range's paths, then the mask side products
    merge across processes:

      - exclude tables: boolean OR + interval-annotation union with the
        full-coverage promotion replayed (merge_exclude_tables),
      - subset covered-bp intervals: order-independent union
        (merge_interval_container), so the uncovered-bp correction
        (abacus.quantify_uncovered_bps) is computed identically on every
        process,
      - paths_len: per-path allgather (each path is walked exactly once),
      - membership rows: packed per word block and assembled exactly like
        the unmasked path (bit-disjoint; each count type's merged
        excluded columns are zeroed on every process BEFORE assembly).

    The returned ItemizeResult keeps this process's LOCAL item tables and
    the mh_table_local marker — AbacusByGroup.sparse_counts allgathers
    the (item, group, multiplicity) triplets so `table` exports run
    path-sliced too. (The round-4 claim that per-path bp corrections
    cannot merge is withdrawn: the correction state is O(paths + boundary
    nodes), not O(items).)"""
    import jax

    from ..abacus import (
        AbacusByTotal,
        build_membership_host,
        path_order_groups,
        quantify_uncovered_bps,
    )
    from ..itemize import itemize_paths
    from ..ops.engine import CountingEngine
    from ..utils import CountType

    n_paths = len(graph.path_segments)
    if n_paths == 0:
        return None

    n_proc = jax.process_count()
    pid = jax.process_index()
    path_order, groups = path_order_groups(mask, graph.path_segments)
    n_groups = len(groups)
    n_words = max((n_groups + 31) // 32, 1)

    span_len, total_payload, cuts, wpp2, slots = _partition_groups(
        graph, path_order, n_groups, n_words, n_proc
    )
    g_lo, g_hi = cuts[pid], cuts[pid + 1]
    my_words = words_of_range(g_lo, g_hi)

    grouped = np.zeros(n_paths, dtype=bool)
    local = np.zeros(n_paths, dtype=bool)
    for p, g in path_order:
        grouped[p] = True
        if g_lo <= g < g_hi:
            local[p] = True
    if pid == 0:  # ungrouped paths: paths_len parity with single host
        local |= ~grouped
    my_payload = int(span_len[local].sum()) if len(span_len) else 0
    log.info(
        "multi-host masked build: process %d/%d owns groups [%d, %d) "
        "(%d paths, %.1f%% of path payload)",
        pid,
        n_proc,
        g_lo,
        g_hi,
        int(local.sum()),
        100.0 * my_payload / max(total_payload, 1),
    )

    itemized = itemize_paths(
        graph, mask, count_types, path_filter=local, track_cov_order=True
    )
    local_order = [(p, g) for p, g in path_order if g_lo <= g < g_hi]

    merge_exclude_tables(itemized.exclude_tables, graph)
    if itemized.subset_covered_bps is not None:
        merge_covered_container(itemized.subset_covered_bps)

    abaci = {}
    for slot, ct in enumerate(count_types):
        # one engine per count type with ITS OWN exclude set, matching the
        # single-host masked path (AbacusByTotal.from_itemization) — the
        # node- and bp-slot exclude tables can differ (partial exclusion
        # only annotates the bp table)
        engine = CountingEngine(graph.number_of_items(ct), n_groups)
        M_full = build_membership_host(
            itemized.item_tables[slot],
            local_order,
            itemized.exclude_tables[slot],  # merged above
            engine.n_items,
            n_groups,
            engine.n_items_pad,
        )
        Rc = np.zeros((wpp2, engine.n_items_pad), dtype=np.uint32)
        if len(my_words):
            Rc[: len(my_words)] = M_full[my_words.start : my_words.stop]
        engine.M = assemble_global_matrix(
            Rc, slots, n_words, engine.n_items_pad
        )
        unc = quantify_uncovered_bps(
            itemized.exclude_tables[slot],
            itemized.subset_covered_bps if ct == CountType.BP else None,
            graph,
        )
        abaci[ct] = AbacusByTotal(ct, engine, groups, unc, graph)
        log.info(
            "abacus has %d path groups and %d countables",
            n_groups,
            engine.n_items,
        )

    itemized.paths_len = _merge_paths_len(graph, itemized.paths_len)
    itemized.mh_stats = {
        "tokenized_payload_bytes": my_payload,
        "total_payload_bytes": total_payload,
        "n_processes": n_proc,
    }
    itemized.mh_table_local = True  # sparse_counts allgathers triplets
    return abaci, itemized, path_order, groups


def multihost_total_abaci(graph, mask, count_types, need_itemized: bool):
    """Multi-host form of stream.streamed_total_abaci: this process
    tokenizes only its word block's paths; M assembles globally.

    Exclude-only masks with whole-path rows (no coordinates) run
    path-sliced too: whole-path exclusion is item-set zeroing (the classic
    build's `M[:, excluded] = 0`, abacus.build_membership_host), so each
    process marks the excluded items of the paths it already tokenizes,
    the bitmaps are allgather-ORed, and every process zeroes its own word
    rows before assembly (reference semantics:
    src/graph_broker/abacus.rs:427-473 exclude tables).

    Returns None (caller falls back to the classic redundant-compute path,
    where every host itemizes the full graph and the engine still shards M
    over the global mesh) when: subset masks or coordinate excludes are
    present (the per-path interval walk needs per-path bp accounting that
    a path-sliced build cannot merge — see README Compatibility), the
    native tokenizer is unavailable (incl. string-name graphs without the
    mode-3 name hash), there are no paths, or the caller needs the full
    host-side itemization (need_itemized: AbacusByGroup table export reads
    per-path item runs, which a path-sliced build cannot provide)."""
    import jax

    from ..abacus import AbacusByTotal, path_order_groups
    from ..itemize import ItemizeResult
    from ..ops.engine import CountingEngine
    from ..stream import _pack_row, _plan_slabs, _slab_edges
    from ..utils import CountType
    from jax.experimental import multihost_utils

    if need_itemized or mask.include_coords is not None:
        # group-table export or subset mask: run the exact interval
        # walker path-sliced and merge the mask products
        return multihost_masked_abaci(graph, mask, count_types)
    exc_pids = None
    if mask.exclude_coords is not None:
        big = (1 << 63) - 1
        exc_map = mask.build_subpath_map(mask.exclude_coords)
        if any(v != [(0, big)] for v in exc_map.values()):
            # coordinate excludes need the interval walk — path-sliced too
            return multihost_masked_abaci(graph, mask, count_types)
        exc_pids = frozenset(
            i
            for i, seg in enumerate(graph.path_segments)
            if seg.id() in exc_map
        )
    if not graph.batch_tokenizable():
        return None
    n_paths = len(graph.path_segments)
    if n_paths == 0:
        return None

    n_proc = jax.process_count()
    pid = jax.process_index()
    path_order, groups = path_order_groups(mask, graph.path_segments)
    n_groups = len(groups)
    slabs = _plan_slabs(path_order, n_paths)
    need_edge = CountType.EDGE in count_types
    need_node = any(ct != CountType.EDGE for ct in count_types)

    node_engine = (
        CountingEngine(graph.number_of_items(CountType.NODE), n_groups)
        if need_node
        else None
    )
    edge_engine = (
        CountingEngine(graph.number_of_items(CountType.EDGE), n_groups)
        if need_edge
        else None
    )
    any_engine = node_engine or edge_engine
    n_words = any_engine.n_words

    # payload-balanced contiguous GROUP partition: every host tokenizes
    # ~1/n_proc of the path payload bytes regardless of how the group
    # count maps to 32-group words (see module comment)
    span_len, total_payload, cuts, wpp2, slots = _partition_groups(
        graph, path_order, n_groups, n_words, n_proc
    )
    g_lo, g_hi = cuts[pid], cuts[pid + 1]
    my_words = words_of_range(g_lo, g_hi)

    # clip each word slab to this process's group range; the ungrouped
    # trailing slab (word -1) only feeds paths_len — process 0 walks it so
    # the merged paths_len matches the single-host builder
    my_parts = []  # (slab, selection into slab paths)
    my_payload = 0
    for s in slabs:
        if s.word < 0:
            if pid == 0:
                sel = np.arange(len(s.path_ids), dtype=np.int64)
                my_parts.append((s, sel))
                my_payload += int(span_len[s.path_ids].sum())
            continue
        gidx_global = s.word * 32 + s.gidx_rel
        sel = np.flatnonzero((gidx_global >= g_lo) & (gidx_global < g_hi))
        if len(sel):
            my_parts.append((s, sel))
            my_payload += int(span_len[s.path_ids[sel]].sum())
    log.info(
        "multi-host build: process %d/%d owns groups [%d, %d) over words "
        "%s (%d slab parts, %.1f%% of path payload)",
        pid,
        n_proc,
        g_lo,
        g_hi,
        list(my_words),
        len(my_parts),
        100.0 * my_payload / max(total_payload, 1),
    )

    R_node = (
        np.zeros((wpp2, node_engine.n_items_pad), dtype=np.uint32)
        if need_node
        else None
    )
    R_edge = (
        np.zeros((wpp2, edge_engine.n_items_pad), dtype=np.uint32)
        if need_edge
        else None
    )
    node_len = np.zeros(n_paths, dtype=np.int64)
    bp_len = np.zeros(n_paths, dtype=np.int64)
    have_len = np.zeros(n_paths, dtype=np.int64)
    node_excl = (
        np.zeros(node_engine.n_items_pad, dtype=bool)
        if (exc_pids and need_node)
        else None
    )
    edge_excl = (
        np.zeros(edge_engine.n_items_pad, dtype=bool)
        if (exc_pids and need_edge)
        else None
    )
    for slab, sel in my_parts:
        pids_sel = slab.path_ids[sel]
        batch = graph.all_path_item_runs(pids_sel)
        if batch is None:
            return None
        ids, orient, prefsum, bp = batch
        exc_local = (
            [k for k, p in enumerate(pids_sel) if int(p) in exc_pids]
            if exc_pids
            else []
        )
        if need_node:
            counts = np.diff(prefsum)
            node_len[pids_sel] = counts
            bp_len[pids_sel] = bp
            have_len[pids_sel] = 1
            if slab.word >= 0:
                _pack_row(
                    ids,
                    prefsum,
                    slab.gidx_rel[sel],
                    node_engine.n_items_pad,
                    out=R_node[slab.word - my_words.start],
                )
            for k in exc_local:
                node_excl[ids[prefsum[k] : prefsum[k + 1]]] = True
        if need_edge and (slab.word >= 0 or exc_local):
            eids, e_pref = _slab_edges(graph, ids, orient, prefsum)
            if slab.word >= 0:
                _pack_row(
                    eids,
                    e_pref,
                    slab.gidx_rel[sel],
                    edge_engine.n_items_pad,
                    out=R_edge[slab.word - my_words.start],
                )
            for k in exc_local:
                edge_excl[eids[e_pref[k] : e_pref[k + 1]]] = True

    if exc_pids:
        # merge each process's excluded-item marks and zero those columns
        # in the local partial rows BEFORE assembly. Words may be SHARED
        # between processes (group-range partition), but every process
        # zeroes the same merged column set in its own partials, so the
        # carry-free sum of partials is zero in those columns too.
        parts = [
            np.packbits(t) for t in (node_excl, edge_excl) if t is not None
        ]
        packed = np.concatenate(parts)
        gathered = np.asarray(
            multihost_utils.process_allgather(packed)
        ).reshape(-1, len(packed))
        merged = np.bitwise_or.reduce(gathered, axis=0)
        off = 0
        if node_excl is not None:
            nb = len(parts[0])
            idx = np.flatnonzero(
                np.unpackbits(merged[:nb])[: node_engine.n_items_pad]
            )
            R_node[:, idx] = 0
            off = nb
        if edge_excl is not None:
            idx = np.flatnonzero(
                np.unpackbits(merged[off:])[: edge_engine.n_items_pad]
            )
            R_edge[:, idx] = 0

    if need_node:
        node_engine.M = assemble_global_matrix(
            R_node, slots, n_words, node_engine.n_items_pad
        )
    if need_edge:
        edge_engine.M = assemble_global_matrix(
            R_edge, slots, n_words, edge_engine.n_items_pad
        )

    # paths_len merge: every process contributes its slabs' rows
    paths_len = _allgather_sum_paths(graph, node_len, bp_len, have_len)

    itemized = ItemizeResult(
        item_tables=[None] * len(count_types),
        exclude_tables=[None] * len(count_types),
        subset_covered_bps=None,
        paths_len=paths_len,
    )
    # surfaced for scaling-efficiency assertions (not part of the result
    # contract; consumers must not rely on it)
    itemized.mh_stats = {
        "tokenized_payload_bytes": my_payload,
        "total_payload_bytes": total_payload,
        "n_processes": n_proc,
    }
    abaci = {}
    for ct in count_types:
        engine = edge_engine if ct == CountType.EDGE else node_engine
        abaci[ct] = AbacusByTotal(ct, engine, groups, {}, graph)
    return abaci, itemized, path_order, groups
