"""Streamed abacus construction with a placement-aware schedule.

The classic path (itemize_paths -> build_membership_host -> one blocking
upload) serializes phases that have no mutual dependency at slab
granularity. This module picks one of two schedules:

- **Pipelined** (device-placed rows): a worker thread tokenizes slab i+1
  while the main thread packs slab i's rows and async device_put uploads
  ride underneath — by the time the final slab is tokenized, every
  earlier membership row is already resident in device memory.
- **Serial** (host-placed rows — runs on the CPU backend):
  there is no upload to hide, so the pipeline's extra thread only
  oversubscribes the cores the threaded C stages already use. Phase A
  tokenizes and packs node rows at full thread width while the async
  L-line edge indexer still runs; phase B joins it and packs edge rows
  from the stashed node CSRs.

Applicability: unmasked runs (no subset/exclude coordinates) on graphs the
native batch tokenizer can handle — exactly the hot production case. The
masked path keeps the exact interval-walking itemizer (itemize.py).

Reference counterpart: the single-threaded three-file-pass coverage build
(src/graph_broker/abacus.rs:485-586, util.rs:22-206) — re-architected, not
ported: the reference has no device, so it has nothing to overlap.
"""

from __future__ import annotations

import os
import logging
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from .abacus import AbacusByTotal, path_order_groups
from .gfa import GraphStorage, PathSegment, SlabbedItemTable
from .itemize import ItemizeResult
from .mask import GraphMask
from .ops.engine import MembershipStream, rows_on_host
from .utils import CountType

log = logging.getLogger("panacus")


@dataclass
class _Slab:
    word: int  # group word this slab contributes to; -1 = ungrouped paths
    path_ids: np.ndarray  # global path indices, in path order
    gidx_rel: np.ndarray  # per-path group bit within the word (0..31)


def _plan_slabs(path_order: List[Tuple[int, int]], n_paths: int) -> List[_Slab]:
    """Partition the (path, group) order into word-aligned slabs. Group
    indices are non-decreasing along path_order by construction
    (abacus.path_order_groups), so each 32-group word is one contiguous run.
    Ungrouped paths form a trailing no-bit slab (paths_len parity with the
    classic itemizer, which walks every P/W line)."""
    slabs: List[_Slab] = []
    cur_word = None
    cur_paths: List[int] = []
    cur_bits: List[int] = []
    for pid, g in path_order:
        w = g >> 5
        if w != cur_word:
            if cur_paths:
                slabs.append(
                    _Slab(
                        cur_word,
                        np.asarray(cur_paths, dtype=np.int64),
                        np.asarray(cur_bits, dtype=np.int64),
                    )
                )
            cur_word, cur_paths, cur_bits = w, [], []
        cur_paths.append(pid)
        cur_bits.append(g & 31)
    if cur_paths:
        slabs.append(
            _Slab(
                cur_word,
                np.asarray(cur_paths, dtype=np.int64),
                np.asarray(cur_bits, dtype=np.int64),
            )
        )
    grouped = {p for p, _ in path_order}
    rest = np.asarray(
        [p for p in range(n_paths) if p not in grouped], dtype=np.int64
    )
    if len(rest):
        slabs.append(_Slab(-1, rest, np.zeros(len(rest), dtype=np.int64)))
    return slabs


def _pack_row(
    ids: np.ndarray,
    prefsum: np.ndarray,
    gidx_rel: np.ndarray,
    n_items_pad: int,
    out: "np.ndarray | None" = None,
) -> np.ndarray:
    """OR this slab's per-path item runs into one packed uint32 word row.
    `out`: an already-zeroed uint32[n_items_pad] target (host-placed
    streams hand the final matrix's row so finalize never copies)."""
    from .native import build_membership
    from .runtime import effective_threads

    M = (
        out.reshape(1, n_items_pad)
        if out is not None
        else np.zeros((1, n_items_pad), dtype=np.uint32)
    )
    k = len(gidx_rel)
    done = build_membership(
        ids,
        prefsum,
        np.arange(k, dtype=np.int64),
        np.ascontiguousarray(gidx_rel, dtype=np.int64),
        M,
        effective_threads(),
    )
    if not done:
        row = M[0]
        for j in range(k):
            run = ids[prefsum[j] : prefsum[j + 1]]
            row[run] |= np.uint32(1 << int(gidx_rel[j]))
    M[0, 0] = 0  # sentinel slot (reference: abacus.rs:549-552)
    return M[0]


def _slab_edges(
    graph: GraphStorage,
    ids: np.ndarray,
    orient: np.ndarray,
    prefsum: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-slab edge CSR from the node CSR (canonical edge ids of every
    consecutive pair; counterpart of the unmasked edge branch in
    itemize_paths)."""
    from .native import lookup_edges, lookup_edges_adj
    from .runtime import effective_threads

    if len(ids) == 0:
        return np.zeros(0, np.int64), prefsum.copy()
    res = lookup_edges_adj(
        ids, orient, prefsum, graph.edge_adj(), effective_threads()
    )
    if res is None:
        res = lookup_edges(
            ids, orient, prefsum, graph.edge_hash(), effective_threads()
        )
    if res is not None:
        return res
    counts = np.diff(prefsum)
    nz = counts > 0
    keep = np.ones(len(ids), dtype=bool)
    keep[prefsum[1:][nz] - 1] = False
    idx = np.flatnonzero(keep)
    eids = graph.edge_ids_for_pairs(
        ids[idx], orient[idx], ids[idx + 1], orient[idx + 1]
    )
    e_pref = np.zeros(len(prefsum), dtype=np.int64)
    np.cumsum(np.maximum(counts, 1) - 1, out=e_pref[1:])
    return eids, e_pref


class LazyEdgeTable:
    """Edge ItemTable view derived on demand from the node CSR and the
    graph's edge index. The streamed -c all path packs edge membership
    rows directly (native pt_pack_edges_adj) without ever materializing
    per-path edge-id runs; only the group-table export resolves them,
    lazily, through this view. Interface-compatible with
    SlabbedItemTable (path_slice / items / prefsum)."""

    def __init__(self, graph: GraphStorage, num_paths: int):
        self.num_paths = num_paths
        self._graph = graph
        self._slabs: List[Tuple[np.ndarray, ...]] = []
        self._where: Dict[int, Tuple[int, int]] = {}
        self._items: Optional[np.ndarray] = None
        self._prefsum: Optional[np.ndarray] = None

    def add_slab(self, path_ids, ids, orient, prefsum) -> None:
        s = len(self._slabs)
        self._slabs.append((path_ids, ids, orient, prefsum))
        for k, p in enumerate(path_ids):
            self._where[int(p)] = (s, k)

    def path_slice(self, path_idx: int) -> np.ndarray:
        loc = self._where.get(path_idx)
        if loc is None:
            return np.zeros(0, dtype=np.int64)
        s, k = loc
        _, ids, orient, prefsum = self._slabs[s]
        a, b = prefsum[k], prefsum[k + 1]
        if b - a < 2:
            return np.zeros(0, dtype=np.int64)
        run, orun = ids[a:b], orient[a:b]
        return self._graph.edge_ids_for_pairs(
            run[:-1], orun[:-1], run[1:], orun[1:]
        )

    def _materialize(self) -> None:
        chunks = [self.path_slice(p) for p in range(self.num_paths)]
        self._prefsum = np.zeros(self.num_paths + 1, dtype=np.int64)
        np.cumsum([len(c) for c in chunks], out=self._prefsum[1:])
        self._items = (
            np.concatenate(chunks) if chunks else np.zeros(0, dtype=np.int64)
        )

    @property
    def items(self) -> np.ndarray:
        if self._items is None:
            self._materialize()
        return self._items

    @property
    def prefsum(self) -> np.ndarray:
        if self._prefsum is None:
            self._materialize()
        return self._prefsum


def streamed_total_abaci(
    graph: GraphStorage,
    mask: GraphMask,
    count_types: List[CountType],
):
    """Pipelined unmasked abacus build. Returns
    (abaci, itemized, path_order, groups) or None when the classic path must
    run (masks present / native tokenizer unavailable / no paths)."""
    import os

    if os.environ.get("PANACUS_NO_STREAM"):
        return None
    import jax

    if jax.process_count() > 1:
        # multi-host runs build through parallel.ingest.multihost_total_abaci
        # (per-process word blocks); MembershipStream's row placement is
        # single-host
        return None
    if mask.include_coords is not None or mask.exclude_coords is not None:
        return None
    if not graph.batch_tokenizable():
        return None
    n_paths = len(graph.path_segments)
    if n_paths == 0:
        return None

    path_order, groups = path_order_groups(mask, graph.path_segments)
    n_groups = len(groups)
    slabs = _plan_slabs(path_order, n_paths)
    need_edge = CountType.EDGE in count_types
    need_node = any(ct != CountType.EDGE for ct in count_types)

    node_stream = (
        MembershipStream(graph.number_of_items(CountType.NODE), n_groups)
        if need_node
        else None
    )
    node_table = SlabbedItemTable(n_paths) if need_node else None
    edge_stream = None
    edge_table = None
    edge_fused = False
    paths_len: Dict[PathSegment, Tuple[int, int]] = {}

    log.info(
        "streamed membership build: %d slabs, %d groups, counts %s",
        len(slabs),
        n_groups,
        count_types,
    )
    # Pipeline only when there is a device upload to hide: with host-placed
    # rows (CPU backend) feed() is a pointer store, so the tokenize/pack
    # overlap buys nothing and the extra worker thread oversubscribes the
    # host cores the threaded C stages already use. Serial mode runs each
    # C stage at full thread width instead.
    serial = rows_on_host()
    if not serial:
        from .runtime import effective_threads

        # few-core hosts: the pipeline worker oversubscribes the threaded
        # C stages even with device-placed rows — device_put transfers are
        # async under the serial loop too
        serial = effective_threads() <= 2
    # PANACUS_STREAM_SERIAL=1/0 overrides the schedule
    ser_env = os.environ.get("PANACUS_STREAM_SERIAL")
    if ser_env is not None:
        serial = ser_env not in ("0", "")

    def make_edge_stream():
        """Create the edge stream/table; joins the async L-line indexer."""
        nonlocal edge_stream, edge_table, edge_fused
        from .native import get_lib

        edge_stream = MembershipStream(
            graph.number_of_items(CountType.EDGE), n_groups
        )
        edge_fused = get_lib() is not None and graph.edge_adj() is not None
        edge_table = (
            LazyEdgeTable(graph, n_paths)
            if edge_fused
            else SlabbedItemTable(n_paths)
        )

    def consume_node(slab, batch, pack_node):
        """Node-table bookkeeping + node row pack/feed for one slab.
        pack_node=False when the pipelined worker packs/feeds the node row
        (it arrives one iteration later as prev_row)."""
        ids, orient, prefsum, bp = batch
        # paths_len parity with the classic itemizer, which fills it
        # only for node/bp runs (itemize.py zero-copy shortcut)
        counts = np.diff(prefsum)
        segs = graph.path_segments
        for k, pid in enumerate(slab.path_ids):
            paths_len[segs[int(pid)]] = (int(counts[k]), int(bp[k]))
        node_table.add_slab(slab.path_ids, ids, prefsum)
        if pack_node and slab.word >= 0:
            node_stream.feed(
                slab.word,
                _pack_row(
                    ids,
                    prefsum,
                    slab.gidx_rel,
                    node_stream.engine.n_items_pad,
                    out=node_stream.host_row(slab.word),
                ),
            )

    def consume_edge(slab, batch, fused_row=None):
        """Edge-table bookkeeping + edge row pack/feed for one slab.
        `fused_row`: the row was already packed inside the tokenize pass
        (pt_tokenize_pack) — just feed it."""
        ids, orient, prefsum, bp = batch
        if edge_fused:
            # fused path: lookup + group-bit OR in one C pass, no
            # edge-id CSR; the LazyEdgeTable keeps node-CSR refs
            # for on-demand export
            edge_table.add_slab(slab.path_ids, ids, orient, prefsum)
            if slab.word >= 0:
                if fused_row is not None:
                    edge_stream.feed(slab.word, fused_row)
                    return
                from .native import pack_edges_adj

                row = edge_stream.host_row(slab.word)
                if row is None:
                    row = np.zeros(
                        edge_stream.engine.n_items_pad, dtype=np.uint32
                    )
                pack_edges_adj(
                    ids,
                    orient,
                    prefsum,
                    slab.gidx_rel,
                    graph.edge_adj(),
                    row,
                )
                row[0] = 0
                edge_stream.feed(slab.word, row)
        else:
            eids, e_pref = _slab_edges(graph, ids, orient, prefsum)
            edge_table.add_slab(slab.path_ids, eids, e_pref)
            if slab.word >= 0:
                edge_stream.feed(
                    slab.word,
                    _pack_row(
                        eids,
                        e_pref,
                        slab.gidx_rel,
                        edge_stream.engine.n_items_pad,
                        out=edge_stream.host_row(slab.word),
                    ),
                )

    if serial:
        # Phase A tokenizes and packs node rows while the async L-line edge
        # indexer still runs; edge rows are stashed only until the indexer
        # completes (polled non-blocking each slab), which bounds the peak
        # RSS of the stash instead of retaining every slab until a phase B.
        def _edge_index_ready():
            f = getattr(graph, "_edge_future", None)
            return f is None or f.done()

        stashed = []
        for slab in slabs:
            # fused tokenize+pack: when the membership rows are host-placed
            # the C tokenizer ORs each path's ids into them while they are
            # still cache-hot, removing the separate pack passes' full
            # re-read of the token array
            fused_node_row = fused_edge_row = None
            pack = {}
            if slab.word >= 0:
                if need_node:
                    fused_node_row = node_stream.host_row(slab.word)
                    if fused_node_row is not None:
                        pack["pack_node_row"] = fused_node_row
                if need_edge and edge_stream is None and _edge_index_ready():
                    # ready the edge stream BEFORE tokenizing so the edge
                    # pack rides the same pass
                    make_edge_stream()
                    for s_prev, b_prev in stashed:
                        consume_edge(s_prev, b_prev)
                    stashed = []
                if need_edge and edge_stream is not None and edge_fused:
                    erow = edge_stream.host_row(slab.word)
                    adj = graph.edge_adj()
                    if erow is not None and adj is not None:
                        pack["pack_edge_row"] = erow
                        pack["pack_edge_adj"] = adj
                        fused_edge_row = erow
                if pack:
                    pack["pack_gbit"] = np.ascontiguousarray(
                        slab.gidx_rel, dtype=np.int64
                    )
            batch = graph.all_path_item_runs(
                slab.path_ids, pack=pack or None
            )
            if batch is None:  # tokenizer bailed: let the classic path run
                return None
            if need_node:
                consume_node(
                    slab,
                    batch,
                    pack.get("pack_node_row") is None,
                )
                if fused_node_row is not None:
                    node_stream.feed(slab.word, fused_node_row)
            if need_edge:
                if edge_stream is None and _edge_index_ready():
                    make_edge_stream()
                    for s_prev, b_prev in stashed:
                        consume_edge(s_prev, b_prev)
                    stashed = []
                if edge_stream is not None:
                    consume_edge(slab, batch, fused_row=fused_edge_row)
                else:
                    stashed.append((slab, batch))
        if need_edge:
            if edge_stream is None:  # indexer outlived tokenization: join
                make_edge_stream()
            for s_prev, b_prev in stashed:
                consume_edge(s_prev, b_prev)
            stashed = []
    else:
        if need_edge:
            make_edge_stream()
        # pipeline split: the worker thread tokenizes slab i+1 (threaded C,
        # GIL-released); in fused-edge mode it ALSO packs slab i's node
        # row, so the main thread's work is exactly the fused edge
        # lookup+pack — this balances the two threads on small hosts
        worker_packs_node = need_node and need_edge and edge_fused

        def work(next_pids, cur_slab, cur_batch):
            from .native import install_thread_allocator

            install_thread_allocator()  # context-local numpy handler
            nxt = (
                graph.all_path_item_runs(next_pids)
                if next_pids is not None
                else True
            )
            row = None
            if (
                worker_packs_node
                and cur_slab is not None
                and cur_slab.word >= 0
                and cur_batch is not None
            ):
                row = _pack_row(
                    cur_batch[0],
                    cur_batch[2],
                    cur_slab.gidx_rel,
                    node_stream.engine.n_items_pad,
                )
            return nxt, row

        with ThreadPoolExecutor(max_workers=1) as ex:
            fut = ex.submit(work, slabs[0].path_ids, None, None)
            prev_slab = None
            for i, slab in enumerate(slabs):
                batch, prev_row = fut.result()
                if batch is None:  # tokenizer bailed: classic path runs
                    return None
                if prev_row is not None:
                    node_stream.feed(prev_slab.word, prev_row)
                next_pids = (
                    slabs[i + 1].path_ids if i + 1 < len(slabs) else None
                )
                fut = ex.submit(work, next_pids, slab, batch)
                prev_slab = slab
                if need_node:
                    consume_node(slab, batch, not worker_packs_node)
                if need_edge:
                    consume_edge(slab, batch)

            # drain: the last worker job still carries the final node row
            _, last_row = fut.result()
            if last_row is not None:
                node_stream.feed(prev_slab.word, last_row)

    node_engine = node_stream.finalize() if need_node else None
    edge_engine = edge_stream.finalize() if need_edge else None

    item_tables = [
        edge_table if ct == CountType.EDGE else node_table
        for ct in count_types
    ]
    itemized = ItemizeResult(
        item_tables=item_tables,
        exclude_tables=[None] * len(count_types),
        subset_covered_bps=None,
        paths_len=paths_len,
    )
    abaci: Dict[CountType, AbacusByTotal] = {}
    for ct in count_types:
        engine = edge_engine if ct == CountType.EDGE else node_engine
        abaci[ct] = AbacusByTotal(ct, engine, groups, {}, graph)
        log.info(
            "abacus has %d path groups and %d countables",
            n_groups,
            engine.n_items,
        )
    return abaci, itemized, path_order, groups
