"""Coverage abaci: device-backed equivalents of AbacusByTotal/AbacusByGroup.

(reference: src/graph_broker/abacus.rs:476-1179)

Both abaci share one representation: the packed membership bit matrix in
device memory (ops.CountingEngine). AbacusByTotal reads it as a popcount
reduction; AbacusByGroup reads it column-wise (ordered scans, similarity
matmuls, sparse table export).
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional, Tuple

import numpy as np

from .gfa import GraphStorage, ItemTable, PathSegment
from .itemize import ItemizeResult
from .mask import GraphMask
from .ops import CountingEngine
from .utils import ActiveTable, CountType, IntervalContainer, Threshold

log = logging.getLogger("panacus")


def path_order_groups(
    mask: GraphMask, path_segments: List[PathSegment]
) -> Tuple[List[Tuple[int, int]], List[str]]:
    """Resolve (path_idx, group_idx) in processing order plus ordered group
    names (reference: abacus.rs:556-567 group-block walk)."""
    order = mask.get_path_order(path_segments)
    groups: List[str] = []
    out: List[Tuple[int, int]] = []
    for path_id, group_name in order:
        if not groups or groups[-1] != group_name:
            groups.append(group_name)
        out.append((path_id, len(groups) - 1))
    return out, groups


def build_membership_host(
    item_table: ItemTable,
    path_order: List[Tuple[int, int]],
    exclude_table: Optional[ActiveTable],
    n_items: int,
    n_groups: int,
    n_items_pad: int,
) -> np.ndarray:
    """Build the packed membership matrix M[n_words, n_items_pad] host-side:
    one vectorized OR per (path, group) block. Duplicate item visits OR the
    same bit — no dedup pass needed. Excluded items are zeroed afterwards
    (equivalent to the reference's per-visit exclude check,
    abacus.rs:736-737, since an all-zero column counts as coverage 0)."""
    n_words = max((n_groups + 31) // 32, 1)
    M = np.zeros((n_words, n_items_pad), dtype=np.uint32)
    native_done = False
    if path_order and item_table.prefsum is not None:
        from .native import build_membership
        from .runtime import effective_threads

        pids = np.fromiter(
            (p for p, _ in path_order), dtype=np.int64, count=len(path_order)
        )
        gidx = np.fromiter(
            (g for _, g in path_order), dtype=np.int64, count=len(path_order)
        )
        native_done = build_membership(
            item_table.items,
            item_table.prefsum,
            pids,
            gidx,
            M,
            effective_threads(),
        )
    if not native_done:
        for path_id, group_idx in path_order:
            ids = item_table.path_slice(path_id)
            if len(ids) == 0:
                continue
            M[group_idx >> 5, ids] |= np.uint32(1 << (group_idx & 31))
    if exclude_table is not None:
        excluded = np.flatnonzero(exclude_table.items)
        M[:, excluded] = 0
    M[:, 0] = 0  # sentinel slot
    return M


def occurrence_pairs(
    item_table: ItemTable,
    path_order: List[Tuple[int, int]],
    exclude_table: Optional[ActiveTable],
) -> Tuple[np.ndarray, np.ndarray]:
    """Concatenate (item, group) occurrence pairs over ordered paths, dropping
    excluded items (reference: coverage loop abacus.rs:719-744)."""
    chunks_i: List[np.ndarray] = []
    chunks_g: List[np.ndarray] = []
    for path_id, group_idx in path_order:
        ids = item_table.path_slice(path_id)
        if len(ids) == 0:
            continue
        chunks_i.append(ids)
        chunks_g.append(np.full(len(ids), group_idx, dtype=np.int32))
    if not chunks_i:
        return np.zeros(0, np.int64), np.zeros(0, np.int32)
    items = np.concatenate(chunks_i)
    groups = np.concatenate(chunks_g)
    if exclude_table is not None:
        keep = ~exclude_table.items[items]
        items, groups = items[keep], groups[keep]
    return items, groups


def quantify_uncovered_bps(
    exclude_table: Optional[ActiveTable],
    subset_covered_bps: Optional[IntervalContainer],
    graph: GraphStorage,
) -> Dict[int, int]:
    """Per-node uncovered bp from partial subset coverage
    (reference: abacus.rs:1187-1229)."""
    res: Dict[int, int] = {}
    if subset_covered_bps is not None:
        for sid in subset_covered_bps.keys():
            if exclude_table is None or not exclude_table.items[sid]:
                l = graph.node_len(sid)
                ex = (
                    exclude_table.get_active_intervals(sid, l)
                    if exclude_table is not None
                    else None
                )
                covered = subset_covered_bps.total_coverage(sid, ex)
                if covered > l:
                    log.error(
                        "oops, total coverage %d is larger than node length %d "
                        "for node %d",
                        covered,
                        l,
                        sid,
                    )
                else:
                    res[sid] = l - covered
    return res


class AbacusByTotal:
    """Coverage histogram per count type, device-backed
    (reference: abacus.rs:476-788)."""

    def __init__(
        self,
        count: CountType,
        engine: CountingEngine,
        groups: List[str],
        uncovered_bps: Dict[int, int],
        graph: GraphStorage,
    ):
        self.count = count
        self.engine = engine
        self.groups = groups
        self.uncovered_bps = uncovered_bps
        self._graph = graph
        self._countable: Optional[np.ndarray] = None

    @classmethod
    def from_itemization(
        cls,
        count: CountType,
        slot: int,
        itemized: ItemizeResult,
        path_order: List[Tuple[int, int]],
        groups: List[str],
        graph: GraphStorage,
    ) -> "AbacusByTotal":
        n_items = graph.number_of_items(count)
        engine = CountingEngine(n_items, len(groups))
        M_host = build_membership_host(
            itemized.item_tables[slot],
            path_order,
            itemized.exclude_tables[slot],
            n_items,
            len(groups),
            engine.n_items_pad,
        )
        engine.build_from_host_matrix(M_host)
        uncovered = quantify_uncovered_bps(
            itemized.exclude_tables[slot],
            itemized.subset_covered_bps if count == CountType.BP else None,
            graph,
        )
        log.info(
            "abacus has %d path groups and %d countables", len(groups), n_items
        )
        return cls(count, engine, groups, uncovered, graph)

    @property
    def countable(self) -> np.ndarray:
        """Per-item coverage; slot 0 is the sentinel (reported as max-u32 to
        mirror reference abacus.rs:551)."""
        if self._countable is None:
            cov = self.engine.coverage().astype(np.int64)
            cov[0] = np.iinfo(np.uint32).max
            self._countable = cov
        return self._countable

    def _hist_weights(self, bps: bool) -> "np.ndarray | None":
        """Weight vector for the total hist; None = all-ones, which the
        engine builds device-side (no host->device weight upload)."""
        if not bps:
            return None
        w = self._graph.node_lens[: self.engine.n_items + 1].astype(np.int32)
        w = w.copy()
        w[0] = 0
        return w

    def _finish_hist_bps(self, hist: np.ndarray) -> np.ndarray:
        if self.uncovered_bps:  # unmasked runs skip the coverage fetch
            cov = self.countable
            for sid, uncov in self.uncovered_bps.items():
                hist[cov[sid]] -= uncov
                hist[0] += uncov
        return hist

    def construct_hist(self) -> np.ndarray:
        log.info("constructing histogram..")
        return self.engine.hist(self._hist_weights(bps=False))

    def construct_hist_bps(self) -> np.ndarray:
        log.info("constructing bp histogram..")
        return self._finish_hist_bps(
            self.engine.hist(self._hist_weights(bps=True))
        )


def construct_hists(abaci: "Dict[CountType, AbacusByTotal]"):
    """All total hists for a run, one device pass over M per count type."""
    return {
        ct: ab.construct_hist_bps()
        if ct == CountType.BP
        else ab.construct_hist()
        for ct, ab in abaci.items()
    }


class AbacusByGroup:
    """Group-resolved coverage built on the same membership matrix
    (reference: abacus.rs:790-1179). Group ids follow the mask's path order;
    ordered growth is a device scan, the table export resolves the sparse
    multiplicity structure host-side."""

    def __init__(
        self,
        count: CountType,
        engine: CountingEngine,
        groups: List[str],
        uncovered_bps: Dict[int, int],
        graph: GraphStorage,
        itemized: ItemizeResult,
        slot: int,
        path_order: List[Tuple[int, int]],
    ):
        self.count = count
        self.engine = engine
        self.groups = groups
        self.uncovered_bps = uncovered_bps
        self._graph = graph
        # kept for lazy multiplicity export (table analysis only)
        self._itemized = itemized
        self._slot = slot
        self._path_order = path_order
        self._sparse_cache: Optional[
            Tuple[np.ndarray, np.ndarray, np.ndarray]
        ] = None

    @classmethod
    def from_itemization(
        cls,
        count: CountType,
        slot: int,
        itemized: ItemizeResult,
        path_order: List[Tuple[int, int]],
        groups: List[str],
        graph: GraphStorage,
    ) -> "AbacusByGroup":
        n_items = graph.number_of_items(count)
        engine = CountingEngine(n_items, len(groups))
        M_host = build_membership_host(
            itemized.item_tables[slot],
            path_order,
            itemized.exclude_tables[slot],
            n_items,
            len(groups),
            engine.n_items_pad,
        )
        engine.build_from_host_matrix(M_host)
        uncovered = quantify_uncovered_bps(
            itemized.exclude_tables[slot],
            itemized.subset_covered_bps if count == CountType.BP else None,
            graph,
        )
        log.info(
            "group abacus has %d path groups and %d countables",
            len(groups),
            n_items,
        )
        return cls(
            count, engine, groups, uncovered, graph, itemized, slot, path_order
        )

    def _weights(self) -> np.ndarray:
        """Per-item growth weight: 1 for node/edge, covered bp for bp
        (reference: abacus.rs:1010-1026)."""
        n = self.engine.n_items
        if self.count == CountType.BP:
            w = self._graph.node_lens[: n + 1].astype(np.int64).copy()
            for sid, uncov in self.uncovered_bps.items():
                covered = int(w[sid])
                if uncov > covered:
                    log.error(
                        "oops, #uncovered bps (%d) is larger than #covered bps "
                        "(%d) for node with sid %d",
                        uncov,
                        covered,
                        sid,
                    )
                    w[sid] = 0
                else:
                    w[sid] = covered - uncov
        else:
            w = np.ones(n + 1, dtype=np.int64)
        w[0] = 0
        return w

    def calc_growth(
        self, t_coverage: Threshold, t_quorum: Threshold
    ) -> List[float]:
        """Ordered growth curve (reference: abacus.rs:988-1032)."""
        n_groups = len(self.groups)
        c = max(1, t_coverage.to_absolute(n_groups))
        q = max(0.0, t_quorum.to_relative(n_groups))
        res = self.engine.ordered_growth(self._weights(), q, c)
        return [float(x) for x in res]

    def similarity_matrix(self) -> Tuple[np.ndarray, np.ndarray]:
        """(intersections[G,G], sizes[G]) weighted by node length for bp
        (reference: src/analyses/similarity.rs:119-163)."""
        if self.count == CountType.BP:
            w = self._graph.node_lens[: self.engine.n_items + 1].astype(
                np.float32
            )
        else:
            w = np.ones(self.engine.n_items + 1, dtype=np.float32)
        w[0] = 0.0
        inter = self.engine.similarity(w)
        sizes = np.diagonal(inter).copy()
        return inter, sizes

    def sparse_counts(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(items, group_ids, multiplicities) of the occurrence matrix —
        the CSC (r, c, v) equivalent for table export
        (reference: compute_column_values abacus.rs:901-986).

        Streams one group at a time (dense bincount per group) instead of
        materializing every occurrence pair at once: peak extra memory is
        one group's visits plus the final nnz arrays."""
        if self._sparse_cache is not None:
            return self._sparse_cache
        n_groups = len(self.groups)
        table = self._itemized.item_tables[self._slot]
        ex = self._itemized.exclude_tables[self._slot]
        n_items = self.engine.n_items
        paths_by_group: List[List[int]] = [[] for _ in range(n_groups)]
        for pid, gi in self._path_order:
            paths_by_group[gi].append(pid)
        excluded = (
            np.flatnonzero(ex.items) if ex is not None else None
        )
        per_group: List[Tuple[int, np.ndarray, np.ndarray]] = []
        row_counts = np.zeros(n_items + 2, dtype=np.int64)
        for gi, pids in enumerate(paths_by_group):
            slices = [s for s in map(table.path_slice, pids) if len(s)]
            if not slices:
                continue
            visits = slices[0] if len(slices) == 1 else np.concatenate(slices)
            cnt = np.bincount(visits, minlength=n_items + 1)
            if excluded is not None and len(excluded):
                cnt[excluded] = 0
            cnt[0] = 0
            nz = np.flatnonzero(cnt)
            if not len(nz):
                continue
            per_group.append((gi, nz, cnt[nz].astype(np.int64)))
            row_counts[nz + 1] += 1
        if getattr(self._itemized, "mh_table_local", False):
            import jax

            if jax.process_count() > 1:
                # path-sliced multi-host: this process's item tables only
                # cover its group range — allgather the (item, group,
                # multiplicity) triplets (group ranges are disjoint, so
                # concatenation has no duplicates) and restore the
                # items-major, groups-in-path-order layout with one sort
                from .parallel.ingest import allgather_rows

                tri = np.zeros((0, 3), dtype=np.int64)
                if per_group:
                    tri = np.concatenate(
                        [
                            np.column_stack(
                                [nz, np.full(len(nz), gi), c]
                            )
                            for gi, nz, c in per_group
                        ]
                    )
                allt = np.concatenate(allgather_rows(tri))
                order = np.lexsort((allt[:, 1], allt[:, 0]))
                allt = allt[order]
                self._sparse_cache = (
                    allt[:, 0].copy(),
                    allt[:, 1].copy(),
                    allt[:, 2].copy(),
                )
                return self._sparse_cache
        if not per_group:
            z = np.zeros(0, dtype=np.int64)
            return z, z.copy(), z.copy()
        # O(nnz) counting placement instead of a global sort: each group's
        # nonzero list is item-sorted and items are unique within a group,
        # so ptr[nz] gather + increment places (item, group) runs in
        # row-major order with groups in path order per item
        ptr = np.cumsum(row_counts)[:-1]
        nnz = int(ptr[-1] + row_counts[-1])
        items = np.empty(nnz, dtype=np.int64)
        group_ids = np.empty(nnz, dtype=np.int64)
        counts = np.empty(nnz, dtype=np.int64)
        for gi, nz, c in per_group:
            pos = ptr[nz]
            items[pos] = nz
            group_ids[pos] = gi
            counts[pos] = c
            ptr[nz] += 1
        self._sparse_cache = (items, group_ids, counts)
        return self._sparse_cache

    def to_tsv(self, total: bool, graph: GraphStorage) -> str:
        """Full or total coverage table (reference: abacus.rs:1056-1178).

        Chunked and vectorized: dense per-chunk rows scattered from the
        sparse counts, decimal-formatted by the threaded native formatter
        (numpy/python fallback when unavailable)."""
        log.info("reporting coverage table")
        n_groups = len(self.groups)
        items, group_ids, counts = self.sparse_counts()
        n_items = self.engine.n_items
        starts = np.searchsorted(items, np.arange(1, n_items + 2))

        head = "node" if self.count in (CountType.NODE, CountType.BP) else "edge"
        header = head + (
            "\ttotal" if total else "".join(f"\t{g}" for g in self.groups)
        ) + "\n"

        # per-item bp multiplier (covered bp for bp counts, else 1)
        if self.count == CountType.BP:
            bp = self._graph.node_lens[: n_items + 1].astype(np.int64).copy()
            for sid, unc in self.uncovered_bps.items():
                bp[sid] -= unc
        else:
            bp = None

        from .native import format_table
        from .runtime import effective_threads

        body: List[bytes] = []
        CHUNK = 1 << 16
        dense = None if total else np.zeros((CHUNK, n_groups), dtype=np.int64)
        for lo in range(1, n_items + 1, CHUNK):
            hi = min(lo + CHUNK, n_items + 1)
            n_rows = hi - lo
            a, b = starts[lo - 1], starts[hi - 1]
            if total:
                vals = np.diff(starts[lo - 1 : hi]).reshape(-1, 1)
            else:
                # each present group gets its multiplicity (x bp for bp
                # counts); the reference's edge branch (abacus.rs:1164)
                # mis-indexes v by group id — we emit the evidently
                # intended per-slot multiplicity
                mult = counts[a:b]
                if bp is not None:
                    mult = mult * bp[items[a:b]]
                vals = dense[:n_rows]
                vals[items[a:b] - lo, group_ids[a:b]] = mult
            ids = np.arange(lo, hi, dtype=np.int64)
            names = (
                graph.node_names_fixed(ids)
                if head == "node"
                else graph.edge_names_fixed(ids)
            )
            blob = format_table(vals, names, effective_threads())
            if blob is None:
                return header + self._to_tsv_rows_python(
                    total, graph, items, group_ids, counts, starts, bp
                )
            body.append(blob)
            if not total:
                # clear only the cells this chunk scattered (buffer reuse)
                vals[items[a:b] - lo, group_ids[a:b]] = 0
        return header + b"".join(body).decode("utf-8")

    def _to_tsv_rows_python(
        self, total, graph, items, group_ids, counts, starts, bp
    ) -> str:
        """Scalar fallback row formatter (no native lib)."""
        n_groups = len(self.groups)
        n_items = self.engine.n_items
        name_of = (
            graph.node_name
            if self.count in (CountType.NODE, CountType.BP)
            else graph.edge_name
        )
        out: List[str] = []
        for i in range(1, n_items + 1):
            a, b = starts[i - 1], starts[i]
            out.append(name_of(i))
            if total:
                out.append(f"\t{b - a}\n")
                continue
            row = np.zeros(n_groups, dtype=np.int64)
            mult = counts[a:b]
            if bp is not None:
                mult = mult * bp[i]
            row[group_ids[a:b]] = mult
            out.append("\t")
            out.append("\t".join(str(x) for x in row))
            out.append("\n")
        return "".join(out)
