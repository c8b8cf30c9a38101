"""Host-side GFA1 front-end: single-pass, columnar, numpy-vectorized.

Replaces the reference's byte-scanning multi-pass parser
(reference: src/graph_broker/graph.rs:168-467, src/graph_broker/util.rs:368-1248)
with one mmap/decompress pass that indexes every line, then lazily
materialises per-path item runs as dense integer arrays ready for device
upload. String work stays on the host; everything downstream is arrays.
"""

from __future__ import annotations

import gzip
import logging
import re
import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

log = logging.getLogger("panacus")

# large-buffer parsing wants heap reuse on lazy-memory VMs
from .runtime import configure_host_memory

configure_host_memory()

# PanSN path name handling (reference: src/graph_broker/graph.rs:16-18)
PATHID_PANSN = re.compile(r"^([^#]+)(#[^#]+)?(#[^#].*)?$")
PATHID_COORDS = re.compile(r"^(.+):([0-9]+)-([0-9]+)$")

FORWARD = 0
BACKWARD = 1


@dataclass(frozen=True)
class PathSegment:
    """PanSN-spec path identifier sample[#haplotype[#seqid]][:start-end]
    (reference: src/graph_broker/graph.rs:469-627)."""

    sample: str
    haplotype: Optional[str] = None
    seqid: Optional[str] = None
    start: Optional[int] = None
    end: Optional[int] = None

    @classmethod
    def from_str(cls, s: str) -> "PathSegment":
        sample, haplotype, seqid, start, end = s, None, None, None, None
        m = PATHID_PANSN.match(s)
        if m:
            segs = [g for g in m.groups() if g is not None]
            if len(segs) == 3:
                sample = segs[0]
                haplotype = segs[1][1:]
                mc = PATHID_COORDS.match(segs[2][1:])
                if mc is None:
                    seqid = segs[2][1:]
                else:
                    seqid = mc.group(1)
                    start = int(mc.group(2))
                    end = int(mc.group(3))
            elif len(segs) == 2:
                sample = segs[0]
                mc = PATHID_COORDS.match(segs[1][1:])
                if mc is None:
                    haplotype = segs[1][1:]
                else:
                    haplotype = mc.group(1)
                    start = int(mc.group(2))
                    end = int(mc.group(3))
            elif len(segs) == 1:
                mc = PATHID_COORDS.match(segs[0])
                if mc is not None:
                    sample = mc.group(1)
                    start = int(mc.group(2))
                    end = int(mc.group(3))
        return cls(sample, haplotype, seqid, start, end)

    @classmethod
    def new(cls, sample, haplotype, seqid, start, end) -> "PathSegment":
        return cls(sample, haplotype, seqid, start, end)

    def id(self) -> str:
        if self.haplotype is not None:
            if self.seqid is not None:
                return f"{self.sample}#{self.haplotype}#{self.seqid}"
            return f"{self.sample}#{self.haplotype}"
        if self.seqid is not None:
            return f"{self.sample}#*#{self.seqid}"
        return self.sample

    def clear_coords(self) -> "PathSegment":
        return PathSegment(self.sample, self.haplotype, self.seqid, None, None)

    def coords(self) -> Optional[Tuple[int, int]]:
        if self.start is not None and self.end is not None:
            return (self.start, self.end)
        return None

    def __str__(self) -> str:
        c = self.coords()
        if c is not None:
            return f"{self.id()}:{c[0]}-{c[1]}"
        return self.id()


def _gz_capacity_hint(gfa_file: str) -> int:
    """Output-buffer capacity for a gzip file from its ISIZE footer,
    CLAMPED: a corrupt/truncated .gz can carry an arbitrary 32-bit ISIZE,
    which would force a multi-GiB zero-filled allocation before the
    stream is ever validated; the callers' growth loops handle
    underestimates (multi-member files report only the last member)."""
    import os as _os

    csize = _os.path.getsize(gfa_file)
    isize = 0
    try:
        with open(gfa_file, "rb") as raw:
            raw.seek(-4, 2)
            isize = int.from_bytes(raw.read(4), "little")
    except OSError:
        pass
    return max(min(isize, 64 * csize), 2 * csize, 1 << 20)


def _read_gz_streamed(gfa_file: str) -> bytearray:
    """Decompress a (possibly multi-member) gzip file into ONE buffer.

    Fast path: whole-buffer inflate via system libdeflate (faster than
    zlib streaming; member-by-member for concatenated streams). Fallback:
    stream through gzip.open with readinto into a growing buffer — no
    chunk-list accumulation + join either way, so peak memory stays ~1x
    the uncompressed size (the reference streams through MultiGzDecoder,
    src/io.rs:23-33; our columnar indexer needs the whole buffer, so we
    decompress *into* it). The initial capacity comes from the gzip ISIZE
    footer via _gz_capacity_hint (exact for single-member files, a floor
    otherwise)."""
    cap = _gz_capacity_hint(gfa_file)

    from .native import gzip_decompress_buffer

    try:
        raw_map = np.memmap(gfa_file, dtype=np.uint8, mode="r")
        out = gzip_decompress_buffer(raw_map, cap)
        if out is not None:
            return out
    except (OSError, ValueError):
        pass

    buf = bytearray(cap)
    pos = 0
    with gzip.open(gfa_file, "rb") as f:
        while True:
            if pos == len(buf):
                buf.extend(bytes(len(buf) // 2))  # grow 1.5x
            n = f.readinto(memoryview(buf)[pos:])
            if not n:
                break
            pos += n
    del buf[pos:]
    return buf


def _read_all(gfa_file: str):
    """Whole-file buffer: gzip stream-decompressed into one buffer, or a
    read-only mmap for plain files (no copy; repeat runs hit the page
    cache). Falls back to a bytes copy when the file doesn't end in a
    newline."""
    log.info("loading graph from %s", gfa_file)
    if gfa_file.endswith(".gz"):
        log.info("assuming that %s is gzip compressed..", gfa_file)
        return _read_gz_streamed(gfa_file)
    with open(gfa_file, "rb") as f:
        try:
            import mmap

            mm = mmap.mmap(f.fileno(), 0, prot=mmap.PROT_READ)
        except (ValueError, OSError):
            return f.read()
        if len(mm) and mm[-1:] == b"\n":
            return mm
        data = bytes(mm)
        mm.close()
        return data


def _parse_ints_from_spans(
    buf: np.ndarray, starts: np.ndarray, ends: np.ndarray
) -> Optional[np.ndarray]:
    """Decimal parse of byte spans [start, end). Returns None if any span
    contains a non-digit or is empty. Native single-pass when available,
    numpy digit-position passes otherwise."""
    n = len(starts)
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    if n >= 1024:
        from .native import parse_int_spans

        lens = ends - starts
        if (lens > 0).all() and lens.max() <= 18:
            res = parse_int_spans(buf, starts, ends)
            if res is not None:
                return res
        else:
            return None
    lens = ends - starts
    if (lens <= 0).any():
        return None
    max_len = int(lens.max())
    if max_len > 18:
        return None
    vals = np.zeros(n, dtype=np.int64)
    p10 = np.int64(1)
    for k in range(max_len):
        active = lens > k
        pos = ends[active] - 1 - k
        d = buf[pos].astype(np.int64) - 48
        if len(d) and ((d < 0) | (d > 9)).any():
            return None
        vals[active] += d * p10
        p10 *= 10
    return vals


class ItemTable:
    """CSR of path -> item ids (reference: src/util.rs:80-93).

    items holds int64 ids concatenated across paths; prefsum[p]..prefsum[p+1]
    delimits path p. Built incrementally with python lists of arrays, then
    finalized to contiguous numpy.
    """

    def __init__(self, num_paths: int):
        self._chunks: List[np.ndarray] = []
        self.prefsum = np.zeros(num_paths + 1, dtype=np.int64)
        self._count = 0

    def append(self, path_idx: int, ids: np.ndarray) -> None:
        self._chunks.append(np.asarray(ids, dtype=np.int64))
        self._count += len(ids)
        self.prefsum[path_idx + 1] = self._count

    def close_path(self, path_idx: int) -> None:
        self.prefsum[path_idx + 1] = self._count

    def adopt(self, items: np.ndarray, prefsum: np.ndarray) -> None:
        """Take ownership of fully-built CSR storage (batch tokenizer path)."""
        self.items = items
        self.prefsum = prefsum
        self._count = len(items)
        self._chunks = None

    def finalize(self) -> None:
        if self._chunks is None:  # already adopted
            return
        self.items = (
            np.concatenate(self._chunks)
            if self._chunks
            else np.zeros(0, dtype=np.int64)
        )
        self._chunks = None

    def path_slice(self, path_idx: int) -> np.ndarray:
        return self.items[self.prefsum[path_idx] : self.prefsum[path_idx + 1]]


class SlabbedItemTable:
    """ItemTable built from per-slab CSR pieces (streamed membership build,
    see panacus_jax/stream.py). `path_slice` resolves through a slab index;
    `.items`/`.prefsum` materialize the global path-ordered CSR lazily (only
    the coverage-table export walks them)."""

    def __init__(self, num_paths: int):
        self.num_paths = num_paths
        self._slabs: List[Tuple[np.ndarray, np.ndarray, np.ndarray]] = []
        self._where: Dict[int, Tuple[int, int]] = {}
        self._items: Optional[np.ndarray] = None
        self._prefsum: Optional[np.ndarray] = None

    def add_slab(
        self, path_ids: np.ndarray, ids: np.ndarray, prefsum: np.ndarray
    ) -> None:
        s = len(self._slabs)
        self._slabs.append((path_ids, ids, prefsum))
        for k, p in enumerate(path_ids):
            self._where[int(p)] = (s, k)

    def path_slice(self, path_idx: int) -> np.ndarray:
        loc = self._where.get(path_idx)
        if loc is None:
            return np.zeros(0, dtype=np.int64)
        s, k = loc
        _, ids, prefsum = self._slabs[s]
        return ids[prefsum[k] : prefsum[k + 1]]

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


class GraphStorage:
    """Indexed view of one GFA file.

    One file read; line classification and segment indexing are vectorized.
    Holds: node id table (dense 1..n in S-line order, id 0 reserved as
    sentinel like reference graph.rs:324), node lengths, path metadata and raw
    payload spans for lazy itemization, canonical edge table if requested.
    """

    def __init__(self, gfa_file: str, index_edges: bool, nice: bool = False):
        self.gfa_file = gfa_file
        self.is_nice = nice
        follow = None
        if gfa_file.endswith(".gz"):
            # overlapped ingest: structural indexing + path tokenization
            # chase the libdeflate frontier on a second core (gz_pipeline)
            from .gz_pipeline import read_gz_overlapped

            log.info("loading graph from %s", gfa_file)
            log.info("assuming that %s is gzip compressed..", gfa_file)
            data, follow = read_gz_overlapped(gfa_file)
        else:
            data = _read_all(gfa_file)
        if isinstance(data, (bytes, bytearray)) and data and not data.endswith(
            b"\n"
        ):
            data += b"\n"
            follow = None  # line coverage changed; reindex from scratch
        self._data = data
        buf = np.frombuffer(data, dtype=np.uint8)
        self._buf = buf

        from .native import scan_lines
        from .runtime import effective_threads

        # the global tab index is only needed by the numpy fallback
        # parsers; native field parsers (pt_s_spans / pt_index_edges /
        # pt_tokenize) re-scan their own lines, so skip its ~8 bytes of
        # writes per tab and materialize it lazily (_tabs property).
        # (The lazy path re-runs the scan — acceptable: it only triggers
        # for non-native fallbacks, e.g. non-integer node names, whose
        # per-line numpy parsing dwarfs one extra threaded scan. With no
        # native lib at all, scan_lines returns None and the flatnonzero
        # fallback below fills both arrays in this one pass.)
        if follow is not None and follow.lines_ok:
            # the gz follower already scanned/classified every line while
            # the buffer was being inflated
            starts, ends, first = follow.starts, follow.ends, follow.first
            tabs = None
        else:
            scanned = scan_lines(buf, effective_threads(), want_tabs=False)
            if scanned is not None:
                nl, tabs = scanned
            else:
                nl = np.flatnonzero(buf == 10)
                tabs = np.flatnonzero(buf == 9)
            from .native import classify_lines

            cls = classify_lines(buf, nl) if scanned is not None else None
            if cls is not None:
                # one C pass (~6 ops/line) instead of four full-width
                # numpy temporaries
                starts, ends, first = cls
            else:
                starts = np.empty(len(nl), dtype=np.int64)
                if len(nl):
                    starts[0] = 0
                    starts[1:] = nl[:-1] + 1
                ends = nl  # position of '\n'
                # strip trailing '\r'
                ends_stripped = ends - (buf[np.maximum(ends - 1, 0)] == 13)
                nonempty = ends_stripped > starts
                starts, ends = starts[nonempty], ends_stripped[nonempty]
                first = buf[starts]
        self._line_starts = starts
        self._line_ends = ends
        self._tabs_arr = tabs
        self._tabs_lock = threading.Lock()
        self._name_hash_lock = threading.Lock()

        is_s = first == ord("S")
        is_p = first == ord("P")
        is_w = first == ord("W")
        is_l = first == ord("L")

        log.info(
            "constructing indexes for node/edge IDs, node lengths, and P/W lines.."
        )
        self._index_nodes(
            starts[is_s],
            ends[is_s],
            pre=follow if (follow is not None and follow.s_ok) else None,
        )

        # paths/walks in file order
        pw_mask = is_p | is_w
        self._pw_starts = starts[pw_mask]
        self._pw_ends = ends[pw_mask]
        self._pw_is_walk = first[pw_mask] == ord("W")
        self.path_segments: List[PathSegment] = []
        self._pw_seq_spans: List[Tuple[int, int]] = []
        self._index_paths()
        self._pretok = None
        if follow is not None and follow.pretok_batches:
            self._adopt_pretok(follow)

        log.info(
            "found: %d paths/walks, %d nodes",
            len(self.path_segments),
            self.node_count,
        )
        if not self.path_segments:
            log.warning("graph does not contain any annotated paths (P/W lines)")

        self._edge_count = 0
        self._edge_keys_sorted: Optional[np.ndarray] = None
        self._edge_ids_sorted: Optional[np.ndarray] = None
        self._edge_hash = None
        self._edge_adj = None
        self._edges_u = self._edges_o1 = None
        self._edges_v = self._edges_o2 = None
        self._degree: Optional[np.ndarray] = None
        self._edge_future = None
        if index_edges:
            # L-line indexing runs in a worker thread (the native parser
            # releases the GIL), overlapping with the caller's path
            # tokenization — on few-core hosts this hides most of the edge
            # index cost behind the streamed membership build. Every edge
            # accessor joins first (_ensure_edges).
            from concurrent.futures import ThreadPoolExecutor

            ex = ThreadPoolExecutor(max_workers=1)

            def _index_job(ls, le):
                from .native import install_thread_allocator

                install_thread_allocator()  # context-local numpy handler
                return self._index_edges(ls, le)

            self._edge_future = ex.submit(_index_job, starts[is_l], ends[is_l])
            ex.shutdown(wait=False)

    @property
    def _tabs(self) -> np.ndarray:
        """Global tab-position index, materialized on first use — only the
        numpy fallback parsers read it; the native field parsers re-scan
        their own lines."""
        # lock: the async edge-index worker and the main thread can both
        # fall back here concurrently; without it the full scan runs twice
        with self._tabs_lock:
            if self._tabs_arr is None:
                from .native import scan_lines
                from .runtime import effective_threads

                scanned = scan_lines(
                    self._buf, effective_threads(), want_tabs=True
                )
                self._tabs_arr = (
                    scanned[1]
                    if scanned is not None
                    else np.flatnonzero(self._buf == 9)
                )
        return self._tabs_arr

    def _ensure_edges(self) -> None:
        f = self._edge_future
        if f is not None:
            self._edge_future = None
            f.result()  # re-raises indexing errors at first edge use

    @property
    def edge_count(self) -> int:
        self._ensure_edges()
        return self._edge_count

    @property
    def degree(self) -> Optional[np.ndarray]:
        self._ensure_edges()
        return self._degree

    @property
    def edges_u(self):
        self._ensure_edges()
        return self._edges_u

    @property
    def edges_o1(self):
        self._ensure_edges()
        return self._edges_o1

    @property
    def edges_v(self):
        self._ensure_edges()
        return self._edges_v

    @property
    def edges_o2(self):
        self._ensure_edges()
        return self._edges_o2

    def edge_hash(self):
        """Lazy native hash table over canonical edge keys (or None)."""
        self._ensure_edges()
        if self._edge_hash is None and self._edge_keys_sorted is not None:
            from .native import build_edge_hash

            self._edge_hash = build_edge_hash(
                self._edge_keys_sorted, self._edge_ids_sorted
            )
        return self._edge_hash

    def edge_adj(self):
        """Lazy native CSR adjacency over canonical source nodes (or None):
        the cache-friendly lookup structure for the hot path itemizer (the
        open hash costs a random DRAM miss per pair on large graphs)."""
        self._ensure_edges()
        if self._edge_adj is None and self._edges_u is not None:
            from .native import build_edge_adj

            self._edge_adj = build_edge_adj(
                self._edges_u,
                self._edges_o1,
                self._edges_v,
                self._edges_o2,
                self.node_count,
            )
        return self._edge_adj

    # -- nodes ----------------------------------------------------------------

    def _index_nodes(
        self, s_starts: np.ndarray, s_ends: np.ndarray, pre=None
    ) -> None:
        from .native import s_spans
        from .runtime import effective_threads

        n = len(s_starts)
        name_starts = s_starts + 2
        res = None
        fused_ints = False
        if pre is not None and len(pre.s_name_ends) == n:
            # gz follower parsed the S lines behind the inflate frontier
            res = (pre.s_name_ends, pre.s_seq_lens)
        else:
            pre = None
        if res is None:
            # the decimal-name parse rides the same cache-hot native pass
            res = s_spans(
                self._buf, s_starts, s_ends, effective_threads(),
                want_ints=True,
            )
            fused_ints = res is not None
        if res is not None:
            name_ends, seq_lens = res[0], res[1]
        else:
            tabs = self._tabs
            # first tab of an S line is at s+1; name spans (s+2, t2)
            t2_idx = np.searchsorted(tabs, s_starts + 2)
            t2 = tabs[t2_idx] if n else np.zeros(0, dtype=np.int64)
            # sequence ends at following tab (optional fields) or line end
            t3_idx = t2_idx + 1
            t3 = np.where(
                (t3_idx < len(tabs)) & (np.take(tabs, np.minimum(t3_idx, len(tabs) - 1)) < s_ends),
                np.take(tabs, np.minimum(t3_idx, len(tabs) - 1)),
                s_ends,
            ) if n else np.zeros(0, dtype=np.int64)
            name_ends = t2
            seq_lens = (t3 - (t2 + 1)).astype(np.int64)
            if (seq_lens < 0).any():
                raise ValueError("malformed S line in GFA")

        self.node_count = n
        self.node_lens = np.zeros(n + 1, dtype=np.uint32)
        self.node_lens[1:] = seq_lens

        # fast path: integer node names; nicest case is names == 1..n
        self._node2id: Optional[Dict[bytes, int]] = None
        self._int_names: Optional[np.ndarray] = None
        self._name_spans = (name_starts, name_ends)
        self._name_hash_cache = False  # lazily built for string-name graphs
        if pre is not None and pre.int_mode is not None:
            # adopt the follower's identity/sorted decision (same logic,
            # computed during inflate); the tokenize cache was built
            # against exactly these arrays
            self._int_names = pre.s_ints
            self._int_name_mode = pre.int_mode
            if pre.int_mode == "sorted":
                self._int_sorted = pre.int_sorted
                self._int_sorted_ids = pre.int_sorted_ids
            return
        if pre is not None and pre.s_ints is not None:
            ints = pre.s_ints
        elif fused_ints:
            ints = res[2]
        else:
            ints = _parse_ints_from_spans(self._buf, name_starts, name_ends)
        if ints is not None:
            self._int_names = ints
            if n and bool((ints == np.arange(1, n + 1)).all()):
                self._int_name_mode = "identity"
            else:
                # integer names, arbitrary values: sorted lookup table
                order = np.argsort(ints, kind="stable")
                sorted_ints = ints[order]
                if len(sorted_ints) != len(np.unique(sorted_ints)):
                    raise ValueError("Segment occurs multiple times in GFA")
                self._int_sorted = sorted_ints
                self._int_sorted_ids = order.astype(np.int64) + 1
                self._int_name_mode = "sorted"
        else:
            self._int_name_mode = None
            d: Dict[bytes, int] = {}
            data = self._data
            for i in range(n):
                # bytes(): gz-streamed buffers are bytearray (unhashable)
                name = bytes(data[name_starts[i] : name_ends[i]])
                if name in d:
                    raise ValueError(
                        f"Segment with ID {name.decode()} occurs multiple times in GFA"
                    )
                d[name] = i + 1
            self._node2id = d

    def node_name(self, iid: int) -> str:
        if self._int_name_mode == "identity":
            return str(iid)
        ns, ne = self._name_spans
        return self._data[ns[iid - 1] : ne[iid - 1]].decode()

    def get_node_id(self, name: bytes) -> Optional[int]:
        if self._int_name_mode == "identity":
            try:
                v = int(name)
            except ValueError:
                return None
            return v if 1 <= v <= self.node_count else None
        if self._int_name_mode == "sorted":
            try:
                v = int(name)
            except ValueError:
                return None
            i = np.searchsorted(self._int_sorted, v)
            if i < len(self._int_sorted) and self._int_sorted[i] == v:
                return int(self._int_sorted_ids[i])
            return None
        return self._node2id.get(name)

    def _ids_from_int_names(self, vals: np.ndarray, what: str) -> np.ndarray:
        if self._int_name_mode == "identity":
            bad = (vals < 1) | (vals > self.node_count)
            if bad.any():
                raise ValueError(f"unknown node {vals[bad][0]} in {what}")
            return vals
        idx = np.searchsorted(self._int_sorted, vals)
        idx_c = np.minimum(idx, len(self._int_sorted) - 1)
        bad = self._int_sorted[idx_c] != vals
        if bad.any():
            raise ValueError(f"unknown node {vals[bad][0]} in {what}")
        return self._int_sorted_ids[idx_c]

    def node_len(self, iid: int) -> int:
        return int(self.node_lens[iid])

    def number_of_items(self, count) -> int:
        from .utils import CountType

        if count in (CountType.NODE, CountType.BP):
            return self.node_count
        if count == CountType.EDGE:
            return self.edge_count
        raise ValueError("inadmissible count type")

    # -- paths ----------------------------------------------------------------

    def _index_paths(self) -> None:
        # per-line memchr finds (data.find is C-speed for mmap/bytes);
        # P/W line counts are tiny, and this never touches the global tab
        # index — only the P-line t3 find crosses the (large) seq field
        data = self._data

        def tab_after(pos: int, end: int) -> int:
            t = data.find(b"\t", pos, end)
            return t if t >= 0 else end

        for k in range(len(self._pw_starts)):
            s, e = int(self._pw_starts[k]), int(self._pw_ends[k])
            if self._pw_is_walk[k]:
                # W \t sample \t hap \t seqid \t start \t end \t walk
                t = []
                pos = s
                for _ in range(6):
                    pos = tab_after(pos + 1, e)
                    t.append(pos)
                cols = [data[t[j] + 1 : t[j + 1]].decode() for j in range(5)]
                seq_start = None if cols[3] == "*" else int(cols[3])
                seq_end = None if cols[4] == "*" else int(cols[4])
                seg = PathSegment.new(cols[0], cols[1], cols[2], seq_start, seq_end)
                self._pw_seq_spans.append((t[5] + 1, e))
            else:
                # P \t name \t seq \t overlaps
                t1 = tab_after(s, e)
                t2 = tab_after(t1 + 1, e)
                t3 = tab_after(t2 + 1, e)
                name = data[t1 + 1 : t2].decode()
                seg = PathSegment.from_str(name)
                self._pw_seq_spans.append((t2 + 1, t3))
            self.path_segments.append(seg)

    def _adopt_pretok(self, follow) -> None:
        """Adopt the gz follower's per-path token CSR cache. Each cached
        entry is trusted only if its recorded payload span and walk flag
        match this class's authoritative parse (_index_paths) — a mismatch
        silently leaves the line uncached."""
        if follow.int_mode != self._int_name_mode:
            return
        n_pw = len(self._pw_starts)
        if n_pw == 0:
            return
        spans = np.asarray(self._pw_seq_spans, dtype=np.int64)
        loc = np.full(n_pw, -1, dtype=np.int64)
        batches = []
        for b_no, (pw_idx, sp, walk, ids, orient, prefsum, bp) in enumerate(
            follow.pretok_batches
        ):
            valid = (pw_idx >= 0) & (pw_idx < n_pw)
            pw_c = np.clip(pw_idx, 0, n_pw - 1)
            ok = (
                valid
                & (spans[pw_c, 0] == sp[:, 0])
                & (spans[pw_c, 1] == sp[:, 1])
                & (self._pw_is_walk[pw_c] == walk)
            )
            loc[pw_idx[ok]] = (b_no << 32) | np.flatnonzero(ok)
            batches.append((ids, orient, prefsum, bp))
        if (loc >= 0).any():
            self._pretok = (loc, batches)

    def _runs_from_pretok(self, path_indices, pack):
        """Serve all_path_item_runs from the gz follower's token cache.
        Returns the (ids, orient, prefsum, bp) batch — applying the fused
        membership pack exactly like the native fused tokenizer would —
        or None when any selected path is uncached (caller re-tokenizes)."""
        loc, batches = self._pretok
        sel = (
            np.arange(len(self._pw_starts), dtype=np.int64)
            if path_indices is None
            else np.asarray(path_indices, dtype=np.int64)
        )
        locs = loc[sel]
        if len(locs) == 0 or (locs < 0).any():
            return None
        b_nos = locs >> 32
        ks = locs & 0xFFFFFFFF
        n = len(sel)
        lens = np.empty(n, dtype=np.int64)
        bp = np.zeros(max(n, 1), dtype=np.uint64)
        for b_no in np.unique(b_nos):
            m = b_nos == b_no
            _i, _o, pf, b_bp = batches[b_no]
            lens[m] = pf[ks[m] + 1] - pf[ks[m]]
            if b_bp is not None:
                bp[np.flatnonzero(m)] = b_bp[ks[m]]
        prefsum = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(lens, out=prefsum[1:])
        ids = np.empty(prefsum[-1], dtype=np.int64)
        orient = np.empty(prefsum[-1], dtype=np.uint8)
        # copy maximal contiguous runs (consecutive batch entries in both
        # source and destination collapse to one memcpy — the common case:
        # slabs select contiguous pw ranges in tokenize order), instead of
        # one interpreted slice copy per path
        j = 0
        while j < n:
            e = j + 1
            while (
                e < n
                and b_nos[e] == b_nos[j]
                and ks[e] == ks[e - 1] + 1
            ):
                e += 1
            b_ids, b_or, b_pf, _bb = batches[b_nos[j]]
            a, b = b_pf[ks[j]], b_pf[ks[e - 1] + 1]
            ids[prefsum[j] : prefsum[e]] = b_ids[a:b]
            orient[prefsum[j] : prefsum[e]] = b_or[a:b]
            j = e
        if pack:
            from .native import build_membership, pack_edges_adj
            from .runtime import effective_threads

            gbit = np.ascontiguousarray(pack["pack_gbit"], dtype=np.int64)
            nrow = pack.get("pack_node_row")
            if nrow is not None:
                done = build_membership(
                    ids,
                    prefsum,
                    np.arange(n, dtype=np.int64),
                    gbit,
                    nrow.reshape(1, -1),
                    effective_threads(),
                )
                if not done:
                    return None  # native gone mid-run: let caller re-tokenize
                nrow[0] = 0  # sentinel slot (matches stream._pack_row)
            erow = pack.get("pack_edge_row")
            if erow is not None:
                if not pack_edges_adj(
                    ids,
                    orient,
                    prefsum,
                    gbit,
                    pack["pack_edge_adj"],
                    erow,
                    effective_threads(),
                ):
                    return None
                erow[0] = 0
        return ids, orient, prefsum, bp

    def all_path_item_runs(
        self,
        path_indices: Optional[np.ndarray] = None,
        pack: Optional[dict] = None,
    ):
        """Tokenize P/W lines in one threaded native call — every line, or
        only `path_indices` (multi-host ingest: each host tokenizes its
        slice of the path set; see parallel/ingest.py).

        `pack`: optional fused membership pack (streamed builder hot
        path) — kwargs forwarded to tokenize_batch (pack_gbit,
        pack_node_row, pack_edge_adj, pack_edge_row): each path's ids are
        ORed into the rows inside the tokenize pass, cache-hot.

        Returns (ids, orient, prefsum, bp_per_path) over the selected paths
        (path k of the selection spans ids[prefsum[k]:prefsum[k+1]]), or
        None when the native path doesn't apply (non-integer names, no
        native lib) — callers fall back to path_item_run."""
        if not len(self._pw_starts):
            return None
        if self._pretok is not None:
            res = self._runs_from_pretok(path_indices, pack)
            if res is not None:
                return res
        from .native import tokenize_batch
        from .runtime import effective_threads

        spans = np.asarray(self._pw_seq_spans, dtype=np.int64)
        walk = self._pw_is_walk
        if path_indices is not None:
            spans = spans[path_indices]
            walk = walk[path_indices]
            if not len(spans):
                z = np.zeros(0, np.int64)
                return z, np.zeros(0, np.uint8), np.zeros(1, np.int64), z
        kwargs = dict(
            mode=1,
            n_items=self.node_count,
            node_lens=self.node_lens,
            n_threads=effective_threads(),
        )
        if self._int_name_mode is None:
            nh = self.name_hash()
            if nh is None:
                return None
            kwargs.update(mode=3, name_hash=nh)
        elif self._int_name_mode != "identity":
            kwargs.update(
                mode=2,
                sorted_vals=self._int_sorted,
                sorted_ids=self._int_sorted_ids,
            )
        if pack is not None:
            kwargs.update(pack)
        return tokenize_batch(
            self._buf, spans[:, 0], spans[:, 1], walk, **kwargs
        )

    def name_hash(self):
        """Native open-addressing hash over the S-line name spans (string-
        named graphs: tokenize_batch mode 3). Built once, None when the
        native lib is unavailable."""
        # lock: the async edge-index worker and the main-thread tokenizer
        # can both trigger the first build concurrently
        with self._name_hash_lock:
            if self._name_hash_cache is False:
                from .native import build_name_hash

                ns, ne = self._name_spans
                self._name_hash_cache = build_name_hash(
                    self._buf, ns, ne
                )
        return self._name_hash_cache

    def batch_tokenizable(self) -> bool:
        """True when all_path_item_runs can run natively (int names, or
        string names with the native name hash)."""
        if self._int_name_mode is not None:
            from .native import get_lib

            return get_lib() is not None
        return self.name_hash() is not None

    def path_item_run(self, path_idx: int) -> Tuple[np.ndarray, np.ndarray]:
        """Item ids + orientations (0 fwd / 1 bwd) of one P/W line, vectorized.

        Equivalent of reference parse_path_seq_to_item_vec /
        parse_walk_seq_to_item_vec (src/graph_broker/util.rs:797-1016).
        """
        a, b = self._pw_seq_spans[path_idx]
        buf = self._buf
        if self._int_name_mode is not None:
            from .native import parse_path_tokens

            res = parse_path_tokens(
                buf, a, b, walk=bool(self._pw_is_walk[path_idx])
            )
            if res is not None:
                vals, orient = res
                ids = self._ids_from_int_names(
                    vals, f"path {self.path_segments[path_idx]}"
                )
                return ids, orient
        if self._pw_is_walk[path_idx]:
            seg = buf[a:b]
            seps = np.flatnonzero((seg == 62) | (seg == 60))  # '>' '<'
            if len(seps) == 0:
                return np.zeros(0, np.int64), np.zeros(0, np.uint8)
            tok_starts = seps + 1 + a
            tok_ends = np.empty(len(seps), dtype=np.int64)
            tok_ends[:-1] = seps[1:] + a
            tok_ends[-1] = b
            orient = (seg[seps] == 60).astype(np.uint8)
        else:
            seg = buf[a:b]
            commas = np.flatnonzero(seg == 44)
            n_tok = len(commas) + 1
            tok_starts = np.empty(n_tok, dtype=np.int64)
            tok_starts[0] = a
            tok_starts[1:] = commas + 1 + a
            tok_full_ends = np.empty(n_tok, dtype=np.int64)
            tok_full_ends[:-1] = commas + a
            tok_full_ends[-1] = b
            # last char of each token is orientation (+/-)
            ochars = buf[tok_full_ends - 1]
            bad = (ochars != 43) & (ochars != 45)
            if bad.any():
                raise ValueError(
                    "unknown orientation of segment in path "
                    f"{self.path_segments[path_idx]}"
                )
            orient = (ochars == 45).astype(np.uint8)
            tok_ends = tok_full_ends - 1
        if self._int_name_mode is not None:
            vals = _parse_ints_from_spans(buf, tok_starts, tok_ends)
            if vals is None:
                raise ValueError(
                    f"malformed node id in path {self.path_segments[path_idx]}"
                )
            ids = self._ids_from_int_names(
                vals, f"path {self.path_segments[path_idx]}"
            )
        else:
            d = self._node2id
            data = self._data
            ids = np.fromiter(
                (
                    d[bytes(data[int(s) : int(e)])]
                    for s, e in zip(tok_starts, tok_ends)
                ),
                dtype=np.int64,
                count=len(tok_starts),
            )
        return ids, orient

    # -- edges ----------------------------------------------------------------

    def _index_edges(self, l_starts: np.ndarray, l_ends: np.ndarray) -> None:
        """Canonical edge table from L lines
        (reference: src/graph_broker/graph.rs:276-306, Edge::canonical
        graph.rs:142-148). Edge ids are assigned in first-occurrence order."""
        buf = self._buf
        n = len(l_starts)
        if n == 0:
            self._edge_count = 0
            self._degree = np.zeros(self.node_count + 1, dtype=np.uint32)
            self._edge_keys_sorted = np.zeros(0, dtype=np.uint64)
            self._edge_ids_sorted = np.zeros(0, dtype=np.int64)
            self._edges_u = np.zeros(0, np.int64)
            self._edges_o1 = np.zeros(0, np.uint8)
            self._edges_v = np.zeros(0, np.int64)
            self._edges_o2 = np.zeros(0, np.uint8)
            return
        res = None
        if self._int_name_mode is not None:
            from .native import index_edges

            res = index_edges(
                buf,
                l_starts,
                l_ends,
                1 if self._int_name_mode == "identity" else 2,
                self.node_count,
                getattr(self, "_int_sorted", None),
                getattr(self, "_int_sorted_ids", None),
            )
        else:
            nh = self.name_hash()
            if nh is not None:
                from .native import index_edges

                res = index_edges(
                    buf,
                    l_starts,
                    l_ends,
                    3,
                    self.node_count,
                    None,
                    None,
                    name_hash=nh,
                )
        if res is not None:
            (
                self._edge_hash,
                self._edges_u,
                self._edges_o1,
                self._edges_v,
                self._edges_o2,
                self._degree,
                n_dup,
            ) = res
            self._edge_count = len(self._edges_u)
            if n_dup:
                log.warning("%d duplicated edges in GFA", n_dup)
            log.info("found: %d edges", self._edge_count)
            return
        tabs = self._tabs  # numpy fallback: materializes the lazy index
        ti = np.searchsorted(tabs, l_starts)
        t1 = tabs[ti]
        t2 = tabs[ti + 1]
        t3 = tabs[ti + 2]
        t4 = tabs[ti + 3]
        t5i = ti + 4
        t5 = np.where(
            (t5i < len(tabs)) & (np.take(tabs, np.minimum(t5i, len(tabs) - 1)) < l_ends),
            np.take(tabs, np.minimum(t5i, len(tabs) - 1)),
            l_ends,
        )
        u_names = (t1 + 1, t2)
        v_names = (t3 + 1, t4)
        o1 = (buf[t2 + 1] == 45).astype(np.uint8)
        o2 = (buf[t4 + 1] == 45).astype(np.uint8)

        if self._int_name_mode is not None:
            uv = _parse_ints_from_spans(buf, u_names[0], u_names[1])
            vv = _parse_ints_from_spans(buf, v_names[0], v_names[1])
            if uv is None or vv is None:
                raise ValueError("malformed L line node name")
            u = self._ids_from_int_names(uv, "L line")
            v = self._ids_from_int_names(vv, "L line")
        else:
            d = self._node2id
            data = self._data
            u = np.fromiter(
                (d[bytes(data[int(s) : int(e)])] for s, e in zip(u_names[0], u_names[1])),
                dtype=np.int64,
                count=n,
            )
            v = np.fromiter(
                (d[bytes(data[int(s) : int(e)])] for s, e in zip(v_names[0], v_names[1])),
                dtype=np.int64,
                count=n,
            )

        cu, co1, cv, co2 = canonical_edges(u, o1, v, o2)
        keys = edge_keys(cu, co1, cv, co2)
        uniq, first_idx = np.unique(keys, return_index=True)
        n_dup = n - len(uniq)
        if n_dup:
            log.warning("%d duplicated edges in GFA", n_dup)
        order = np.argsort(first_idx, kind="stable")
        ids_sorted = np.empty(len(uniq), dtype=np.int64)
        ids_sorted[order] = np.arange(1, len(uniq) + 1)
        self._edge_keys_sorted = uniq
        self._edge_ids_sorted = ids_sorted
        self._edge_count = len(uniq)
        # per unique edge endpoints, in id order
        inv_order = first_idx[order]
        self._edges_u = cu[inv_order]
        self._edges_o1 = co1[inv_order]
        self._edges_v = cv[inv_order]
        self._edges_o2 = co2[inv_order]
        self._degree = (
            np.bincount(self._edges_u, minlength=self.node_count + 1)
            + np.bincount(self._edges_v, minlength=self.node_count + 1)
        ).astype(np.uint32)
        log.info("found: %d edges", self._edge_count)

    def edge_ids_for_pairs(
        self,
        u: np.ndarray,
        o1: np.ndarray,
        v: np.ndarray,
        o2: np.ndarray,
    ) -> np.ndarray:
        """Canonical edge id lookup for oriented node pairs (vectorized)."""
        self._ensure_edges()
        if self._edge_hash is not None:
            from .native import lookup_pairs

            res = lookup_pairs(u, o1, v, o2, self._edge_hash)
            if res is not None:
                return res
        if self._edge_keys_sorted is None:
            raise ValueError("edge index unavailable")
        cu, co1, cv, co2 = canonical_edges(u, o1, v, o2)
        keys = edge_keys(cu, co1, cv, co2)
        if len(self._edge_keys_sorted) == 0:
            bad = np.ones(len(keys), dtype=bool)
            idx_c = np.zeros(len(keys), dtype=np.int64)
        else:
            idx = np.searchsorted(self._edge_keys_sorted, keys)
            idx_c = np.minimum(idx, len(self._edge_keys_sorted) - 1)
            bad = self._edge_keys_sorted[idx_c] != keys
        if np.any(bad):
            i = int(np.flatnonzero(bad)[0])
            raise ValueError(
                f"unknown edge {'<' if co1[i] else '>'}{cu[i]}"
                f"{'<' if co2[i] else '>'}{cv[i]}"
            )
        return self._edge_ids_sorted[idx_c]

    def node_names_fixed(self, ids: np.ndarray) -> np.ndarray:
        """Fixed-width byte names for a batch of node ids (NUL-padded) —
        vectorized gather from the file buffer for the table exporter."""
        ids = np.asarray(ids, dtype=np.int64)
        if self._int_name_mode == "identity":
            return ids.astype("S20")
        ns, ne = self._name_spans
        starts = ns[ids - 1]
        ends = ne[ids - 1]
        w = int((ends - starts).max()) if len(ids) else 1
        pos = starts[:, None] + np.arange(w, dtype=np.int64)
        g = self._buf[np.minimum(pos, len(self._buf) - 1)]
        out = np.where(pos < ends[:, None], g, 0).astype(np.uint8)
        return np.ascontiguousarray(out)

    def edge_names_fixed(self, eids: np.ndarray) -> np.ndarray:
        """Fixed-width byte names '<u><v' style for a batch of edge ids.
        Name blocks are NUL-padded internally; consumers treat NUL as
        padding anywhere in the cell (native format_table does)."""
        i = np.asarray(eids, dtype=np.int64) - 1
        u = self.edges_u[i]
        v = self.edges_v[i]
        o1 = np.where(self.edges_o1[i], ord("<"), ord(">")).astype(np.uint8)
        o2 = np.where(self.edges_o2[i], ord("<"), ord(">")).astype(np.uint8)
        un = self.node_names_fixed(u)
        vn = self.node_names_fixed(v)
        un = un.view(np.uint8).reshape(len(i), -1)
        vn = vn.view(np.uint8).reshape(len(i), -1)
        wu, wv = un.shape[1], vn.shape[1]
        out = np.zeros((len(i), 2 + wu + wv), dtype=np.uint8)
        out[:, 0] = o1
        out[:, 1 : 1 + wu] = un
        out[:, 1 + wu] = o2
        out[:, 2 + wu :] = vn
        return out

    def edge_name(self, eid: int) -> str:
        i = eid - 1
        o1 = "<" if self.edges_o1[i] else ">"
        o2 = "<" if self.edges_o2[i] else ">"
        return (
            f"{o1}{self.node_name(int(self.edges_u[i]))}"
            f"{o2}{self.node_name(int(self.edges_v[i]))}"
        )


def canonical_edges(
    u: np.ndarray, o1: np.ndarray, v: np.ndarray, o2: np.ndarray
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Vectorized Edge::canonical (reference: src/graph_broker/graph.rs:142-148):
    flip when u > v, or u == v and o1 is backward."""
    flip = (u > v) | ((u == v) & (o1 == BACKWARD))
    cu = np.where(flip, v, u)
    co1 = np.where(flip, o2 ^ 1, o1).astype(np.uint8)
    cv = np.where(flip, u, v)
    co2 = np.where(flip, o1 ^ 1, o2).astype(np.uint8)
    return cu, co1, cv, co2


def edge_keys(
    u: np.ndarray, o1: np.ndarray, v: np.ndarray, o2: np.ndarray
) -> np.ndarray:
    return (
        (u.astype(np.uint64) << np.uint64(33))
        | (v.astype(np.uint64) << np.uint64(2))
        | (o1.astype(np.uint64) << np.uint64(1))
        | o2.astype(np.uint64)
    )
