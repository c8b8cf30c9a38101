"""Overlapped gzip ingest: structural indexing chases the inflate frontier.

Single-member gzip (the common case for .gfa.gz) cannot be inflated in
parallel, and libdeflate — faster than zlib streaming — only does
whole-buffer decompression with no progress callback. That serializes the
two halves of the gz "index" stage: inflate, then the newline scan / line
classify / S-line indexing / path tokenization that only need the
*already written* prefix of the output buffer.

This module runs those follow-up passes **concurrently with the inflate**
on a second core, using a sentinel frontier:

- 0xFF sentinels (a byte that cannot appear in ASCII GFA text) are
  planted ONLY at the probe-stride positions the follower galloping
  check reads — ~80 byte writes instead of a full-buffer memset; a
  legit 0xFF at a stride point merely stalls the follower until inflate
  completes — correctness never depends on the content,
- libdeflate appends output strictly in order, so on x86-TSO observing a
  non-0xFF byte at position q proves positions < q - slop are final, where
  slop bounds libdeflate's wide-store overshoot (tens of bytes). The
  follower stays a 64 KiB margin behind the observed frontier — three
  orders of magnitude above the slop,
- the follower incrementally: scans newlines (native SWAR, 1 thread),
  classifies lines, parses S-line name/sequence spans + integer names, and
  batch-tokenizes P/W payload spans into a per-path CSR cache that
  GraphStorage.all_path_item_runs later serves without re-reading the
  buffer.

Every failure path (buffer growth, malformed lines, S lines after the
first P/W line, non-integer names for the tokenize cache, a mid-buffer
0xFF) degrades to "follower result unavailable" and the classic
post-inflate indexing runs — the overlap is a pure latency optimization,
never a correctness dependency.

Reference counterpart: the reference streams the gz through MultiGzDecoder
into its line parser single-threaded (src/io.rs:23-33); there is nothing
to overlap there because parsing is interleaved with (slow) inflate. Here
inflate runs at full libdeflate speed while indexing rides the spare core.
"""

from __future__ import annotations

import ctypes
import logging
import os
import threading
import time
from typing import List, Optional, Tuple

import numpy as np

log = logging.getLogger("panacus")

_MARGIN = 1 << 16  # stay this far behind the observed frontier
_STRIDE = 4 << 20  # frontier gallop step
_CHUNK_MIN = 2 << 20  # don't bother scanning slivers while inflate runs
_TOK_BATCH = 32 << 20  # tokenize P/W payload in batches of this many bytes


class GzFollowResult:
    """What the follower managed to precompute. Field validity:

    - lines_ok: starts/ends/first cover the whole buffer (classified,
      CR-stripped, empty lines dropped — bit-identical to GraphStorage's
      own classify pass).
    - s_ok: s_name_ends/s_seq_lens (+ int-name products) cover all S
      lines and no S line appeared after the first P/W line.
    - pretok_*: per-P/W-line token CSR batches (only when s_ok and names
      were integer); spans recorded so the consumer can verify them
      against its own span parse before trusting a cache entry.
    """

    def __init__(self):
        self.lines_ok = False
        self.starts: Optional[np.ndarray] = None
        self.ends: Optional[np.ndarray] = None
        self.first: Optional[np.ndarray] = None

        self.s_ok = False
        self.s_name_ends: Optional[np.ndarray] = None
        self.s_seq_lens: Optional[np.ndarray] = None
        # int-name products (None when names are not all integers)
        self.s_ints: Optional[np.ndarray] = None
        self.int_mode: Optional[str] = None  # "identity" | "sorted" | None
        self.int_sorted: Optional[np.ndarray] = None
        self.int_sorted_ids: Optional[np.ndarray] = None

        # tokenize cache: batches of (pw_idx int64[], span int64[k,2],
        # walk bool[], ids, orient, prefsum, bp); pw_idx is the 0-based
        # index among P/W lines in file order
        self.pretok_batches: List[tuple] = []


class _Follower:
    def __init__(self, out_ba: bytearray, cap: int, state: dict,
                 done: threading.Event):
        self.out_ba = out_ba
        self.cap = cap
        self.state = state  # {'final_len': int|None, 'abort': bool}
        self.done = done
        self.result: Optional[GzFollowResult] = None
        self._nt = 1  # widened to full thread width once inflate is done

        # accumulators
        self._starts: List[np.ndarray] = []
        self._ends: List[np.ndarray] = []
        self._first: List[np.ndarray] = []
        self._carry = 0  # start of the first unterminated line

        self._s_done = False
        self._s_dirty = False  # S line seen after first P/W
        self._ints_ok = True
        self._s_name_ends: List[np.ndarray] = []
        self._s_seq_lens: List[np.ndarray] = []
        self._s_ints: List[np.ndarray] = []
        self._n_s = 0

        self._node_count = 0
        self._node_lens: Optional[np.ndarray] = None
        self._mode: Optional[int] = None  # tokenize_batch mode (1/2)
        self._int_mode: Optional[str] = None
        self._sorted_vals = None
        self._sorted_ids = None

        self._pw_count = 0
        self._pend_spans: List[Tuple[int, int, bool, int]] = []
        self._pend_bytes = 0
        self._pretok_failed = False
        self._batches: List[tuple] = []
        self._tok_total = 0   # running token count (for cap estimation)
        self._tok_bytes = 0   # payload bytes those tokens came from

    # -- driver ---------------------------------------------------------------

    def run(self):
        try:
            self._run()
        except Exception:
            log.debug("gz follower failed; classic indexing will run",
                      exc_info=True)
            self.result = None

    def _run(self):
        from .native import scan_lines

        buf = np.frombuffer(self.out_ba, dtype=np.uint8)
        pos = 0
        probe = 0
        while True:
            if self.state["abort"]:
                self.result = None
                return
            final = self.state["final_len"] if self.done.is_set() else None
            if final is not None:
                # inflate finished: the main thread is only waiting on the
                # join now, so process the tail at full thread width
                if self._nt == 1:
                    from .runtime import effective_threads

                    self._nt = effective_threads()
                lim = final
            else:
                probe = self._gallop(buf, probe)
                lim = probe - _MARGIN
            if lim - pos < (_CHUNK_MIN if final is None else 1):
                if final is not None:
                    break
                time.sleep(0.002)
                continue
            nl_res = scan_lines(buf[pos:lim], self._nt, want_tabs=False)
            if nl_res is None:  # no native lib: nothing to overlap
                self.result = None
                return
            nl = nl_res[0]
            if len(nl):
                nl += pos
                self._consume_lines(buf, nl)
            pos = lim
            if final is not None and pos >= final:
                break
        if self.state["abort"]:
            self.result = None
            return
        self._finish(buf)

    def _gallop(self, buf: np.ndarray, probe: int) -> int:
        # advance while the byte one stride ahead is already written.
        # buf is being written concurrently: single-byte reads, and only
        # the region `probe - _MARGIN` and below is ever parsed.
        while probe + _STRIDE < self.cap and buf[probe + _STRIDE] != 0xFF:
            probe += _STRIDE
        return probe

    # -- per-chunk work -------------------------------------------------------

    def _consume_lines(self, buf: np.ndarray, nl: np.ndarray) -> None:
        from .native import classify_lines

        cls = classify_lines(buf, nl, prev_end=self._carry)
        if cls is not None:
            starts, ends, first = cls
        else:
            starts = np.empty(len(nl), dtype=np.int64)
            starts[0] = self._carry
            starts[1:] = nl[:-1] + 1
            ends = nl - (buf[np.maximum(nl - 1, 0)] == 13)
            nonempty = ends > starts
            starts, ends = starts[nonempty], ends[nonempty]
            first = buf[starts]
        self._carry = int(nl[-1]) + 1
        self._starts.append(starts)
        self._ends.append(ends)
        self._first.append(first)

        is_s = first == ord("S")
        if is_s.any():
            if self._s_done:
                self._s_dirty = True
            else:
                self._consume_s(buf, starts[is_s], ends[is_s])
        pw = (first == ord("P")) | (first == ord("W"))
        if pw.any():
            self._consume_pw(starts[pw], ends[pw], first[pw])

    def _consume_s(self, buf, s_starts, s_ends) -> None:
        from .native import s_spans

        res = s_spans(
            buf, s_starts, s_ends, self._nt, want_ints=self._ints_ok
        )
        if res is None:
            raise RuntimeError("native s_spans unavailable")
        name_ends, seq_lens = res[0], res[1]
        self._s_name_ends.append(name_ends)
        self._s_seq_lens.append(seq_lens)
        if self._ints_ok:
            ints = res[2]  # fused decimal-name parse (same cache-hot pass)
            if ints is None:
                self._ints_ok = False
                self._s_ints = []
            else:
                self._s_ints.append(ints)
        self._n_s += len(s_starts)

    def _finalize_s(self) -> None:
        self._s_done = True
        n = self._n_s
        self._node_count = n
        seq_lens = (
            np.concatenate(self._s_seq_lens)
            if self._s_seq_lens
            else np.zeros(0, dtype=np.int64)
        )
        self._node_lens = np.zeros(n + 1, dtype=np.uint32)
        self._node_lens[1:] = seq_lens
        if not self._ints_ok:
            return  # string names: no tokenize cache (scan products still count)
        ints = (
            np.concatenate(self._s_ints)
            if self._s_ints
            else np.zeros(0, dtype=np.int64)
        )
        self._all_ints = ints
        if n and bool((ints == np.arange(1, n + 1)).all()):
            self._mode = 1
            self._int_mode = "identity"
        else:
            order = np.argsort(ints, kind="stable")
            sorted_ints = ints[order]
            if len(sorted_ints) != len(np.unique(sorted_ints)):
                # duplicate names: let GraphStorage raise the user error
                self._pretok_failed = True
                self._int_mode = None
                return
            self._sorted_vals = sorted_ints
            self._sorted_ids = order.astype(np.int64) + 1
            self._mode = 2
            self._int_mode = "sorted"

    def _consume_pw(self, starts, ends, first) -> None:
        if not self._s_done:
            self._finalize_s()
        ba = self.out_ba
        for k in range(len(starts)):
            s, e = int(starts[k]), int(ends[k])
            idx = self._pw_count
            self._pw_count += 1
            if self._pretok_failed or self._mode is None:
                continue
            span = _pw_payload_span(ba, s, e, first[k] == ord("W"))
            if span is None:  # short/odd line: leave this one uncached
                continue
            a, b = span
            self._pend_spans.append((a, b, first[k] == ord("W"), idx))
            self._pend_bytes += b - a
        if self._pend_bytes >= _TOK_BATCH:
            self._flush_tokenize()

    def _flush_tokenize(self) -> None:
        if not self._pend_spans or self._pretok_failed:
            self._pend_spans = []
            self._pend_bytes = 0
            return
        from .native import tokenize_batch, tokenize_serial

        buf = np.frombuffer(self.out_ba, dtype=np.uint8)
        sp = np.asarray(
            [(a, b) for a, b, _, _ in self._pend_spans], dtype=np.int64
        )
        walk = np.asarray(
            [w for _, _, w, _ in self._pend_spans], dtype=bool
        )
        pw_idx = np.asarray(
            [i for _, _, _, i in self._pend_spans], dtype=np.int64
        )
        kwargs = dict(
            mode=self._mode,
            n_items=self._node_count,
            node_lens=self._node_lens,
        )
        if self._mode == 2:
            kwargs.update(
                sorted_vals=self._sorted_vals, sorted_ids=self._sorted_ids
            )
        res = None
        if self._nt == 1:
            # during inflate: single-pass serial parse (reads the payload
            # once; the two-phase path reads it twice to count first).
            # cap from the running token density (1.25x headroom) keeps
            # the transient allocation near the real size
            # first flush guesses 1 token per 6 payload bytes (real GFA
            # runs ~9; a too-small cap just falls back to the two-phase
            # path) — the worst-case bound (len/2) would allocate ~4x the
            # need, and large fresh allocations intermittently hit this
            # VM's slow-fault pathology
            dens = (
                self._tok_total / self._tok_bytes
                if self._tok_bytes
                else 1.0 / 6.0
            )
            hint = int(self._pend_bytes * dens * 1.25) + 1024
            res = tokenize_serial(
                buf, sp[:, 0], sp[:, 1], walk, cap_hint=hint, **kwargs
            )
        if res is None:
            res = tokenize_batch(
                buf, sp[:, 0], sp[:, 1], walk, n_threads=self._nt, **kwargs
            )
        if res is None:
            self._pretok_failed = True
        else:
            ids, orient, prefsum, bp = res
            self._tok_total += int(prefsum[-1])
            self._tok_bytes += self._pend_bytes
            self._batches.append((pw_idx, sp, walk, ids, orient, prefsum, bp))
        self._pend_spans = []
        self._pend_bytes = 0

    # -- final assembly -------------------------------------------------------

    def _finish(self, buf: np.ndarray) -> None:
        if not self._s_done:
            self._finalize_s()
        self._flush_tokenize()
        r = GzFollowResult()
        final = self.state["final_len"]
        # an unterminated trailing line is handled by GraphStorage (it
        # appends a '\n'); the follower only claims complete-line coverage
        if self._carry < final:
            self.result = None
            return
        r.starts = (
            np.concatenate(self._starts)
            if self._starts
            else np.zeros(0, dtype=np.int64)
        )
        r.ends = (
            np.concatenate(self._ends)
            if self._ends
            else np.zeros(0, dtype=np.int64)
        )
        r.first = (
            np.concatenate(self._first)
            if self._first
            else np.zeros(0, dtype=np.uint8)
        )
        r.lines_ok = True
        if not self._s_dirty:
            r.s_ok = True
            r.s_name_ends = (
                np.concatenate(self._s_name_ends)
                if self._s_name_ends
                else np.zeros(0, dtype=np.int64)
            )
            r.s_seq_lens = (
                np.concatenate(self._s_seq_lens)
                if self._s_seq_lens
                else np.zeros(0, dtype=np.int64)
            )
            if self._ints_ok:
                r.s_ints = getattr(self, "_all_ints", None)
                r.int_mode = self._int_mode
                r.int_sorted = self._sorted_vals
                r.int_sorted_ids = self._sorted_ids
            if not self._pretok_failed:
                r.pretok_batches = self._batches
        self.result = r


def _pw_payload_span(data, s: int, e: int, is_walk: bool):
    """Payload byte span of one P/W line — must agree with
    GraphStorage._index_paths (consumers verify cached spans against the
    authoritative parse before use, so a mismatch only disables the cache).
    Returns None on a line too short to carry a payload."""
    if is_walk:
        pos = s
        for _ in range(6):
            t = data.find(b"\t", pos + 1, e)
            if t < 0:
                t = e
            pos = t
        return (pos + 1, e) if pos < e else None
    t1 = data.find(b"\t", s, e)
    if t1 < 0:
        return None
    t2 = data.find(b"\t", t1 + 1, e)
    if t2 < 0:
        return None
    t3 = data.find(b"\t", t2 + 1, e)
    if t3 < 0:
        t3 = e
    return (t2 + 1, t3)


def read_gz_overlapped(gfa_file: str):
    """Inflate `gfa_file` with the follower pipeline. Returns
    (buffer, GzFollowResult | None). Falls back to the plain streamed read
    (follower disabled) when libdeflate or the native scanner is missing,
    or when the overlap is disabled via PANACUS_NO_GZ_OVERLAP=1."""
    import platform

    from . import gfa as _gfa
    from .native import _get_libdeflate, get_lib, gzip_decompress_buffer
    from .runtime import effective_threads

    if (
        os.environ.get("PANACUS_NO_GZ_OVERLAP") == "1"
        or effective_threads() < 2  # -t 1: a follower would oversubscribe
        # the sentinel-frontier safety argument is x86-TSO store ordering
        # (see module docstring); on weakly-ordered CPUs the follower
        # could parse stale bytes behind an already-visible stride point
        or platform.machine() not in ("x86_64", "AMD64", "i686")
        or get_lib() is None
        or _get_libdeflate() is None
    ):
        return _gfa._read_gz_streamed(gfa_file), None

    cap = _gfa._gz_capacity_hint(gfa_file)

    try:
        raw_map = np.memmap(gfa_file, dtype=np.uint8, mode="r")
    except (OSError, ValueError):
        return _gfa._read_gz_streamed(gfa_file), None

    out = bytearray(cap)
    # Sentinel prefill: the follower only ever *probes* at _STRIDE
    # multiples (see _gallop), so only those bytes need the 0xFF
    # unwritten-marker — a few byte writes instead of a full-buffer memset
    # and its page-touch pass over the whole output. Bytes
    # between stride points are never probed, only parsed once the
    # frontier proves them final.
    for q in range(_STRIDE, cap, _STRIDE):
        out[q] = 0xFF
    state = {"final_len": None, "abort": False}
    done = threading.Event()
    fol = _Follower(out, cap, state, done)
    th = threading.Thread(target=fol.run, name="gz-follower", daemon=True)
    th.start()

    def on_grow():
        # destination is being reallocated: the follower's views are stale
        state["abort"] = True

    try:
        res = gzip_decompress_buffer(
            raw_map, cap, out=out, on_grow=on_grow, return_len=True
        )
    except Exception:
        state["abort"] = True
        res = None
    finally:
        if res is None:
            state["abort"] = True
        else:
            state["final_len"] = res[1]
        done.set()
        th.join()

    if res is None:
        # malformed for libdeflate: the zlib path raises the user-facing error
        return _gfa._read_gz_streamed(gfa_file), None
    buf, n = res
    del buf[n:]  # follower has released its views by now
    return buf, (None if state["abort"] else fol.result)
