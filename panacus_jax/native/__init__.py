"""Native host accelerators (C, via ctypes).

Compiled on demand from gfa_scan.c into a cached shared library; every
entry point has a numpy fallback so the framework works without a C
toolchain.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import platform
import subprocess
import sys
from typing import Optional, Tuple

import numpy as np

log = logging.getLogger("panacus")

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "gfa_scan.c")
_LIB = None
_TRIED = False


def _build_lib() -> Optional[ctypes.CDLL]:
    try:
        with open(_SRC, "rb") as f:
            src = f.read()
    except OSError:
        return None
    # key the cache by CPU identity too: -march=native artifacts must never
    # be served to a different microarchitecture (shared ~/.cache, container
    # images) — a stale .so would SIGILL instead of falling back
    cpu_id = platform.machine()
    try:
        with open("/proc/cpuinfo", "rb") as f:
            for line in f:
                if line.startswith((b"flags", b"Features")):
                    cpu_id += hashlib.sha256(line).hexdigest()[:8]
                    break
    except OSError:
        pass
    tag = hashlib.sha256(
        src + b"|march-native-v1|" + cpu_id.encode()
    ).hexdigest()[:16]
    cache_dir = os.path.join(
        os.environ.get("XDG_CACHE_HOME", os.path.expanduser("~/.cache")),
        "panacus_jax",
        "native",
    )
    so_path = os.path.join(cache_dir, f"gfa_scan-{tag}.so")
    if not os.path.exists(so_path):
        os.makedirs(cache_dir, exist_ok=True)
        cc = os.environ.get("CC", "cc")
        base = [
            cc,
            "-O3",
            "-shared",
            "-fPIC",
            "-pthread",
            "-fvisibility=hidden",
            _SRC,
            "-o",
            so_path + ".tmp",
        ]
        # compiled on demand on the machine that runs it, so -march=native
        # is safe; retry portable if the toolchain rejects it
        built = False
        for extra in (["-march=native"], []):
            try:
                subprocess.run(
                    base[:1] + extra + base[1:],
                    check=True,
                    capture_output=True,
                    timeout=120,
                )
                os.replace(so_path + ".tmp", so_path)
                built = True
                break
            except Exception as e:
                log.debug("native build attempt failed (%s)", e)
        if not built:
            log.debug("native build failed; using numpy fallback")
            return None
    try:
        lib = ctypes.CDLL(so_path)
    except OSError as e:
        log.debug("native load failed (%s); using numpy fallback", e)
        return None
    i64 = ctypes.c_int64
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i64p = ctypes.POINTER(ctypes.c_int64)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    lib.pt_parse_path_pm.restype = i64
    lib.pt_parse_path_pm.argtypes = [u8p, i64, i64p, u8p]
    lib.pt_parse_walk_lg.restype = i64
    lib.pt_parse_walk_lg.argtypes = [u8p, i64, i64p, u8p]
    lib.pt_parse_int_spans.restype = i64
    lib.pt_parse_int_spans.argtypes = [u8p, i64p, i64p, i64, i64p]
    u64p = ctypes.POINTER(ctypes.c_uint64)
    lib.pt_tokenize_batch.restype = i64
    lib.pt_interval_walk.restype = i64
    lib.pt_interval_walk.argtypes = [
        i64p, u8p, i64,   # ids, orient, n_ids
        u32p,             # node_lens
        i64p, i64,        # inc, n_inc
        i64p, i64,        # exc, n_exc
        i64,              # offset
        u8p,              # cov_present (nullable)
        i64p, i64,        # pushed, cap
        i64p, i64, i64p,  # cov_ev, cap, n_out
        i64p, i64, i64p,  # exc_ev, cap, n_out
        i64p,             # included_bp
        i64, i64p,        # pos_base, last_full (nullable)
    ]
    lib.pt_scan_count.restype = None
    lib.pt_scan_count.argtypes = [u8p, i64, i64, i64p, ctypes.c_int32]
    lib.pt_scan_fill.restype = None
    lib.pt_scan_fill.argtypes = [
        u8p, i64, i64, i64p, i64p, i64p, i64p, ctypes.c_int32,
    ]
    lib.pt_classify_lines.restype = i64
    lib.pt_classify_lines.argtypes = [u8p, i64p, i64, i64, i64p, i64p, u8p]
    lib.pt_s_spans.restype = i64
    lib.pt_s_spans.argtypes = [
        u8p, i64p, i64p, i64, i64p, i64p, ctypes.c_int32,
    ]
    lib.pt_s_spans_ints.restype = i64
    lib.pt_s_spans_ints.argtypes = [
        u8p, i64p, i64p, i64, i64p, i64p, i64p,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
    ]
    lib.pt_count_tokens.restype = i64
    lib.pt_count_tokens.argtypes = [
        u8p, i64p, i64p, u8p, i64, i64p, i64p, ctypes.c_int32,
    ]
    lib.pt_tokenize_serial.restype = i64
    lib.pt_tokenize_serial.argtypes = [
        u8p, i64p, i64p, u8p, i64, i64p,
        i64p, u8p, i64,
        ctypes.c_int32, i64,
        i64p, i64p, i64,
        u32p, u64p,
        i64p, ctypes.c_int32, i64p, i64p,
    ]
    lib.pt_lookup_edges.restype = i64
    lib.pt_lookup_edges.argtypes = [
        i64p, u8p,       # ids, orient
        i64p, i64,       # prefsum, n_paths
        u64p, ctypes.c_int32,  # slots (interleaved), log2_slots
        i64p, i64p,      # out_eids, out_pref
        ctypes.c_int32,  # n_threads
    ]
    lib.pt_build_edge_hash.restype = None
    lib.pt_build_edge_hash.argtypes = [
        u64p, i64p, i64,  # keys, eids, n
        u64p, ctypes.c_int32,  # slots (interleaved), log2_slots
    ]
    lib.pt_build_edge_adj.restype = None
    lib.pt_build_edge_adj.argtypes = [
        i64p, u8p, i64p, u8p, i64,  # edges_u, o1, v, o2, n_edges
        i64,                        # n_items
        i64p, u64p,                 # row_off, adj_ent
    ]
    lib.pt_lookup_edges_adj.restype = i64
    lib.pt_lookup_edges_adj.argtypes = [
        i64p, u8p,        # ids, orient
        i64p, i64,        # prefsum, n_paths
        i64p, u64p,       # row_off, adj_ent
        i64p, i64p,       # out_eids, out_pref
        ctypes.c_int32,   # n_threads
    ]
    lib.pt_pack_edges_adj.restype = i64
    lib.pt_pack_edges_adj.argtypes = [
        i64p, u8p,        # ids, orient
        i64p, i64,        # prefsum, n_paths
        i64p,             # gbit (per path)
        i64p, u64p,       # row_off, adj_ent
        u32p, i64,        # edge_row, row_len
        ctypes.c_int32,   # n_threads
    ]
    lib.pt_index_edges.restype = i64
    lib.pt_index_edges.argtypes = [
        u8p,             # buf
        i64p, i64p, i64,  # starts, ends, n_lines
        ctypes.c_int32, i64,  # mode, n_items
        i64p, i64p, i64,  # sorted_vals, sorted_ids, n_sorted
        u64p, ctypes.c_int32,  # slots (interleaved), log2_slots
        i64p, u8p, i64p, u8p,  # edges_u, o1, v, o2
        u32p,            # degree
        i64p, ctypes.c_int32,  # name_slots, name_log2 (mode 3)
        i64p, i64p,      # name_starts, name_ends
    ]
    lib.pt_build_membership.restype = i64
    lib.pt_build_membership.argtypes = [
        i64p, i64p,       # items, prefsum
        i64p, i64p, i64,  # path_ids, group_idx, n_entries
        u32p, i64, i64,   # M, n_words, n_items_pad
        ctypes.c_int32,   # n_threads
    ]
    lib.pt_lookup_pairs.restype = i64
    lib.pt_lookup_pairs.argtypes = [
        i64p, u8p, i64p, u8p, i64,  # u, o1, v, o2, n
        u64p, ctypes.c_int32,  # slots (interleaved), log2_slots
        i64p,            # out_eids
    ]
    lib.pt_tokenize_batch.argtypes = [
        u8p,            # buf
        i64p, i64p, u8p,  # starts, ends, walk
        i64,            # n_spans
        i64p, i64p,     # prefsum, counts
        i64p, u8p, i64,  # out_ids, out_orient, cap_ids
        ctypes.c_int32, i64,  # mode, n_items
        i64p, i64p, i64,  # sorted_vals, sorted_ids, n_sorted
        u32p, u64p,     # node_lens, bp_out
        i64p, ctypes.c_int32,  # name_slots, name_log2
        i64p, i64p,     # name_starts, name_ends
        ctypes.c_int32,  # n_threads
    ]
    lib.pt_build_name_hash.restype = i64
    lib.pt_build_name_hash.argtypes = [
        u8p, i64p, i64p, i64,  # buf, starts, ends, n
        i64p, ctypes.c_int32,  # slots, log2_slots
    ]
    lib.pt_tokenize_pack.restype = i64
    lib.pt_tokenize_pack.argtypes = (
        lib.pt_tokenize_batch.argtypes[:-1]  # everything up to n_threads
        + [
            i64p,        # gbit
            u32p, i64,   # node_row, node_len
            i64p, u64p,  # row_off, adj_ent
            u32p, i64,   # edge_row, edge_len
            ctypes.c_int32,  # n_threads
        ]
    )
    return lib


_NPALLOC = None
_NPALLOC_TRIED = False


def install_hugepage_allocator() -> bool:
    """Build (cached) + install the hugepage-backed numpy data allocator
    (native/npalloc.c, PyDataMem_SetHandler). Returns True when active."""
    global _NPALLOC, _NPALLOC_TRIED
    if _NPALLOC_TRIED:
        return _NPALLOC is not None
    _NPALLOC_TRIED = True
    if os.environ.get("PANACUS_NO_HUGEPAGES") == "1":
        return False
    src = os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "npalloc.c"
    )
    try:
        with open(src, "rb") as f:
            tag = hashlib.sha256(f.read()).hexdigest()[:16]
    except OSError:
        return False
    cache_dir = os.path.join(
        os.environ.get("XDG_CACHE_HOME", os.path.expanduser("~/.cache")),
        "panacus_jax",
        "native",
    )
    so_path = os.path.join(cache_dir, f"panacus_npalloc-{tag}.so")
    if not os.path.exists(so_path):
        os.makedirs(cache_dir, exist_ok=True)
        import sysconfig

        try:
            import numpy as _np

            np_inc = _np.get_include()
        except Exception:
            return False
        cc = os.environ.get("CC", "cc")
        cmd = [
            cc,
            "-O2",
            "-shared",
            "-fPIC",
            "-pthread",
            f"-I{sysconfig.get_paths()['include']}",
            f"-I{np_inc}",
            src,
            "-o",
            so_path + ".tmp",
        ]
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=120)
            os.replace(so_path + ".tmp", so_path)
        except Exception as e:
            log.debug("npalloc build failed (%s)", e)
            return False
    try:
        from importlib.machinery import ExtensionFileLoader
        from importlib.util import module_from_spec, spec_from_loader

        loader = ExtensionFileLoader("panacus_npalloc", so_path)
        spec = spec_from_loader("panacus_npalloc", loader)
        mod = module_from_spec(spec)
        loader.exec_module(mod)
        mod.install()
        _NPALLOC = mod
        log.debug("hugepage numpy allocator installed")
        return True
    except Exception as e:
        log.debug("npalloc load failed (%s)", e)
        return False


def install_thread_allocator() -> None:
    """Install the hugepage numpy allocator in the CURRENT thread.

    numpy's PyDataMem_SetHandler is context-local (a contextvar since
    numpy 1.22): worker threads start from a fresh context and fall back
    to the default malloc-based allocator, whose non-main glibc arenas
    return freed pages to the OS — on a ballooned VM every repeat pass
    then re-faults its large arrays. Call this at
    the top of any thread that allocates large numpy arrays."""
    if _NPALLOC is not None:
        try:
            _NPALLOC.install()
        except Exception:  # pragma: no cover
            pass


def get_lib() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if not _TRIED:
        _TRIED = True
        if os.environ.get("PANACUS_NO_NATIVE") != "1":
            _LIB = _build_lib()
            if _LIB is not None:
                log.debug("native gfa_scan loaded")
    return _LIB


def _as_u8p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


# -- libdeflate gzip inflate ---------------------------------------------------

_DEFLATE = None
_DEFLATE_TRIED = False


def _get_libdeflate():
    """System libdeflate, whose whole-buffer inflate runs faster than
    zlib's streaming inflate. Optional: gzip ingest falls back to the zlib
    stream."""
    global _DEFLATE, _DEFLATE_TRIED
    if _DEFLATE_TRIED:
        return _DEFLATE
    _DEFLATE_TRIED = True
    if os.environ.get("PANACUS_NO_LIBDEFLATE") == "1":
        return None
    for name in ("libdeflate.so.0", "libdeflate.so", "libdeflate.dylib"):
        try:
            lib = ctypes.CDLL(name)
            lib.libdeflate_alloc_decompressor.restype = ctypes.c_void_p
            lib.libdeflate_free_decompressor.restype = None
            lib.libdeflate_free_decompressor.argtypes = [ctypes.c_void_p]
            lib.libdeflate_gzip_decompress_ex.restype = ctypes.c_int
            lib.libdeflate_gzip_decompress_ex.argtypes = [
                ctypes.c_void_p,
                ctypes.c_void_p,
                ctypes.c_size_t,
                ctypes.c_void_p,
                ctypes.c_size_t,
                ctypes.POINTER(ctypes.c_size_t),
                ctypes.POINTER(ctypes.c_size_t),
            ]
            _DEFLATE = lib
            log.debug("libdeflate loaded (%s)", name)
            return _DEFLATE
        except OSError:
            continue
    return None


def gzip_decompress_buffer(
    raw: np.ndarray,
    size_hint: int,
    out: Optional[bytearray] = None,
    on_grow=None,
    return_len: bool = False,
):
    """Inflate a (possibly multi-member) gzip byte buffer with libdeflate
    into one bytearray. Returns None when libdeflate is unavailable or the
    stream is malformed (caller falls back to the zlib path, which raises
    the user-facing error).

    `out`: caller-provided destination bytearray (its existing contents may
    be anything — e.g. the gz overlap pipeline's 0xFF sentinel prefill); a
    fresh zeroed buffer is allocated when omitted. `on_grow` is called
    (no args) right before the destination is reallocated on
    INSUFFICIENT_SPACE — concurrent readers of `out` must treat their views
    as stale from that point. With `return_len` the buffer is NOT trimmed
    (so exported memoryviews stay legal) and the return value is
    (buffer, decompressed_len) instead of the trimmed buffer."""
    lib = _get_libdeflate()
    if lib is None or len(raw) < 18:
        return None
    d = lib.libdeflate_alloc_decompressor()
    if not d:
        return None
    try:
        cap = max(int(size_hint), 1 << 20)
        if out is None:
            out = bytearray(cap)
        in_off = 0
        out_off = 0
        n_in = len(raw)
        raw_p = raw.ctypes.data_as(ctypes.c_void_p).value
        while in_off < n_in:
            # gzip member magic; MultiGzDecoder-style: stop at padding
            if raw[in_off] != 0x1F:
                if not raw[in_off:].any():
                    break  # zero padding after the last member
                return None
            ain = ctypes.c_size_t(0)
            aout = ctypes.c_size_t(0)
            while True:
                view = (ctypes.c_char * (len(out) - out_off)).from_buffer(
                    out, out_off
                )
                rc = lib.libdeflate_gzip_decompress_ex(
                    d,
                    ctypes.c_void_p(raw_p + in_off),
                    n_in - in_off,
                    ctypes.addressof(view),
                    len(out) - out_off,
                    ctypes.byref(ain),
                    ctypes.byref(aout),
                )
                del view
                if rc == 3:  # INSUFFICIENT_SPACE: grow 1.5x and retry
                    if on_grow is not None:
                        on_grow()
                    grown = bytearray(len(out) + len(out) // 2 + (1 << 20))
                    grown[:out_off] = memoryview(out)[:out_off]
                    out = grown
                    continue
                break
            if rc != 0:
                return None
            in_off += ain.value
            out_off += aout.value
        if return_len:
            return out, out_off
        del out[out_off:]
        return out
    finally:
        lib.libdeflate_free_decompressor(ctypes.c_void_p(d))


def parse_int_spans(buf, starts, ends):
    """C batch parse of integers at [starts[i], ends[i]). Returns int64
    array or None (unavailable / non-integer content)."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(starts)
    out = np.empty(n, dtype=np.int64)
    if n == 0:
        return out
    s = np.ascontiguousarray(starts, dtype=np.int64)
    e = np.ascontiguousarray(ends, dtype=np.int64)
    rc = lib.pt_parse_int_spans(
        _as_u8p(buf),
        s.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        e.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int64(n),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    if rc != 0:
        return None
    return out


_NULL_I64 = None
_NULL_U32 = None
_NULL_U64 = None


def tokenize_batch(
    buf: np.ndarray,
    starts: np.ndarray,
    ends: np.ndarray,
    walk: np.ndarray,
    mode: int,
    n_items: int,
    sorted_vals: Optional[np.ndarray] = None,
    sorted_ids: Optional[np.ndarray] = None,
    node_lens: Optional[np.ndarray] = None,
    name_hash: Optional[Tuple[np.ndarray, int, np.ndarray, np.ndarray]] = None,
    pack_gbit: Optional[np.ndarray] = None,
    pack_node_row: Optional[np.ndarray] = None,
    pack_edge_adj=None,
    pack_edge_row: Optional[np.ndarray] = None,
    n_threads: int = 0,
):
    """Tokenize all path/walk spans in one threaded C call.

    Modes: 1 = identity int names, 2 = sorted-int lookup, 3 = string names
    via `name_hash` = (slots, log2_slots, name_starts, name_ends) from
    build_name_hash (spans into the same buf).

    Fused membership pack: when `pack_gbit` (group bit per span) is given,
    each span's freshly parsed ids are ORed — cache-hot — into
    `pack_node_row` (uint32 row) and/or `pack_edge_row` (via the
    `pack_edge_adj` CSR adjacency), eliminating the separate pack passes'
    full re-read of the token array.

    Returns (ids int64[N], orient uint8[N], prefsum int64[n+1],
    bp uint64[n] or None) or None when the native lib is unavailable or any
    span is malformed / contains an unknown name (caller falls back).

    CONTRACT: on a None return with `pack_gbit` set, the contents of
    `pack_node_row` / `pack_edge_row` are UNDEFINED — worker threads may
    have already ORed earlier spans into them before the error was hit.
    Callers must discard (or re-zero) the pack targets and rebuild via the
    fallback path; they must not merge partially-packed rows."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(starts)
    i64p = ctypes.POINTER(ctypes.c_int64)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    s = np.ascontiguousarray(starts, dtype=np.int64)
    e = np.ascontiguousarray(ends, dtype=np.int64)
    w = np.ascontiguousarray(walk, dtype=np.uint8)
    prefsum = np.zeros(n + 1, dtype=np.int64)
    counts = np.zeros(max(n, 1), dtype=np.int64)
    if n_threads <= 0:
        n_threads = os.cpu_count() or 1
    i64p_ = ctypes.POINTER(ctypes.c_int64)
    cap = int(
        lib.pt_count_tokens(
            _as_u8p(buf),
            s.ctypes.data_as(i64p_),
            e.ctypes.data_as(i64p_),
            _as_u8p(w),
            ctypes.c_int64(n),
            prefsum.ctypes.data_as(i64p_),
            counts.ctypes.data_as(i64p_),
            ctypes.c_int32(n_threads),
        )
    )
    ids = np.empty(cap, dtype=np.int64)
    orient = np.empty(cap, dtype=np.uint8)
    bp = np.zeros(max(n, 1), dtype=np.uint64) if node_lens is not None else None
    sv = (
        sorted_vals.ctypes.data_as(i64p)
        if sorted_vals is not None
        else ctypes.cast(None, i64p)
    )
    si = (
        sorted_ids.ctypes.data_as(i64p)
        if sorted_ids is not None
        else ctypes.cast(None, i64p)
    )
    nl = (
        np.ascontiguousarray(node_lens, dtype=np.uint32).ctypes.data_as(u32p)
        if node_lens is not None
        else ctypes.cast(None, u32p)
    )
    if name_hash is not None:
        nh_slots, nh_log2, nh_starts, nh_ends = name_hash
        nhs = nh_slots.ctypes.data_as(i64p)
        nst = nh_starts.ctypes.data_as(i64p)
        nen = nh_ends.ctypes.data_as(i64p)
    else:
        nh_log2 = 0
        nhs = nst = nen = ctypes.cast(None, i64p)
    common = (
        _as_u8p(buf),
        s.ctypes.data_as(i64p),
        e.ctypes.data_as(i64p),
        _as_u8p(w),
        ctypes.c_int64(n),
        prefsum.ctypes.data_as(i64p),
        counts.ctypes.data_as(i64p),
        ids.ctypes.data_as(i64p),
        _as_u8p(orient),
        ctypes.c_int64(cap),
        ctypes.c_int32(mode),
        ctypes.c_int64(n_items),
        sv,
        si,
        ctypes.c_int64(len(sorted_vals) if sorted_vals is not None else 0),
        nl,
        bp.ctypes.data_as(u64p) if bp is not None else ctypes.cast(None, u64p),
        nhs,
        ctypes.c_int32(nh_log2),
        nst,
        nen,
    )
    if pack_gbit is not None:
        gb = np.ascontiguousarray(pack_gbit, dtype=np.int64)
        if pack_edge_row is not None:
            row_off, adj_ent = pack_edge_adj
            ro = row_off.ctypes.data_as(i64p)
            ae = adj_ent.ctypes.data_as(u64p)
            er = pack_edge_row.ctypes.data_as(u32p)
            el = len(pack_edge_row)
        else:
            ro = ctypes.cast(None, i64p)
            ae = ctypes.cast(None, u64p)
            er = ctypes.cast(None, u32p)
            el = 0
        rc = lib.pt_tokenize_pack(
            *common,
            gb.ctypes.data_as(i64p),
            pack_node_row.ctypes.data_as(u32p)
            if pack_node_row is not None
            else ctypes.cast(None, u32p),
            ctypes.c_int64(
                len(pack_node_row) if pack_node_row is not None else 0
            ),
            ro,
            ae,
            er,
            ctypes.c_int64(el),
            ctypes.c_int32(n_threads),
        )
    else:
        rc = lib.pt_tokenize_batch(*common, ctypes.c_int32(n_threads))
    if rc < 0:
        return None
    return ids[:rc], orient[:rc], prefsum, bp


def tokenize_serial(
    buf: np.ndarray,
    starts: np.ndarray,
    ends: np.ndarray,
    walk: np.ndarray,
    mode: int,
    n_items: int,
    sorted_vals: Optional[np.ndarray] = None,
    sorted_ids: Optional[np.ndarray] = None,
    node_lens: Optional[np.ndarray] = None,
    name_hash: Optional[Tuple[np.ndarray, int, np.ndarray, np.ndarray]] = None,
    cap_hint: Optional[int] = None,
):
    """Single-pass serial tokenize: no counting pre-pass (the payload is
    read once, not twice), prefsum filled on the fly. The gz follower's
    during-inflate hot path — one core is all it has, so halving its byte
    reads matters more than thread fan-out. Output arrays are allocated
    at the worst-case bound (len/2+2 tokens per span) and returned as
    views trimmed to the real count (shrink-copied when the slack is
    large). Returns (ids, orient, prefsum, bp or None) or None
    (unavailable / malformed / over-capacity — caller uses
    tokenize_batch)."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(starts)
    i64p = ctypes.POINTER(ctypes.c_int64)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    s = np.ascontiguousarray(starts, dtype=np.int64)
    e = np.ascontiguousarray(ends, dtype=np.int64)
    w = np.ascontiguousarray(walk, dtype=np.uint8)
    prefsum = np.zeros(n + 1, dtype=np.int64)
    # worst case is one token per 2 payload bytes; callers who know the
    # running token density pass a tighter cap_hint (a miss is safe: the C
    # side bails per-span and we return None for the two-phase fallback)
    cap = int((e - s).sum() // 2) + 2 * n + 16
    if cap_hint is not None:
        cap = min(cap, max(int(cap_hint), 2 * n + 16))
    ids = np.empty(cap, dtype=np.int64)
    orient = np.empty(cap, dtype=np.uint8)
    bp = np.zeros(max(n, 1), dtype=np.uint64) if node_lens is not None else None
    sv = (
        sorted_vals.ctypes.data_as(i64p)
        if sorted_vals is not None
        else ctypes.cast(None, i64p)
    )
    si = (
        sorted_ids.ctypes.data_as(i64p)
        if sorted_ids is not None
        else ctypes.cast(None, i64p)
    )
    nl = (
        np.ascontiguousarray(node_lens, dtype=np.uint32).ctypes.data_as(u32p)
        if node_lens is not None
        else ctypes.cast(None, u32p)
    )
    if name_hash is not None:
        nh_slots, nh_log2, nh_starts, nh_ends = name_hash
        nhs = nh_slots.ctypes.data_as(i64p)
        nst = nh_starts.ctypes.data_as(i64p)
        nen = nh_ends.ctypes.data_as(i64p)
    else:
        nh_log2 = 0
        nhs = nst = nen = ctypes.cast(None, i64p)
    rc = lib.pt_tokenize_serial(
        _as_u8p(buf),
        s.ctypes.data_as(i64p),
        e.ctypes.data_as(i64p),
        _as_u8p(w),
        ctypes.c_int64(n),
        prefsum.ctypes.data_as(i64p),
        ids.ctypes.data_as(i64p),
        _as_u8p(orient),
        ctypes.c_int64(cap),
        ctypes.c_int32(mode),
        ctypes.c_int64(n_items),
        sv,
        si,
        ctypes.c_int64(len(sorted_vals) if sorted_vals is not None else 0),
        nl,
        bp.ctypes.data_as(u64p) if bp is not None else ctypes.cast(None, u64p),
        nhs,
        ctypes.c_int32(nh_log2),
        nst,
        nen,
    )
    if rc < 0:
        return None
    if cap > rc + rc // 4 + 1024:
        # large slack: copy down so the retained arrays don't pin ~2x
        # the real footprint for the graph's lifetime
        return ids[:rc].copy(), orient[:rc].copy(), prefsum, bp
    return ids[:rc], orient[:rc], prefsum, bp


def build_name_hash(
    buf: np.ndarray, name_starts: np.ndarray, name_ends: np.ndarray
):
    """Open-addressing hash over S-line name byte spans (load <= 0.5):
    slots int64[S] holding 1-based node ids, 0 = empty. Returns
    (slots, log2_slots, starts, ends) ready for tokenize_batch mode 3, or
    None (native unavailable / duplicate name)."""
    lib = get_lib()
    if lib is None:
        return None
    i64p = ctypes.POINTER(ctypes.c_int64)
    n = len(name_starts)
    log2_slots = max(int(2 * n - 1).bit_length() if n else 4, 4)
    slots = np.zeros(1 << log2_slots, dtype=np.int64)
    s = np.ascontiguousarray(name_starts, dtype=np.int64)
    e = np.ascontiguousarray(name_ends, dtype=np.int64)
    rc = lib.pt_build_name_hash(
        _as_u8p(buf),
        s.ctypes.data_as(i64p),
        e.ctypes.data_as(i64p),
        ctypes.c_int64(n),
        slots.ctypes.data_as(i64p),
        ctypes.c_int32(log2_slots),
    )
    if rc != 0:
        return None
    return slots, log2_slots, s, e


def interval_walk(
    ids: np.ndarray,
    orient: np.ndarray,
    node_lens: np.ndarray,
    include_coords,
    exclude_coords,
    offset: int,
    cov_present: Optional[np.ndarray],
    pos_base: int = 0,
    last_full: Optional[np.ndarray] = None,
):
    """C port of the masked per-path interval walk. Returns
    (pushed int64[], cov_events int64[n,5] (sid, a, b, kind, pos),
    exc_events int64[m,3], included_bp) or None when the native lib is
    unavailable (caller runs the Python walker). pos_base/last_full: see
    pt_interval_walk — global visit positions for the multi-host covered
    merge."""
    lib = get_lib()
    if lib is None:
        return None
    i64p = ctypes.POINTER(ctypes.c_int64)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    n = len(ids)
    inc = np.asarray(include_coords, dtype=np.int64).reshape(-1, 2)
    exc = np.asarray(exclude_coords, dtype=np.int64).reshape(-1, 2)
    cap_p = n + len(inc) + 8
    cap_e = n + len(exc) + 8
    ids_c = np.ascontiguousarray(ids, dtype=np.int64)
    or_c = np.ascontiguousarray(orient, dtype=np.uint8)
    nl_c = np.ascontiguousarray(node_lens, dtype=np.uint32)
    pushed = np.empty(cap_p, dtype=np.int64)
    cov_ev = np.empty(5 * cap_p, dtype=np.int64)
    exc_ev = np.empty(3 * cap_e, dtype=np.int64)
    n_cov = ctypes.c_int64(0)
    n_exc = ctypes.c_int64(0)
    bp = ctypes.c_int64(0)
    rc = lib.pt_interval_walk(
        ids_c.ctypes.data_as(i64p),
        _as_u8p(or_c),
        ctypes.c_int64(n),
        nl_c.ctypes.data_as(u32p),
        inc.ctypes.data_as(i64p),
        ctypes.c_int64(len(inc)),
        exc.ctypes.data_as(i64p),
        ctypes.c_int64(len(exc)),
        ctypes.c_int64(offset),
        _as_u8p(cov_present) if cov_present is not None else ctypes.cast(
            None, ctypes.POINTER(ctypes.c_uint8)
        ),
        pushed.ctypes.data_as(i64p),
        ctypes.c_int64(cap_p),
        cov_ev.ctypes.data_as(i64p),
        ctypes.c_int64(cap_p),
        ctypes.byref(n_cov),
        exc_ev.ctypes.data_as(i64p),
        ctypes.c_int64(cap_e),
        ctypes.byref(n_exc),
        ctypes.byref(bp),
        ctypes.c_int64(pos_base),
        last_full.ctypes.data_as(i64p)
        if last_full is not None
        else ctypes.cast(None, i64p),
    )
    if rc < 0:
        return None
    return (
        pushed[:rc],
        cov_ev[: 5 * n_cov.value].reshape(-1, 5),
        exc_ev[: 3 * n_exc.value].reshape(-1, 3),
        int(bp.value),
    )


def scan_lines(buf: np.ndarray, n_threads: int = 0, want_tabs: bool = True):
    """One threaded pass over the GFA buffer collecting newline (and,
    when want_tabs, tab) positions. Returns (nl int64[], tabs int64[] or
    None) or None (no native lib). want_tabs=False skips the global tab
    index — callers whose field parsers re-scan their own lines
    (pt_s_spans / pt_index_edges / pt_tokenize) never need it."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(buf)
    if n_threads <= 0:
        n_threads = os.cpu_count() or 1
    n_ranges = max(n_threads * 4, 1)
    i64p = ctypes.POINTER(ctypes.c_int64)
    counts = np.zeros(2 * n_ranges, dtype=np.int64)
    lib.pt_scan_count(
        _as_u8p(buf),
        ctypes.c_int64(n),
        ctypes.c_int64(n_ranges),
        counts.ctypes.data_as(i64p),
        ctypes.c_int32(n_threads),
    )
    nl_counts, tab_counts = counts[:n_ranges], counts[n_ranges:]
    nl_off = np.zeros(n_ranges, dtype=np.int64)
    np.cumsum(nl_counts[:-1], out=nl_off[1:])
    nl = np.empty(int(nl_counts.sum()), dtype=np.int64)
    if want_tabs:
        tab_off = np.zeros(n_ranges, dtype=np.int64)
        np.cumsum(tab_counts[:-1], out=tab_off[1:])
        tabs = np.empty(int(tab_counts.sum()), dtype=np.int64)
        lib.pt_scan_fill(
            _as_u8p(buf),
            ctypes.c_int64(n),
            ctypes.c_int64(n_ranges),
            nl_off.ctypes.data_as(i64p),
            tab_off.ctypes.data_as(i64p),
            nl.ctypes.data_as(i64p),
            tabs.ctypes.data_as(i64p),
            ctypes.c_int32(n_threads),
        )
        return nl, tabs
    lib.pt_scan_fill(
        _as_u8p(buf),
        ctypes.c_int64(n),
        ctypes.c_int64(n_ranges),
        nl_off.ctypes.data_as(i64p),
        None,
        nl.ctypes.data_as(i64p),
        None,
        ctypes.c_int32(n_threads),
    )
    return nl, None


def classify_lines(
    buf: np.ndarray, nl: np.ndarray, prev_end: int = 0
):
    """Non-empty line spans + first bytes from a newline index in one C
    pass (CR-stripped; replaces four full-width numpy temporaries).
    Returns (starts int64[k], ends int64[k], first uint8[k]) or None when
    the native lib is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    i64p = ctypes.POINTER(ctypes.c_int64)
    n = len(nl)
    nl_c = np.ascontiguousarray(nl, dtype=np.int64)
    starts = np.empty(n, dtype=np.int64)
    ends = np.empty(n, dtype=np.int64)
    first = np.empty(max(n, 1), dtype=np.uint8)
    k = lib.pt_classify_lines(
        _as_u8p(buf),
        nl_c.ctypes.data_as(i64p),
        ctypes.c_int64(n),
        ctypes.c_int64(prev_end),
        starts.ctypes.data_as(i64p),
        ends.ctypes.data_as(i64p),
        _as_u8p(first),
    )
    return starts[:k], ends[:k], first[:k]


def s_spans(
    buf: np.ndarray,
    starts: np.ndarray,
    ends: np.ndarray,
    n_threads: int = 0,
    want_ints: bool = False,
):
    """Per-S-line (name_end, seq_len) without the global tab index.
    Returns (name_ends int64[], seq_lens int64[]) or None (no native
    lib); raises ValueError on a malformed S line. With want_ints a third
    element is returned: the decimal value of every name (parsed in the
    same cache-hot pass), or None when any name is not a 1-18 digit
    integer — same contract as gfa._parse_ints_from_spans."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(starts)
    i64p = ctypes.POINTER(ctypes.c_int64)
    s = np.ascontiguousarray(starts, dtype=np.int64)
    e = np.ascontiguousarray(ends, dtype=np.int64)
    name_ends = np.empty(n, dtype=np.int64)
    seq_lens = np.empty(n, dtype=np.int64)
    ints = np.empty(n, dtype=np.int64) if want_ints else None
    ints_ok = ctypes.c_int32(1)
    if n:
        if n_threads <= 0:
            n_threads = os.cpu_count() or 1
        if want_ints:
            rc = lib.pt_s_spans_ints(
                _as_u8p(buf),
                s.ctypes.data_as(i64p),
                e.ctypes.data_as(i64p),
                ctypes.c_int64(n),
                name_ends.ctypes.data_as(i64p),
                seq_lens.ctypes.data_as(i64p),
                ints.ctypes.data_as(i64p),
                ctypes.byref(ints_ok),
                ctypes.c_int32(n_threads),
            )
        else:
            rc = lib.pt_s_spans(
                _as_u8p(buf),
                s.ctypes.data_as(i64p),
                e.ctypes.data_as(i64p),
                ctypes.c_int64(n),
                name_ends.ctypes.data_as(i64p),
                seq_lens.ctypes.data_as(i64p),
                ctypes.c_int32(n_threads),
            )
        if rc != 0:
            # rc encodes the 0-based index within the S-record subset (with
            # multiple threads: the first *chunk* to fail, not necessarily
            # the lowest index)
            raise ValueError(
                f"malformed S record #{-rc - 1} in GFA (0-based among S "
                "lines; may not be the first bad record when threaded)"
            )
    if want_ints:
        return name_ends, seq_lens, (ints if ints_ok.value else None)
    return name_ends, seq_lens


def build_edge_hash(keys: np.ndarray, eids: np.ndarray):
    """Open-addressing hash table over canonical edge keys (load <= 0.5),
    interleaved (key, eid) uint64 pairs so a probe hit costs one cache
    line. Returns (slots uint64[2*S], log2_slots) or None (native
    unavailable). Valid keys are >= 4, so slot key 0 == empty."""
    lib = get_lib()
    if lib is None:
        return None
    i64p = ctypes.POINTER(ctypes.c_int64)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    n = len(keys)
    log2_slots = max(int(2 * n - 1).bit_length(), 4)
    n_slots = 1 << log2_slots
    slots = np.zeros(2 * n_slots, dtype=np.uint64)
    ks_c = np.ascontiguousarray(keys, dtype=np.uint64)
    es_c = np.ascontiguousarray(eids, dtype=np.int64)
    lib.pt_build_edge_hash(
        ks_c.ctypes.data_as(u64p),
        es_c.ctypes.data_as(i64p),
        ctypes.c_int64(n),
        slots.ctypes.data_as(u64p),
        ctypes.c_int32(log2_slots),
    )
    return slots, log2_slots


def index_edges(
    buf: np.ndarray,
    starts: np.ndarray,
    ends: np.ndarray,
    mode: int,
    n_items: int,
    sorted_vals: Optional[np.ndarray],
    sorted_ids: Optional[np.ndarray],
    name_hash=None,
):
    """One-pass L-line edge indexer: parse + canonicalize + hash-dedupe with
    first-occurrence edge ids. mode 3 resolves string names through
    `name_hash` (build_name_hash). Returns (edge_hash, edges_u, edges_o1,
    edges_v, edges_o2, degree, n_dup) or None (native unavailable); raises
    ValueError on a malformed line / unknown node."""
    lib = get_lib()
    if lib is None:
        return None
    i64p = ctypes.POINTER(ctypes.c_int64)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    n = len(starts)
    log2_slots = max(int(2 * n - 1).bit_length(), 4)
    n_slots = 1 << log2_slots
    slots = np.zeros(2 * n_slots, dtype=np.uint64)
    edges_u = np.empty(n, dtype=np.int64)
    edges_o1 = np.empty(n, dtype=np.uint8)
    edges_v = np.empty(n, dtype=np.int64)
    edges_o2 = np.empty(n, dtype=np.uint8)
    degree = np.zeros(n_items + 1, dtype=np.uint32)
    st_c = np.ascontiguousarray(starts, dtype=np.int64)
    en_c = np.ascontiguousarray(ends, dtype=np.int64)
    if sorted_vals is None:
        sv_c = np.zeros(0, dtype=np.int64)
        si_c = np.zeros(0, dtype=np.int64)
    else:
        sv_c = np.ascontiguousarray(sorted_vals, dtype=np.int64)
        si_c = np.ascontiguousarray(sorted_ids, dtype=np.int64)
    rc = lib.pt_index_edges(
        _as_u8p(buf),
        st_c.ctypes.data_as(i64p),
        en_c.ctypes.data_as(i64p),
        ctypes.c_int64(n),
        ctypes.c_int32(mode),
        ctypes.c_int64(n_items),
        sv_c.ctypes.data_as(i64p),
        si_c.ctypes.data_as(i64p),
        ctypes.c_int64(len(sv_c)),
        slots.ctypes.data_as(u64p),
        ctypes.c_int32(log2_slots),
        edges_u.ctypes.data_as(i64p),
        _as_u8p(edges_o1),
        edges_v.ctypes.data_as(i64p),
        _as_u8p(edges_o2),
        degree.ctypes.data_as(u32p),
        *(
            (
                name_hash[0].ctypes.data_as(i64p),
                ctypes.c_int32(name_hash[1]),
                name_hash[2].ctypes.data_as(i64p),
                name_hash[3].ctypes.data_as(i64p),
            )
            if name_hash is not None
            else (
                ctypes.cast(None, i64p),
                ctypes.c_int32(0),
                ctypes.cast(None, i64p),
                ctypes.cast(None, i64p),
            )
        ),
    )
    if rc < 0:
        raise ValueError(f"malformed L line or unknown node (line {-rc - 1})")
    n_unique = int(rc)
    return (
        (slots, log2_slots),
        edges_u[:n_unique],
        edges_o1[:n_unique],
        edges_v[:n_unique],
        edges_o2[:n_unique],
        degree,
        n - n_unique,
    )


def build_membership(
    items: np.ndarray,
    prefsum: np.ndarray,
    path_ids: np.ndarray,
    group_idx: np.ndarray,
    M: np.ndarray,
    n_threads: int = 0,
) -> bool:
    """Threaded scatter-OR of (path, group) blocks into the zeroed packed
    membership matrix M[n_words, n_items_pad]. Returns False if the native
    path is unavailable (caller falls back to numpy)."""
    lib = get_lib()
    if lib is None:
        return False
    i64p = ctypes.POINTER(ctypes.c_int64)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    if n_threads <= 0:
        n_threads = os.cpu_count() or 1
    it_c = np.ascontiguousarray(items, dtype=np.int64)
    pf_c = np.ascontiguousarray(prefsum, dtype=np.int64)
    pi_c = np.ascontiguousarray(path_ids, dtype=np.int64)
    gi_c = np.ascontiguousarray(group_idx, dtype=np.int64)
    rc = lib.pt_build_membership(
        it_c.ctypes.data_as(i64p),
        pf_c.ctypes.data_as(i64p),
        pi_c.ctypes.data_as(i64p),
        gi_c.ctypes.data_as(i64p),
        ctypes.c_int64(len(pi_c)),
        M.ctypes.data_as(u32p),
        ctypes.c_int64(M.shape[0]),
        ctypes.c_int64(M.shape[1]),
        ctypes.c_int32(n_threads),
    )
    return rc == 0


def lookup_pairs(
    u: np.ndarray,
    o1: np.ndarray,
    v: np.ndarray,
    o2: np.ndarray,
    edge_hash,
):
    """Bulk canonical edge-id lookup for flat oriented pair arrays. Returns
    eids int64[n] or None (native unavailable); raises ValueError on an
    unknown pair."""
    lib = get_lib()
    if lib is None or edge_hash is None:
        return None
    slots, log2_slots = edge_hash
    i64p = ctypes.POINTER(ctypes.c_int64)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    n = len(u)
    out = np.empty(n, dtype=np.int64)
    u_c = np.ascontiguousarray(u, dtype=np.int64)
    o1_c = np.ascontiguousarray(o1, dtype=np.uint8)
    v_c = np.ascontiguousarray(v, dtype=np.int64)
    o2_c = np.ascontiguousarray(o2, dtype=np.uint8)
    rc = lib.pt_lookup_pairs(
        u_c.ctypes.data_as(i64p),
        _as_u8p(o1_c),
        v_c.ctypes.data_as(i64p),
        _as_u8p(o2_c),
        ctypes.c_int64(n),
        slots.ctypes.data_as(u64p),
        ctypes.c_int32(log2_slots),
        out.ctypes.data_as(i64p),
    )
    if rc < 0:
        i = -rc - 1
        # report the canonical orientation, same as the numpy fallback
        # (gfa.edge_ids_for_pairs)
        cu, cv = int(u_c[i]), int(v_c[i])
        co1, co2 = int(o1_c[i]), int(o2_c[i])
        if cu > cv or (cu == cv and co1):
            cu, cv = cv, cu
            co1, co2 = co2 ^ 1, co1 ^ 1
        raise ValueError(
            f"unknown edge {'<' if co1 else '>'}{cu}"
            f"{'<' if co2 else '>'}{cv}"
        )
    return out


def lookup_edges(
    ids: np.ndarray,
    orient: np.ndarray,
    prefsum: np.ndarray,
    edge_hash,
    n_threads: int = 0,
):
    """Canonical edge-id lookup for every consecutive pair of every path,
    threaded, one hash probe per pair, no temporaries. edge_hash is the
    build_edge_hash triple. Returns (eids int64[E], e_pref int64[n+1]) or
    None (native unavailable); raises ValueError on an unknown edge."""
    lib = get_lib()
    if lib is None or edge_hash is None:
        return None
    slots, log2_slots = edge_hash
    i64p = ctypes.POINTER(ctypes.c_int64)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    n_paths = len(prefsum) - 1
    counts = np.diff(prefsum)
    e_pref = np.zeros(n_paths + 1, dtype=np.int64)
    np.cumsum(np.maximum(counts, 1) - 1, out=e_pref[1:])
    out = np.empty(int(e_pref[-1]), dtype=np.int64)
    if n_threads <= 0:
        n_threads = os.cpu_count() or 1
    ids_c = np.ascontiguousarray(ids, dtype=np.int64)
    or_c = np.ascontiguousarray(orient, dtype=np.uint8)
    pf_c = np.ascontiguousarray(prefsum, dtype=np.int64)
    rc = lib.pt_lookup_edges(
        ids_c.ctypes.data_as(i64p),
        _as_u8p(or_c),
        pf_c.ctypes.data_as(i64p),
        ctypes.c_int64(n_paths),
        slots.ctypes.data_as(u64p),
        ctypes.c_int32(log2_slots),
        out.ctypes.data_as(i64p),
        e_pref.ctypes.data_as(i64p),
        ctypes.c_int32(n_threads),
    )
    if rc < 0:
        k = -rc - 1
        raise ValueError(
            f"unknown edge between segments {ids_c[k]} and {ids_c[k + 1]}"
        )
    return out, e_pref


def build_edge_adj(
    edges_u: np.ndarray,
    edges_o1: np.ndarray,
    edges_v: np.ndarray,
    edges_o2: np.ndarray,
    n_items: int,
):
    """CSR adjacency over the canonical source node: (row_off int64
    [n_items+2], adj_ent uint64[E] = (vkey << 32) | eid), rows sorted by
    packed dest key — one interleaved word per entry, so a row scan
    touches one cache line per 8 entries. The cache-friendly replacement
    for the open hash on large graphs (the probe stream of an ascending
    path becomes near-sequential). Returns None when native is
    unavailable or the packed layout doesn't fit (v >= 2^29 or
    n_edges >= 2^31 — the open hash handles those)."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(edges_u)
    if n >= (1 << 31) or n_items >= (1 << 29):
        return None
    i64p = ctypes.POINTER(ctypes.c_int64)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    row_off = np.zeros(n_items + 2, dtype=np.int64)
    adj_ent = np.empty(n, dtype=np.uint64)
    eu = np.ascontiguousarray(edges_u, dtype=np.int64)
    e1 = np.ascontiguousarray(edges_o1, dtype=np.uint8)
    ev = np.ascontiguousarray(edges_v, dtype=np.int64)
    e2 = np.ascontiguousarray(edges_o2, dtype=np.uint8)
    lib.pt_build_edge_adj(
        eu.ctypes.data_as(i64p),
        _as_u8p(e1),
        ev.ctypes.data_as(i64p),
        _as_u8p(e2),
        ctypes.c_int64(n),
        ctypes.c_int64(n_items),
        row_off.ctypes.data_as(i64p),
        adj_ent.ctypes.data_as(u64p),
    )
    return row_off, adj_ent


def lookup_edges_adj(
    ids: np.ndarray,
    orient: np.ndarray,
    prefsum: np.ndarray,
    edge_adj,
    n_threads: int = 0,
):
    """Canonical edge-id lookup via the CSR adjacency (build_edge_adj
    triple); same contract as lookup_edges."""
    lib = get_lib()
    if lib is None or edge_adj is None:
        return None
    row_off, adj_ent = edge_adj
    i64p = ctypes.POINTER(ctypes.c_int64)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    n_paths = len(prefsum) - 1
    counts = np.diff(prefsum)
    e_pref = np.zeros(n_paths + 1, dtype=np.int64)
    np.cumsum(np.maximum(counts, 1) - 1, out=e_pref[1:])
    out = np.empty(int(e_pref[-1]), dtype=np.int64)
    if n_threads <= 0:
        n_threads = os.cpu_count() or 1
    ids_c = np.ascontiguousarray(ids, dtype=np.int64)
    or_c = np.ascontiguousarray(orient, dtype=np.uint8)
    pf_c = np.ascontiguousarray(prefsum, dtype=np.int64)
    rc = lib.pt_lookup_edges_adj(
        ids_c.ctypes.data_as(i64p),
        _as_u8p(or_c),
        pf_c.ctypes.data_as(i64p),
        ctypes.c_int64(n_paths),
        row_off.ctypes.data_as(i64p),
        adj_ent.ctypes.data_as(u64p),
        out.ctypes.data_as(i64p),
        e_pref.ctypes.data_as(i64p),
        ctypes.c_int32(n_threads),
    )
    if rc < 0:
        k = -rc - 1
        raise ValueError(
            f"unknown edge between segments {ids_c[k]} and {ids_c[k + 1]}"
        )
    return out, e_pref


def pack_edges_adj(
    ids: np.ndarray,
    orient: np.ndarray,
    prefsum: np.ndarray,
    gbit: np.ndarray,
    edge_adj,
    edge_row: np.ndarray,
    n_threads: int = 0,
) -> bool:
    """Fused edge lookup + group-bit OR into edge_row (uint32
    [n_items_pad]): the -c all hot path never materializes the edge-id
    CSR. Returns False when native is unavailable; raises on unknown
    edges."""
    lib = get_lib()
    if lib is None or edge_adj is None:
        return False
    row_off, adj_ent = edge_adj
    i64p = ctypes.POINTER(ctypes.c_int64)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    n_paths = len(prefsum) - 1
    ids_c = np.ascontiguousarray(ids, dtype=np.int64)
    or_c = np.ascontiguousarray(orient, dtype=np.uint8)
    pf_c = np.ascontiguousarray(prefsum, dtype=np.int64)
    gb_c = np.ascontiguousarray(gbit, dtype=np.int64)
    rc = lib.pt_pack_edges_adj(
        ids_c.ctypes.data_as(i64p),
        _as_u8p(or_c),
        pf_c.ctypes.data_as(i64p),
        ctypes.c_int64(n_paths),
        gb_c.ctypes.data_as(i64p),
        row_off.ctypes.data_as(i64p),
        adj_ent.ctypes.data_as(u64p),
        edge_row.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        ctypes.c_int64(len(edge_row)),
        ctypes.c_int32(n_threads if n_threads > 0 else (os.cpu_count() or 1)),
    )
    if rc < 0:
        k = -rc - 1
        raise ValueError(
            f"unknown edge between segments {ids_c[k]} and {ids_c[k + 1]}"
        )
    return True


def parse_path_tokens(
    buf: np.ndarray, start: int, end: int, walk: bool
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Tokenize buf[start:end] as P-line ids ('12+,34-') or W-line walk
    ('>12<34'). Returns (ids int64, orient uint8) or None if the native lib
    is unavailable or the span isn't pure integers (caller falls back)."""
    lib = get_lib()
    if lib is None:
        return None
    n = end - start
    if n <= 0:
        return np.zeros(0, np.int64), np.zeros(0, np.uint8)
    cap = n // 2 + 2
    ids = np.empty(cap, dtype=np.int64)
    orient = np.empty(cap, dtype=np.uint8)
    seg = buf[start:end]
    if not seg.flags["C_CONTIGUOUS"]:
        seg = np.ascontiguousarray(seg)
    fn = lib.pt_parse_walk_lg if walk else lib.pt_parse_path_pm
    cnt = fn(
        _as_u8p(seg),
        ctypes.c_int64(n),
        ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        _as_u8p(orient),
    )
    if cnt < 0:
        return None
    return ids[:cnt], orient[:cnt]


def format_table(
    vals: np.ndarray, names: np.ndarray, n_threads: int = 0
) -> Optional[bytes]:
    """Format int64 matrix vals[n, g] as TSV rows "name\\tv0\\t...\\n".

    names: fixed-width bytes array ([n] of dtype S<w> or [n, w] uint8);
    NUL bytes anywhere in a name cell are padding and are skipped (composed
    names interleave NUL-padded blocks). Returns the formatted bytes, or
    None when the native lib is unavailable (caller falls back)."""
    lib = get_lib()
    if lib is None:
        return None
    vals = np.ascontiguousarray(vals, dtype=np.int64)
    n, g = vals.shape
    if n == 0:
        return b""
    if names.dtype.kind == "S":
        name_w = names.dtype.itemsize
        names_u8 = np.ascontiguousarray(names).view(np.uint8)
    else:
        names_u8 = np.ascontiguousarray(names, dtype=np.uint8)
        name_w = names_u8.shape[1] if names_u8.ndim > 1 else 1
    if n_threads <= 0:
        n_threads = os.cpu_count() or 1
    row_cap = name_w + g * 21 + 2
    out = np.empty(n * row_cap, dtype=np.uint8)
    row_lens = np.empty(n, dtype=np.int64)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.pt_format_table.restype = ctypes.c_int64
    total = lib.pt_format_table(
        vals.ctypes.data_as(i64p),
        ctypes.c_int64(n),
        ctypes.c_int64(g),
        _as_u8p(names_u8),
        ctypes.c_int64(name_w),
        _as_u8p(out),
        ctypes.c_int64(row_cap),
        row_lens.ctypes.data_as(i64p),
        ctypes.c_int32(n_threads),
    )
    if total < 0:
        return None
    return out[:total].tobytes()
