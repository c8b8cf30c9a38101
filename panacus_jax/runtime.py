"""JAX runtime configuration: persistent compilation cache + device info.

CLI invocations are short-lived processes; the persistent compilation cache
makes every run after the first skip XLA compilation entirely. The cache
lives where JAX_COMPILATION_CACHE_DIR says (JAX reads it itself), or else at
a fixed directory inside the checkout, `.jax_cache`.
"""

from __future__ import annotations

import logging
import os

log = logging.getLogger("panacus")

_CONFIGURED = False
_NUM_THREADS = 0  # 0 = all cores


def set_num_threads(n: int) -> None:
    """Host-side worker thread count (CLI -t; 0 = all cores). The
    analogue of the reference's rayon pool size (src/lib.rs:55-67): it bounds
    the tokenizer thread pool; device parallelism is unaffected."""
    global _NUM_THREADS
    _NUM_THREADS = max(int(n), 0)
    log.info("running panacus on %d host threads", effective_threads())


def effective_threads() -> int:
    if _NUM_THREADS > 0:
        return _NUM_THREADS
    return os.cpu_count() or 1


_HEAP_CONFIGURED = False


def configure_host_memory() -> None:
    """Two host-memory mitigations for hosts where fresh private-anon
    4 KiB page faults are expensive (ballooned/lazy-memory VMs):

    1. mallopt: keep freed large blocks in the process heap instead of
       returning them to the OS, so steady-state non-numpy temps reuse
       already-faulted pages.
    2. A custom numpy data allocator (native/npalloc.c via
       PyDataMem_SetHandler): large arrays come from 2 MiB-aligned mmap
       regions advised MADV_HUGEPAGE with a bounded reuse cache, so the
       one-shot CLI cold start faults hugepages, which heap reuse cannot
       help. (The brk heap is no alternative: madvised heap ranges still
       fault 4 KiB at a time; khugepaged only collapses them afterwards.)

    Disable the allocator with PANACUS_NO_HUGEPAGES=1."""
    global _HEAP_CONFIGURED
    if _HEAP_CONFIGURED:
        return
    _HEAP_CONFIGURED = True
    try:
        import ctypes
        import ctypes.util

        libc = ctypes.CDLL(ctypes.util.find_library("c") or "libc.so.6")
        M_TRIM_THRESHOLD = -1
        M_MMAP_THRESHOLD = -3
        M_MMAP_MAX = -4
        M_ARENA_MAX = -8
        libc.mallopt(M_MMAP_MAX, 0)
        libc.mallopt(M_MMAP_THRESHOLD, 1 << 30)
        libc.mallopt(M_TRIM_THRESHOLD, 1 << 30)
        # one arena: worker-thread frees land back on the main heap where
        # the next pass's allocations (any thread) can reuse the pages —
        # non-main arenas trim to the OS and re-fault on a ballooned VM
        libc.mallopt(M_ARENA_MAX, 1)
    except Exception as e:  # pragma: no cover
        log.debug("mallopt tuning unavailable: %s", e)
    try:
        from .native import install_hugepage_allocator

        install_hugepage_allocator()
    except Exception as e:  # pragma: no cover
        log.debug("hugepage allocator unavailable: %s", e)


CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache"
)


def compile_cache_dir() -> "str | None":
    """The directory this program sets for JAX's persistent compilation
    cache: None when JAX_COMPILATION_CACHE_DIR is set (JAX honours it and
    the program sets nothing), else the fixed in-checkout CACHE_DIR."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    return CACHE_DIR


def configure_jax() -> None:
    global _CONFIGURED
    if _CONFIGURED:
        return
    _CONFIGURED = True
    configure_host_memory()
    import jax

    cache_dir = compile_cache_dir()
    if cache_dir is not None:
        os.makedirs(cache_dir, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.1)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)


class phase_timer:
    """Wall-clock phase timing, logged at INFO — the counterpart of the
    reference's per-pass Instant timers (graph_broker/util.rs:45,194-199).
    Doubles as a JAX profiler trace annotation when PANACUS_PROFILE is set
    (visible in a trace that a caller started)."""

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        import time

        self._t0 = time.perf_counter()
        self._trace_dir = os.environ.get("PANACUS_PROFILE")
        if self._trace_dir:
            try:
                import jax.profiler

                self._ann = jax.profiler.TraceAnnotation(self.name)
                self._ann.__enter__()
            except Exception:
                self._ann = None
        return self

    def __exit__(self, *exc):
        import time

        if self._trace_dir and getattr(self, "_ann", None) is not None:
            self._ann.__exit__(*exc)
        log.info(
            "phase %s done; time elapsed: %.3fs",
            self.name,
            time.perf_counter() - self._t0,
        )
        return False
