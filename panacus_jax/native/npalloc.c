/* Hugepage-backed numpy allocator (PyDataMem_SetHandler).
 *
 * Large numpy buffers (>= 1 MiB) come from 2 MiB-aligned anonymous mmap
 * regions advised MADV_HUGEPAGE, with a bounded free-list cache so repeat
 * passes reuse already-faulted memory instead of returning it to the OS.
 *
 * Why: on ballooned/lazy-memory VMs a fresh 4 KiB anon page fault is
 * expensive. Hugepage faults on fresh mmap VMAs are far cheaper per byte,
 * and cached reuse is memory-speed. The glibc brk heap cannot deliver either: madvised heap
 * ranges still fault 4 KiB-at-a-time (khugepaged collapses only later).
 * On regular hosts the same allocator cuts TLB pressure for the
 * byte-streaming GFA parse (the reference's hot loop equivalent,
 * src/graph_broker/util.rs:963-1016).
 *
 * Small allocations fall through to malloc/free. A pointer registry
 * (open-addressing hash) distinguishes our mmap blocks in free/realloc.
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#define NPY_NO_DEPRECATED_API NPY_1_22_API_VERSION
#define NPY_TARGET_VERSION NPY_1_22_API_VERSION
#include <numpy/arrayobject.h>

#include <dlfcn.h>
#include <pthread.h>
#include <stdint.h>
#include <string.h>
#include <sys/mman.h>

#define HUGE_SZ (2UL * 1024 * 1024)
#define MIN_MMAP (1UL * 1024 * 1024)
#define CACHE_MAX_BYTES (6UL * 1024 * 1024 * 1024)
#define CACHE_SLOTS 256
#define REG_SLOTS 4096 /* power of two */

#ifndef MADV_HUGEPAGE
#define MADV_HUGEPAGE 14
#endif

typedef struct {
    void* ptr;
    size_t size; /* rounded to HUGE_SZ */
} slot_t;

static slot_t cache[CACHE_SLOTS];
static int cache_n = 0;
static size_t cache_bytes = 0;

typedef struct {
    void* ptr;
    size_t size;
} reg_t;

static reg_t registry[REG_SLOTS];
static pthread_mutex_t lock = PTHREAD_MUTEX_INITIALIZER;

static size_t reg_hash(void* p)
{
    return (((uintptr_t)p) >> 21) * 0x9E3779B97F4A7C15UL >> 52;
}

static int reg_insert(void* p, size_t size)
{
    size_t h = reg_hash(p) & (REG_SLOTS - 1);
    for (size_t i = 0; i < REG_SLOTS; i++) {
        size_t k = (h + i) & (REG_SLOTS - 1);
        if (registry[k].ptr == NULL || registry[k].ptr == (void*)-1) {
            registry[k].ptr = p;
            registry[k].size = size;
            return 0;
        }
    }
    return -1; /* registry full: caller must munmap eagerly */
}

static size_t reg_remove(void* p)
{
    size_t h = reg_hash(p) & (REG_SLOTS - 1);
    for (size_t i = 0; i < REG_SLOTS; i++) {
        size_t k = (h + i) & (REG_SLOTS - 1);
        if (registry[k].ptr == p) {
            registry[k].ptr = (void*)-1; /* tombstone */
            return registry[k].size;
        }
        if (registry[k].ptr == NULL) return 0;
    }
    return 0;
}

static void* huge_mmap(size_t rounded)
{
    /* over-map by HUGE_SZ to carve a 2 MiB-aligned window, trim the ends */
    size_t span = rounded + HUGE_SZ;
    char* raw = mmap(NULL, span, PROT_READ | PROT_WRITE,
                     MAP_PRIVATE | MAP_ANONYMOUS, -1, 0);
    if (raw == MAP_FAILED) return NULL;
    uintptr_t a = ((uintptr_t)raw + HUGE_SZ - 1) & ~(HUGE_SZ - 1);
    size_t head = a - (uintptr_t)raw;
    if (head) munmap(raw, head);
    size_t tail = span - head - rounded;
    if (tail) munmap((char*)a + rounded, tail);
    madvise((void*)a, rounded, MADV_HUGEPAGE);
    return (void*)a;
}

static void* big_alloc_ex(size_t size, int* from_cache)
{
    size_t rounded = (size + HUGE_SZ - 1) & ~(HUGE_SZ - 1);
    pthread_mutex_lock(&lock);
    /* Exact size first: recurring passes allocate the same size set, and
     * letting a smaller request "steal" a larger block (best-fit within
     * 2x) forces the larger size to fresh-mmap — and re-fault — every
     * pass on a ballooned VM. The 2x window is only a fallback for sizes
     * the cache has never seen at exact granularity. */
    int best = -1;
    for (int i = 0; i < cache_n; i++) {
        if (cache[i].size == rounded) {
            best = i;
            break;
        }
        if (cache[i].size > rounded &&
            cache[i].size <= rounded * 2 &&
            (best < 0 || cache[i].size < cache[best].size))
            best = i;
    }
    if (best >= 0) {
        void* p = cache[best].ptr;
        size_t sz = cache[best].size;
        cache[best] = cache[--cache_n];
        cache_bytes -= sz;
        if (reg_insert(p, sz) != 0) {
            pthread_mutex_unlock(&lock);
            munmap(p, sz);
            return NULL;
        }
        pthread_mutex_unlock(&lock);
        if (from_cache) *from_cache = 1;
        return p;
    }
    pthread_mutex_unlock(&lock);
    void* p = huge_mmap(rounded);
    if (!p) return NULL;
    pthread_mutex_lock(&lock);
    if (reg_insert(p, rounded) != 0) {
        pthread_mutex_unlock(&lock);
        munmap(p, rounded);
        return NULL;
    }
    pthread_mutex_unlock(&lock);
    if (from_cache) *from_cache = 0;
    return p;
}

static void* big_alloc(size_t size) { return big_alloc_ex(size, NULL); }

static void big_free(void* p)
{
    pthread_mutex_lock(&lock);
    size_t sz = reg_remove(p);
    if (!sz) {
        pthread_mutex_unlock(&lock);
        return; /* not ours (shouldn't happen) */
    }
    if (cache_n < CACHE_SLOTS && cache_bytes + sz <= CACHE_MAX_BYTES) {
        cache[cache_n].ptr = p;
        cache[cache_n].size = sz;
        cache_n++;
        cache_bytes += sz;
        pthread_mutex_unlock(&lock);
        return;
    }
    pthread_mutex_unlock(&lock);
    munmap(p, sz);
}

static int is_big(void* p, size_t* size_out)
{
    pthread_mutex_lock(&lock);
    size_t h = reg_hash(p) & (REG_SLOTS - 1);
    for (size_t i = 0; i < REG_SLOTS; i++) {
        size_t k = (h + i) & (REG_SLOTS - 1);
        if (registry[k].ptr == p) {
            if (size_out) *size_out = registry[k].size;
            pthread_mutex_unlock(&lock);
            return 1;
        }
        if (registry[k].ptr == NULL) break;
    }
    pthread_mutex_unlock(&lock);
    return 0;
}

/* ---- PyDataMem_Handler hooks ---- */

static void* hp_alloc(void* ctx, size_t size)
{
    (void)ctx;
    if (size >= MIN_MMAP) {
        void* p = big_alloc(size);
        if (p) return p;
    }
    return malloc(size ? size : 1);
}

static void* hp_zeroed(void* ctx, size_t nelems, size_t elsize)
{
    size_t size = nelems * elsize;
    (void)ctx;
    if (size >= MIN_MMAP) {
        int from_cache = 0;
        void* p = big_alloc_ex(size, &from_cache);
        if (p) {
            /* fresh anonymous mmap is already zero; only cached blocks
             * (stale data) need clearing */
            if (from_cache) memset(p, 0, size);
            return p;
        }
    }
    return calloc(nelems ? nelems : 1, elsize ? elsize : 1);
}

static void hp_free(void* ctx, void* ptr, size_t size)
{
    (void)ctx;
    (void)size;
    if (!ptr) return;
    if (is_big(ptr, NULL)) {
        big_free(ptr);
        return;
    }
    free(ptr);
}

static void* hp_realloc(void* ctx, void* ptr, size_t new_size)
{
    (void)ctx;
    if (!ptr) return hp_alloc(ctx, new_size);
    size_t old_rounded;
    if (is_big(ptr, &old_rounded)) {
        if (new_size <= old_rounded) return ptr; /* shrink in place */
        void* np = hp_alloc(ctx, new_size);
        if (!np) return NULL;
        memcpy(np, ptr, old_rounded);
        big_free(ptr);
        return np;
    }
    if (new_size >= MIN_MMAP) {
        /* malloc'd block growing large: we do not know its old size, so
         * stay on the libc path (realloc copies as needed) */
        return realloc(ptr, new_size);
    }
    return realloc(ptr, new_size ? new_size : 1);
}

static PyDataMem_Handler hp_handler = {
    "panacus_hugepage_allocator",
    1,
    {
        NULL, /* ctx */
        hp_alloc,
        hp_zeroed,
        hp_realloc,
        hp_free,
    },
};

/* PyDataMem_SetHandler resolves through the numpy C-API table loaded by
 * import_array() (the symbol itself is not exported by numpy >= 2). */
static PyObject* install(PyObject* self, PyObject* args)
{
    (void)self;
    (void)args;
    PyObject* cap = PyCapsule_New(&hp_handler, "mem_handler", NULL);
    if (!cap) return NULL;
    PyObject* old = PyDataMem_SetHandler(cap);
    Py_DECREF(cap);
    if (!old) return NULL;
    Py_DECREF(old);
    Py_RETURN_NONE;
}

static PyObject* cache_stats(PyObject* self, PyObject* args)
{
    (void)self;
    (void)args;
    pthread_mutex_lock(&lock);
    PyObject* r = Py_BuildValue("(ik)", cache_n, (unsigned long)cache_bytes);
    pthread_mutex_unlock(&lock);
    return r;
}

static PyMethodDef methods[] = {
    {"install", install, METH_NOARGS,
     "Install the hugepage-backed numpy data allocator."},
    {"cache_stats", cache_stats, METH_NOARGS,
     "(cached_blocks, cached_bytes)"},
    {NULL, NULL, 0, NULL},
};

static struct PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "panacus_npalloc", NULL, -1, methods,
    NULL, NULL, NULL, NULL,
};

PyMODINIT_FUNC PyInit_panacus_npalloc(void)
{
    import_array();
    return PyModule_Create(&moduledef);
}
