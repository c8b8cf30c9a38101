/* Native GFA path tokenizer: the host-side hot loop.
 *
 * Single-pass replacements for the reference's rayon byte-scanner
 * (reference: src/graph_broker/util.rs:963-1142): turn a P-line segment
 * string "12+,34-,..." or a W-line walk ">12<34..." into dense id and
 * orientation arrays at memory speed. Called via ctypes from
 * panacus_jax/native/__init__.py; the numpy tokenizer remains as a
 * portable fallback.
 */

#include <stdint.h>
#include <stddef.h>
#include <string.h>
#include <stdlib.h>
#include <pthread.h>

#define EXPORT __attribute__((visibility("default")))

/* ---- SWAR digit parsing ---------------------------------------------------
 *
 * Node-id tokens are short decimal runs (1-8 digits cover graphs up to
 * 10^8 nodes). Instead of a byte-at-a-time loop (~3 ops/digit with a
 * branch each), load 8 bytes once and:
 *   - detect the digit-run length with a SWAR range test (one ctz),
 *   - convert all 8 "digits" with the classic 3-multiply reduction
 *     (missing digits become trailing zeros of the high bytes, shifted
 *     out before the reduction).
 * Borrow analysis for the 0x30 subtraction: digit bytes sit at the LOW
 * end and never generate borrows ('0'..'9' >= 0x30); junk bytes above
 * them may borrow, but borrows only propagate upward and the shift
 * drops those bytes. Tokens near the span end (< 16 bytes left) and
 * 9+-digit tokens take the scalar path.
 */

#define SWAR_ZEROES 0x3030303030303030ULL

/* Value of the 8 ASCII-adjusted digit bytes in `digits` (byte 0 = most
 * significant digit). */
static inline uint64_t swar8_value(uint64_t digits)
{
    const uint64_t mask = 0x000000FF000000FFULL;
    const uint64_t mul1 = 0x000F424000000064ULL; /* 100 + (1000000 << 32) */
    const uint64_t mul2 = 0x0000271000000001ULL; /* 1 + (10000 << 32) */
    digits = (digits * 10) + (digits >> 8);
    return (((digits & mask) * mul1) + (((digits >> 16) & mask) * mul2))
        >> 32;
}

/* Parse comma-separated integer tokens with a +/- orientation suffix.
 * Returns the token count, or -1 if a non-digit is found where a digit is
 * expected. ids/orient must hold at least len/2 + 1 entries. */
EXPORT int64_t pt_parse_path_pm(
    const uint8_t* s, int64_t len, int64_t* ids, uint8_t* orient)
{
    int64_t n = 0;
    int64_t i = 0;
    while (i < len) {
        if (i + 16 <= len) {
            uint64_t raw;
            memcpy(&raw, s + i, 8);
            uint64_t t = raw ^ SWAR_ZEROES;
            uint64_t nd = ((t + 0x7676767676767676ULL) | t)
                & 0x8080808080808080ULL;
            if (nd) {
                int n_dig = __builtin_ctzll(nd) >> 3;
                if (n_dig == 0) return -1;
                uint64_t digits =
                    (raw - SWAR_ZEROES) << ((8 - n_dig) * 8);
                int64_t j = i + n_dig;
                uint8_t o = s[j];
                if (o == '+') {
                    orient[n] = 0;
                } else if (o == '-') {
                    orient[n] = 1;
                } else {
                    return -1;
                }
                ids[n++] = (int64_t)swar8_value(digits);
                i = j + 1;
                if (i < len) {
                    if (s[i] != ',') return -1;
                    i++;
                }
                continue;
            }
            /* 8+ digits: scalar long-token path below */
        }
        int64_t v = 0;
        int any = 0;
        while (i < len) {
            uint8_t c = s[i];
            if (c >= '0' && c <= '9') {
                v = v * 10 + (c - '0');
                any = 1;
                i++;
            } else {
                break;
            }
        }
        if (!any) return -1;
        if (i >= len) return -1; /* missing orientation */
        uint8_t o = s[i];
        if (o == '+') {
            orient[n] = 0;
        } else if (o == '-') {
            orient[n] = 1;
        } else {
            return -1;
        }
        ids[n++] = v;
        i++;
        if (i < len) {
            if (s[i] != ',') return -1;
            i++;
        }
    }
    return n;
}

/* Parse a walk string of "><"-prefixed integer tokens. */
EXPORT int64_t pt_parse_walk_lg(
    const uint8_t* s, int64_t len, int64_t* ids, uint8_t* orient)
{
    int64_t n = 0;
    int64_t i = 0;
    while (i < len) {
        uint8_t o = s[i];
        if (o == '>') {
            orient[n] = 0;
        } else if (o == '<') {
            orient[n] = 1;
        } else {
            return -1;
        }
        i++;
        if (i + 16 <= len) {
            uint64_t raw;
            memcpy(&raw, s + i, 8);
            uint64_t t = raw ^ SWAR_ZEROES;
            uint64_t nd = ((t + 0x7676767676767676ULL) | t)
                & 0x8080808080808080ULL;
            if (nd) {
                int n_dig = __builtin_ctzll(nd) >> 3;
                if (n_dig == 0) return -1;
                uint64_t digits =
                    (raw - SWAR_ZEROES) << ((8 - n_dig) * 8);
                ids[n++] = (int64_t)swar8_value(digits);
                i += n_dig;
                continue;
            }
        }
        int64_t v = 0;
        int any = 0;
        while (i < len) {
            uint8_t c = s[i];
            if (c >= '0' && c <= '9') {
                v = v * 10 + (c - '0');
                any = 1;
                i++;
            } else {
                break;
            }
        }
        if (!any) return -1;
        ids[n++] = v;
    }
    return n;
}

/* Parse n decimal integers at byte spans [starts[i], ends[i]).
 * Returns 0, or -1 if any span is empty/non-digit/too long. */
EXPORT int64_t pt_parse_int_spans(
    const uint8_t* buf, const int64_t* starts, const int64_t* ends,
    int64_t n, int64_t* out)
{
    for (int64_t i = 0; i < n; i++) {
        int64_t a = starts[i], b = ends[i];
        if (b <= a || b - a > 18) return -1;
        int64_t v = 0;
        for (int64_t j = a; j < b; j++) {
            uint8_t c = buf[j];
            if (c < '0' || c > '9') return -1;
            v = v * 10 + (c - '0');
        }
        out[i] = v;
    }
    return 0;
}

/* ---- batch tokenizer -----------------------------------------------------
 *
 * Tokenize MANY path/walk spans in one call, writing ids directly into one
 * contiguous output array (the final ItemTable storage — no intermediate
 * per-path buffers, no concatenate). Two phases, both parallel over spans:
 *   A) count tokens per span (separator scan)
 *   B) parse digits, map names to ids, accumulate bp length
 * Name mapping modes: 0 = raw values, 1 = identity (ids are 1..n_items),
 * 2 = sorted-table binary search. Replaces the per-path driver loop of the
 * reference's rayon itemizer (src/graph_broker/util.rs:1048-1142).
 */

typedef struct {
    const uint8_t* buf;
    const int64_t* starts;
    const int64_t* ends;
    const uint8_t* walk;
    int64_t n_spans;
    int64_t* prefsum;   /* n_spans + 1, filled between phases */
    int64_t* counts;    /* scratch, n_spans */
    int64_t* out_ids;
    uint8_t* out_orient;
    int32_t mode;
    int64_t n_items;
    const int64_t* sorted_vals;
    const int64_t* sorted_ids;
    int64_t n_sorted;
    const uint32_t* node_lens;
    uint64_t* bp_out;   /* n_spans or NULL */
    /* mode 3 (string names): open-addressing hash, slot = node id or 0;
     * nh_starts/nh_ends are the S-line name byte spans in buf */
    const int64_t* nh_slots;
    int32_t nh_log2;
    const int64_t* nh_starts;
    const int64_t* nh_ends;
    /* fused membership pack (pt_tokenize_pack): right after a span's ids
     * are written — still hot in cache — OR them into per-thread private
     * node/edge rows ([0] = the caller's buffer). NULL = tokenize only. */
    const int64_t* fp_gbit;      /* group bit index per span */
    uint32_t* fp_node_rows[8];
    uint32_t* fp_edge_rows[8];
    const int64_t* fp_row_off;   /* CSR adjacency for the edge pack */
    const uint64_t* fp_adj_ent;
    int serial;         /* single-pass mode: fill prefsum on the fly */
    int64_t err;        /* 0 ok, else -(span_idx+1) of first failure */
    int64_t next;       /* work-stealing cursor (guarded by lock) */
    int phase;
    pthread_mutex_t lock;
} batch_ctx;

static int64_t grab_span(batch_ctx* c)
{
    pthread_mutex_lock(&c->lock);
    int64_t i = c->next < c->n_spans && !c->err ? c->next++ : -1;
    pthread_mutex_unlock(&c->lock);
    return i;
}

static void set_err(batch_ctx* c, int64_t span)
{
    pthread_mutex_lock(&c->lock);
    if (!c->err || -(span + 1) > c->err) c->err = -(span + 1);
    pthread_mutex_unlock(&c->lock);
}

static void count_span(batch_ctx* c, int64_t k)
{
    const uint8_t* s = c->buf;
    int64_t a = c->starts[k], b = c->ends[k];
    int64_t n = 0;
    if (c->walk[k]) {
        for (int64_t i = a; i < b; i++)
            n += (s[i] == '>') | (s[i] == '<');
    } else if (b > a) {
        n = 1;
        for (int64_t i = a; i < b; i++)
            n += (s[i] == ',');
    }
    c->counts[k] = n;
}

/* ---- string-name resolution (mode 3) --------------------------------------
 *
 * GFA segment names need not be integers; tools emit arbitrary strings
 * ("s1", "chr1_0001", ...). Mode 3 resolves each path/walk token through an
 * open-addressing FNV-1a hash over the S-line name byte spans (load <= 0.5,
 * linear probing, memcmp on hit candidates). The table is built once per
 * graph (pt_build_name_hash) and shared read-only by all tokenizer threads.
 */

static inline uint64_t name_hash_bytes(const uint8_t* p, int64_t len)
{
    uint64_t h = 1469598103934665603ULL;
    for (int64_t i = 0; i < len; i++) {
        h ^= p[i];
        h *= 1099511628211ULL;
    }
    /* Fibonacci mix: FNV's low bits are weak for short keys */
    return h * 11400714819323198485ULL;
}

/* Build the name hash: slots[j] = node id (1-based) or 0 = empty.
 * Returns 0, or -(i+1) on a duplicate name (caller already dedupes, this
 * is a defensive check). */
EXPORT int64_t pt_build_name_hash(
    const uint8_t* buf, const int64_t* starts, const int64_t* ends,
    int64_t n, int64_t* slots, int32_t log2_slots)
{
    uint64_t mask = (1ULL << log2_slots) - 1;
    for (int64_t i = 0; i < n; i++) {
        const uint8_t* p = buf + starts[i];
        int64_t len = ends[i] - starts[i];
        uint64_t j = (name_hash_bytes(p, len) >> (64 - log2_slots)) & mask;
        while (slots[j]) {
            int64_t other = slots[j] - 1;
            if (ends[other] - starts[other] == len
                && memcmp(buf + starts[other], p, (size_t)len) == 0)
                return -(i + 1);
            j = (j + 1) & mask;
        }
        slots[j] = i + 1;
    }
    return 0;
}

static inline int64_t name_hash_find(
    const uint8_t* buf, const int64_t* slots, int32_t log2_slots,
    const int64_t* nstarts, const int64_t* nends,
    const uint8_t* p, int64_t len)
{
    uint64_t mask = (1ULL << log2_slots) - 1;
    uint64_t j = (name_hash_bytes(p, len) >> (64 - log2_slots)) & mask;
    while (slots[j]) {
        int64_t cand = slots[j] - 1;
        if (nends[cand] - nstarts[cand] == len
            && memcmp(buf + nstarts[cand], p, (size_t)len) == 0)
            return cand + 1;
        j = (j + 1) & mask;
    }
    return 0;
}

static inline int64_t name_lookup(
    const batch_ctx* c, const uint8_t* p, int64_t len)
{
    return name_hash_find(
        c->buf, c->nh_slots, c->nh_log2, c->nh_starts, c->nh_ends, p, len);
}

/* Mode-3 parse of one span: tokens are arbitrary name strings; P-line
 * token = "name{+|-}" (orientation is the LAST byte, matching the numpy
 * fallback), W-line token = "{>|<}name" with the name running to the next
 * '>'/'<'. */
static int parse_span_names(batch_ctx* c, int64_t k)
{
    const uint8_t* s = c->buf;
    int64_t a = c->starts[k], b = c->ends[k];
    int64_t* ids = c->out_ids + c->prefsum[k];
    uint8_t* orient = c->out_orient + c->prefsum[k];
    int64_t cnt = 0;
    uint64_t bp = 0;
    if (c->walk[k]) {
        int64_t i = a;
        while (i < b) {
            uint8_t o = s[i];
            if (o == '>') orient[cnt] = 0;
            else if (o == '<') orient[cnt] = 1;
            else return -1;
            i++;
            int64_t ns = i;
            while (i < b && s[i] != '>' && s[i] != '<') i++;
            if (i == ns) return -1;
            int64_t id = name_lookup(c, s + ns, i - ns);
            if (!id) return -1;
            ids[cnt++] = id;
            if (c->node_lens) bp += c->node_lens[id];
        }
    } else {
        int64_t i = a;
        while (i < b) {
            int64_t ns = i;
            while (i < b && s[i] != ',') i++;
            int64_t ne = i;
            if (ne - ns < 2) return -1;
            uint8_t o = s[ne - 1];
            if (o == '+') orient[cnt] = 0;
            else if (o == '-') orient[cnt] = 1;
            else return -1;
            int64_t id = name_lookup(c, s + ns, ne - 1 - ns);
            if (!id) return -1;
            ids[cnt++] = id;
            if (c->node_lens) bp += c->node_lens[id];
            if (i < b) i++; /* skip ',' */
        }
    }
    if (c->serial) c->prefsum[k + 1] = c->prefsum[k] + cnt;
    else if (cnt != c->prefsum[k + 1] - c->prefsum[k]) return -1;
    if (c->bp_out) c->bp_out[k] = bp;
    return 0;
}

/* defined later in the file (edge/membership pack helpers) */
static int64_t pack_pairs_row(
    const int64_t* ids, const uint8_t* orient, int64_t a, int64_t b,
    uint32_t bit, uint32_t* row,
    const int64_t* row_off, const uint64_t* adj_ent);
static void pack_items_row(
    const int64_t* ids, int64_t a, int64_t b, uint32_t bit, uint32_t* row);

/* fused pack of span k's freshly written ids (cache-hot). Returns 0 or
 * a negative error. */
static int64_t fused_pack_span(batch_ctx* c, int64_t k, int tid)
{
    if (!c->fp_gbit) return 0;
    uint32_t bit = (uint32_t)1 << c->fp_gbit[k];
    int64_t a = c->prefsum[k], b = c->prefsum[k + 1];
    if (c->fp_node_rows[0])
        pack_items_row(c->out_ids, a, b, bit, c->fp_node_rows[tid]);
    if (c->fp_edge_rows[0])
        return pack_pairs_row(
            c->out_ids, c->out_orient, a, b, bit,
            c->fp_edge_rows[tid], c->fp_row_off, c->fp_adj_ent);
    return 0;
}

static int parse_span(batch_ctx* c, int64_t k, int tid)
{
    if (c->mode == 3) {
        int r = parse_span_names(c, k);
        if (r != 0) return r;
        return fused_pack_span(c, k, tid) == 0 ? 0 : -1;
    }
    const uint8_t* s = c->buf;
    int64_t a = c->starts[k], b = c->ends[k];
    int64_t* ids = c->out_ids + c->prefsum[k];
    uint8_t* orient = c->out_orient + c->prefsum[k];
    int64_t cnt;
    if (c->walk[k]) {
        cnt = pt_parse_walk_lg(s + a, b - a, ids, orient);
    } else if (b > a) {
        cnt = pt_parse_path_pm(s + a, b - a, ids, orient);
    } else {
        cnt = 0;
    }
    if (c->serial) c->prefsum[k + 1] = c->prefsum[k] + cnt;
    else if (cnt != c->prefsum[k + 1] - c->prefsum[k]) return -1;
    uint64_t bp = 0;
    if (c->mode == 1) {
        for (int64_t i = 0; i < cnt; i++) {
            int64_t v = ids[i];
            if (v < 1 || v > c->n_items) return -1;
            if (c->node_lens) bp += c->node_lens[v];
        }
    } else if (c->mode == 2) {
        for (int64_t i = 0; i < cnt; i++) {
            int64_t v = ids[i];
            int64_t lo = 0, hi = c->n_sorted;
            while (lo < hi) {
                int64_t mid = (lo + hi) >> 1;
                if (c->sorted_vals[mid] < v) lo = mid + 1;
                else hi = mid;
            }
            if (lo >= c->n_sorted || c->sorted_vals[lo] != v) return -1;
            ids[i] = c->sorted_ids[lo];
            if (c->node_lens) bp += c->node_lens[ids[i]];
        }
    } else if (c->node_lens) {
        for (int64_t i = 0; i < cnt; i++) {
            int64_t v = ids[i];
            if (v < 1 || v > c->n_items) return -1;
            bp += c->node_lens[v];
        }
    }
    if (c->bp_out) c->bp_out[k] = bp;
    return fused_pack_span(c, k, tid) == 0 ? 0 : -1;
}

typedef struct {
    batch_ctx* c;
    int tid;
} batch_arg;

static void* batch_worker(void* argp)
{
    batch_arg* ba = (batch_arg*)argp;
    batch_ctx* c = ba->c;
    int64_t k;
    while ((k = grab_span(c)) >= 0) {
        if (c->phase == 0) {
            count_span(c, k);
        } else if (parse_span(c, k, ba->tid) != 0) {
            set_err(c, k);
        }
    }
    return NULL;
}

static void run_phase(batch_ctx* c, int phase, int32_t n_threads)
{
    c->phase = phase;
    c->next = 0;
    if (n_threads > c->n_spans) n_threads = (int32_t)c->n_spans;
    if (n_threads < 1) n_threads = 1;
    if (n_threads > 64) n_threads = 64;
    /* fused pack: tids index the fixed fp_*_rows[8] arrays — enforce the
     * clamp structurally, not just in pt_tokenize_pack */
    if (c->fp_gbit && n_threads > 8) n_threads = 8;
    batch_arg args[64];
    if (n_threads == 1) {
        args[0].c = c;
        args[0].tid = 0;
        batch_worker(&args[0]);
        return;
    }
    pthread_t tids[64];
    int spawned = 0;
    for (int t = 1; t < n_threads; t++) {
        args[t].c = c;
        args[t].tid = t;
        if (pthread_create(&tids[t], NULL, batch_worker, &args[t]) == 0)
            spawned++;
        else
            break;
    }
    args[0].c = c;
    args[0].tid = 0;
    batch_worker(&args[0]);
    for (int t = 1; t <= spawned; t++) pthread_join(tids[t], NULL);
}

/* Phase A standalone: count tokens per span (threaded separator scan) and
 * fill prefsum; returns the total so the caller can allocate exactly. */
EXPORT int64_t pt_count_tokens(
    const uint8_t* buf,
    const int64_t* starts, const int64_t* ends, const uint8_t* walk,
    int64_t n_spans, int64_t* prefsum, int64_t* counts, int32_t n_threads)
{
    batch_ctx c = {
        buf, starts, ends, walk, n_spans, prefsum, counts,
        NULL, NULL, 0, 0, NULL, NULL, 0, NULL, NULL,
        NULL, 0, NULL, NULL,
        NULL, {NULL}, {NULL}, NULL, NULL,
        0, 0, 0, 0, PTHREAD_MUTEX_INITIALIZER,
    };
    run_phase(&c, 0, n_threads);
    int64_t tot = 0;
    prefsum[0] = 0;
    for (int64_t k = 0; k < n_spans; k++) {
        tot += counts[k];
        prefsum[k + 1] = tot;
    }
    return tot;
}

/* Phase B: parse into exactly-sized output at the offsets in prefsum
 * (from pt_count_tokens). Returns total token count (>= 0) on success, or
 * -(span_idx+1) on the first malformed span / unknown name. */
EXPORT int64_t pt_tokenize_batch(
    const uint8_t* buf,
    const int64_t* starts, const int64_t* ends, const uint8_t* walk,
    int64_t n_spans,
    int64_t* prefsum, int64_t* counts,
    int64_t* out_ids, uint8_t* out_orient, int64_t cap_ids,
    int32_t mode, int64_t n_items,
    const int64_t* sorted_vals, const int64_t* sorted_ids, int64_t n_sorted,
    const uint32_t* node_lens, uint64_t* bp_out,
    const int64_t* name_slots, int32_t name_log2,
    const int64_t* name_starts, const int64_t* name_ends,
    int32_t n_threads)
{
    batch_ctx c = {
        buf, starts, ends, walk, n_spans, prefsum, counts,
        out_ids, out_orient, mode, n_items,
        sorted_vals, sorted_ids, n_sorted, node_lens, bp_out,
        name_slots, name_log2, name_starts, name_ends,
        NULL, {NULL}, {NULL}, NULL, NULL,
        0, 0, 0, 0, PTHREAD_MUTEX_INITIALIZER,
    };
    int64_t tot = prefsum[n_spans];
    if (tot > cap_ids) return -1000000000 - tot;
    run_phase(&c, 1, n_threads);
    if (c.err) return c.err;
    return tot;
}

/* Serial single-pass tokenize: parses spans in order, filling prefsum on
 * the fly — no counting pre-pass, so the payload is read once instead of
 * twice. Built for the gz follower, whose during-inflate budget is one
 * core. The caller supplies a worst-case capacity; each span is bounds-
 * checked ((len/2)+2 tokens max) before parsing, and the call bails with
 * the fallback sentinel when the next span would not fit (caller reverts
 * to the two-phase path). Returns total tokens or -(span+1) on error. */
EXPORT int64_t pt_tokenize_serial(
    const uint8_t* buf,
    const int64_t* starts, const int64_t* ends, const uint8_t* walk,
    int64_t n_spans,
    int64_t* prefsum,
    int64_t* out_ids, uint8_t* out_orient, int64_t cap_ids,
    int32_t mode, int64_t n_items,
    const int64_t* sorted_vals, const int64_t* sorted_ids, int64_t n_sorted,
    const uint32_t* node_lens, uint64_t* bp_out,
    const int64_t* name_slots, int32_t name_log2,
    const int64_t* name_starts, const int64_t* name_ends)
{
    batch_ctx c = {
        buf, starts, ends, walk, n_spans, prefsum, NULL,
        out_ids, out_orient, mode, n_items,
        sorted_vals, sorted_ids, n_sorted, node_lens, bp_out,
        name_slots, name_log2, name_starts, name_ends,
        NULL, {NULL}, {NULL}, NULL, NULL,
        1, 0, 0, 1, PTHREAD_MUTEX_INITIALIZER,
    };
    prefsum[0] = 0;
    for (int64_t k = 0; k < n_spans; k++) {
        int64_t need = (ends[k] - starts[k]) / 2 + 2;
        if (prefsum[k] + need > cap_ids) return -1000000000 - k;
        if (parse_span(&c, k, 0) != 0) return -(k + 1);
    }
    return prefsum[n_spans];
}

/* Fused tokenize + membership pack: phase B additionally ORs each span's
 * freshly parsed ids (cache-hot) into node and/or edge membership rows —
 * the separate pack passes re-read the whole token array (~8 bytes/token)
 * from DRAM; fusing removes those reads entirely. gbit[k] is span k's
 * group bit. node_row / edge_row are the caller's zeroed uint32 rows
 * (either may be NULL); edge pack resolves pairs through the CSR
 * adjacency (row_off/adj_ent). Extra threads scatter into private zeroed
 * rows merged after the join (OR is idempotent + commutative).
 * Returns total token count, or negative on error (caller falls back to
 * tokenize + separate packs). */
EXPORT int64_t pt_tokenize_pack(
    const uint8_t* buf,
    const int64_t* starts, const int64_t* ends, const uint8_t* walk,
    int64_t n_spans,
    int64_t* prefsum, int64_t* counts,
    int64_t* out_ids, uint8_t* out_orient, int64_t cap_ids,
    int32_t mode, int64_t n_items,
    const int64_t* sorted_vals, const int64_t* sorted_ids, int64_t n_sorted,
    const uint32_t* node_lens, uint64_t* bp_out,
    const int64_t* name_slots, int32_t name_log2,
    const int64_t* name_starts, const int64_t* name_ends,
    const int64_t* gbit,
    uint32_t* node_row, int64_t node_len,
    const int64_t* row_off, const uint64_t* adj_ent,
    uint32_t* edge_row, int64_t edge_len,
    int32_t n_threads)
{
    batch_ctx c = {
        buf, starts, ends, walk, n_spans, prefsum, counts,
        out_ids, out_orient, mode, n_items,
        sorted_vals, sorted_ids, n_sorted, node_lens, bp_out,
        name_slots, name_log2, name_starts, name_ends,
        gbit, {node_row}, {edge_row}, row_off, adj_ent,
        0, 0, 0, 0, PTHREAD_MUTEX_INITIALIZER,
    };
    int64_t tot = prefsum[n_spans];
    if (tot > cap_ids) return -1000000000 - tot;
    if (n_threads > 8) n_threads = 8;
    if (n_threads > (int32_t)n_spans) n_threads = (int32_t)n_spans;
    if (n_threads < 1) n_threads = 1;
    /* private rows for threads 1..n-1 */
    int alloc_ok = 1;
    for (int t = 1; t < n_threads; t++) {
        if (node_row) {
            c.fp_node_rows[t] =
                (uint32_t*)calloc((size_t)node_len, sizeof(uint32_t));
            if (!c.fp_node_rows[t]) alloc_ok = 0;
        }
        if (edge_row) {
            c.fp_edge_rows[t] =
                (uint32_t*)calloc((size_t)edge_len, sizeof(uint32_t));
            if (!c.fp_edge_rows[t]) alloc_ok = 0;
        }
        if (!alloc_ok) {
            n_threads = t;
            if (node_row && c.fp_node_rows[t]) free(c.fp_node_rows[t]);
            if (edge_row && c.fp_edge_rows[t]) free(c.fp_edge_rows[t]);
            c.fp_node_rows[t] = NULL;
            c.fp_edge_rows[t] = NULL;
            break;
        }
    }
    run_phase(&c, 1, n_threads);
    for (int t = 1; t < n_threads; t++) {
        if (c.fp_node_rows[t]) {
            if (!c.err)
                for (int64_t i = 0; i < node_len; i++)
                    node_row[i] |= c.fp_node_rows[t][i];
            free(c.fp_node_rows[t]);
        }
        if (c.fp_edge_rows[t]) {
            if (!c.err)
                for (int64_t i = 0; i < edge_len; i++)
                    edge_row[i] |= c.fp_edge_rows[t][i];
            free(c.fp_edge_rows[t]);
        }
    }
    if (c.err) return c.err;
    return tot;
}

/* ---- masked interval walker ----------------------------------------------
 *
 * The subset/exclude path itemizer (reference: update_tables,
 * src/graph_broker/util.rs:569-721) walks a path node-by-node against
 * sorted include/exclude coordinate intervals. Exact port of the Python
 * loop in itemize._update_tables, which is itself the bit-exact port of
 * the reference: pushes, included-bp accounting, and a compressed event
 * stream for the interval containers. A presence bitmap (mirror of
 * subset_covered_bps.contains) lets full-coverage visits skip event
 * emission unless a removal actually happens, so the Python replay loop
 * only sees boundary nodes.
 *
 * cov events: (sid, a, b, kind, pos) with kind 0 = add(a, b), 1 =
 * remove; pos = pos_base + visit index (the multi-host merge orders
 * events globally with it — see parallel.ingest).
 * exc events: (sid, a, b) — the caller applies them to each exclude
 * table (plain activate or annotated activate), in order.
 * last_full (nullable, int64[n_nodes]): receives the position of the
 * LAST full-coverage visit of each node, set UNCONDITIONALLY (presence
 * only compresses the kind-1 event stream; the cross-host merge needs
 * every full cover because any of them empties the node's covered
 * state).
 * Returns the push count, or -1 if an output capacity would overflow
 * (caller falls back to the Python walker).
 */
EXPORT int64_t pt_interval_walk(
    const int64_t* ids, const uint8_t* orient, int64_t n_ids,
    const uint32_t* node_lens,
    const int64_t* inc, int64_t n_inc,
    const int64_t* exc, int64_t n_exc,
    int64_t offset,
    uint8_t* cov_present, /* may be NULL: no covered-bps tracking */
    int64_t* pushed, int64_t cap_pushed,
    int64_t* cov_ev, int64_t cap_cov, int64_t* n_cov_out,
    int64_t* exc_ev, int64_t cap_exc, int64_t* n_exc_out,
    int64_t* included_bp_out,
    int64_t pos_base, int64_t* last_full)
{
    int64_t i = 0, j = 0;
    int64_t p = offset;
    int64_t n_pushed = 0, n_cov = 0, n_excev = 0;
    int64_t included_bp = 0;

    for (int64_t k = 0; k < n_ids; k++) {
        int64_t sid = ids[k];
        int64_t l = node_lens[sid];
        int o = orient[k];

        int stop_here = 0;
        while (i < n_inc && inc[2 * i] < p + l && !stop_here) {
            if (inc[2 * i + 1] > p) {
                int64_t a = inc[2 * i] > p ? inc[2 * i] - p : 0;
                int64_t b;
                if (inc[2 * i + 1] < p + l) {
                    i++;
                    b = inc[2 * (i - 1) + 1] - p;
                } else {
                    stop_here = 1;
                    b = l;
                }
                if (o == 1) {
                    int64_t na = l - b, nb = l - a;
                    a = na;
                    b = nb;
                }
                if (n_pushed >= cap_pushed) return -1;
                pushed[n_pushed++] = sid;
                if (cov_present) {
                    if (b - a == l) {
                        if (last_full) last_full[sid] = pos_base + k;
                        if (cov_present[sid]) {
                            cov_present[sid] = 0;
                            if (n_cov >= cap_cov) return -1;
                            cov_ev[5 * n_cov] = sid;
                            cov_ev[5 * n_cov + 1] = 0;
                            cov_ev[5 * n_cov + 2] = 0;
                            cov_ev[5 * n_cov + 3] = 1;
                            cov_ev[5 * n_cov + 4] = pos_base + k;
                            n_cov++;
                        }
                    } else {
                        cov_present[sid] = 1;
                        if (n_cov >= cap_cov) return -1;
                        cov_ev[5 * n_cov] = sid;
                        cov_ev[5 * n_cov + 1] = a;
                        cov_ev[5 * n_cov + 2] = b;
                        cov_ev[5 * n_cov + 3] = 0;
                        cov_ev[5 * n_cov + 4] = pos_base + k;
                        n_cov++;
                    }
                }
                included_bp += b - a;
            } else {
                i++;
            }
        }

        stop_here = 0;
        while (j < n_exc && exc[2 * j] < p + l && !stop_here) {
            if (exc[2 * j + 1] > p) {
                int64_t a = exc[2 * j] > p ? exc[2 * j] - p : 0;
                int64_t b;
                if (exc[2 * j + 1] < p + l) {
                    j++;
                    b = exc[2 * (j - 1) + 1] - p;
                } else {
                    stop_here = 1;
                    b = l;
                }
                if (o == 1) {
                    int64_t na = l - b, nb = l - a;
                    a = na;
                    b = nb;
                }
                if (n_excev >= cap_exc) return -1;
                exc_ev[3 * n_excev] = sid;
                exc_ev[3 * n_excev + 1] = a;
                exc_ev[3 * n_excev + 2] = b;
                n_excev++;
            } else {
                j++;
            }
        }

        if (i >= n_inc && j >= n_exc) break;
        p += l;
    }
    *n_cov_out = n_cov;
    *n_exc_out = n_excev;
    *included_bp_out = included_bp;
    return n_pushed;
}

/* ---- newline/tab scanner -------------------------------------------------
 *
 * One pass over the whole GFA buffer collecting '\n' and '\t' positions
 * (the structural index every other stage consumes), threaded by static
 * byte ranges: count per range, host prefix-sums, fill per range.
 */

typedef struct {
    const uint8_t* buf;
    int64_t n;
    int64_t n_ranges;
    int64_t* nl_counts;  /* per range */
    int64_t* tab_counts;
    const int64_t* nl_off;  /* fill phase: start offset per range */
    const int64_t* tab_off;
    int64_t* nl_out;
    int64_t* tab_out;
    int phase;
    int64_t next;
    pthread_mutex_t lock;
} scan_ctx;

static void* scan_worker(void* arg)
{
    scan_ctx* c = (scan_ctx*)arg;
    for (;;) {
        pthread_mutex_lock(&c->lock);
        int64_t r = c->next < c->n_ranges ? c->next++ : -1;
        pthread_mutex_unlock(&c->lock);
        if (r < 0) return NULL;
        int64_t chunk = (c->n + c->n_ranges - 1) / c->n_ranges;
        int64_t a = r * chunk;
        int64_t b = a + chunk < c->n ? a + chunk : c->n;
        if (c->phase == 0) {
            /* SWAR count: has-byte trick + popcount, 8 bytes per step
             * (the scalar byte loop was the slower of the two scan
             * passes once the fill stopped writing tabs) */
            const uint8_t* base = c->buf;
            const uint64_t NL = 0x0A0A0A0A0A0A0A0AULL;
            const uint64_t TB = 0x0909090909090909ULL;
            const uint64_t LO = 0x0101010101010101ULL;
            const uint64_t HI = 0x8080808080808080ULL;
            int64_t nl = 0, tab = 0;
            int64_t i = a;
            for (; i + 8 <= b; i += 8) {
                uint64_t x;
                memcpy(&x, base + i, 8);
                uint64_t tn = x ^ NL;
                uint64_t tt = x ^ TB;
                nl += __builtin_popcountll((tn - LO) & ~tn & HI);
                tab += __builtin_popcountll((tt - LO) & ~tt & HI);
            }
            for (; i < b; i++) {
                nl += (base[i] == '\n');
                tab += (base[i] == '\t');
            }
            c->nl_counts[r] = nl;
            c->tab_counts[r] = tab;
        } else if (c->tab_out == NULL) {
            /* newline-only fill: callers whose field parsing is native
             * (pt_s_spans / pt_index_edges / pt_tokenize re-scan their own
             * lines) never materialize the global tab index — dropping
             * ~8 bytes of writes per tab, the dominant write traffic of
             * the structural scan on L/S-dense GFAs. */
            int64_t* nl = c->nl_out + c->nl_off[r];
            const uint8_t* base = c->buf;
            const uint64_t NL = 0x0A0A0A0A0A0A0A0AULL;
            const uint64_t LO = 0x0101010101010101ULL;
            const uint64_t HI = 0x8080808080808080ULL;
            int64_t i = a;
            for (; i + 8 <= b; i += 8) {
                uint64_t x;
                memcpy(&x, base + i, 8);
                uint64_t tn = x ^ NL;
                uint64_t hn = (tn - LO) & ~tn & HI;
                while (hn) {
                    *nl++ = i + (__builtin_ctzll(hn) >> 3);
                    hn &= hn - 1;
                }
            }
            for (; i < b; i++) {
                if (base[i] == '\n') *nl++ = i;
            }
        } else {
            /* one SWAR pass finds BOTH separators: 8 bytes per load with
             * the has-byte bit trick, positions extracted via ctz. GFA
             * separator density (a tab every ~14 bytes through the S/L
             * section) made memchr-per-occurrence call overhead the
             * index-phase bottleneck; this also halves the reads (one
             * pass instead of a '\n' pass and a '\t' pass). */
            int64_t* nl = c->nl_out + c->nl_off[r];
            int64_t* tab = c->tab_out + c->tab_off[r];
            const uint8_t* base = c->buf;
            const uint64_t NL = 0x0A0A0A0A0A0A0A0AULL;
            const uint64_t TB = 0x0909090909090909ULL;
            const uint64_t LO = 0x0101010101010101ULL;
            const uint64_t HI = 0x8080808080808080ULL;
            int64_t i = a;
            for (; i + 8 <= b; i += 8) {
                uint64_t x;
                memcpy(&x, base + i, 8);
                uint64_t tn = x ^ NL;
                uint64_t tt = x ^ TB;
                uint64_t hn = (tn - LO) & ~tn & HI;
                uint64_t ht = (tt - LO) & ~tt & HI;
                while (hn) {
                    *nl++ = i + (__builtin_ctzll(hn) >> 3);
                    hn &= hn - 1;
                }
                while (ht) {
                    *tab++ = i + (__builtin_ctzll(ht) >> 3);
                    ht &= ht - 1;
                }
            }
            for (; i < b; i++) {
                uint8_t ch = base[i];
                if (ch == '\n') *nl++ = i;
                else if (ch == '\t') *tab++ = i;
            }
        }
    }
}

static void scan_run(scan_ctx* c, int phase, int32_t n_threads)
{
    c->phase = phase;
    c->next = 0;
    if (n_threads < 1) n_threads = 1;
    if (n_threads > 64) n_threads = 64;
    if (n_threads == 1) {
        scan_worker(c);
        return;
    }
    pthread_t tids[64];
    int spawned = 0;
    for (int t = 0; t < n_threads - 1; t++) {
        if (pthread_create(&tids[t], NULL, scan_worker, c) == 0) spawned++;
        else break;
    }
    scan_worker(c);
    for (int t = 0; t < spawned; t++) pthread_join(tids[t], NULL);
}

/* Line classification from a newline-position index: start/end (CR
 * stripped) and first byte of every NON-EMPTY line, compacted. One cheap
 * serial pass (~6 ops/line) replacing several full-width numpy
 * temporaries; `prev_end` is the byte offset where the previous chunk's
 * processing stopped (0 for a whole-buffer call), so the gz follower can
 * call it chunk-wise. Returns the number of kept lines. */
EXPORT int64_t pt_classify_lines(
    const uint8_t* buf, const int64_t* nl, int64_t n_nl, int64_t prev_end,
    int64_t* starts, int64_t* ends, uint8_t* first)
{
    int64_t out = 0;
    int64_t start = prev_end;
    for (int64_t i = 0; i < n_nl; i++) {
        int64_t e = nl[i];
        int64_t es = e;
        if (es > 0 && buf[es - 1] == '\r') es--;
        if (es > start) {
            starts[out] = start;
            ends[out] = es;
            first[out] = buf[start];
            out++;
        }
        start = e + 1;
    }
    return out;
}

/* counts[0..n_ranges) newlines, counts[n_ranges..2*n_ranges) tabs */
EXPORT void pt_scan_count(
    const uint8_t* buf, int64_t n, int64_t n_ranges, int64_t* counts,
    int32_t n_threads)
{
    scan_ctx c = {
        buf, n, n_ranges, counts, counts + n_ranges,
        NULL, NULL, NULL, NULL, 0, 0, PTHREAD_MUTEX_INITIALIZER,
    };
    scan_run(&c, 0, n_threads);
}

EXPORT void pt_scan_fill(
    const uint8_t* buf, int64_t n, int64_t n_ranges,
    const int64_t* nl_off, const int64_t* tab_off,
    int64_t* nl_out, int64_t* tab_out, int32_t n_threads)
{
    scan_ctx c = {
        buf, n, n_ranges, NULL, NULL,
        nl_off, tab_off, nl_out, tab_out, 0, 0, PTHREAD_MUTEX_INITIALIZER,
    };
    scan_run(&c, 1, n_threads);
}

/* ---- per-S-line field spans ---------------------------------------------
 *
 * Name end and sequence length for every S line without the global tab
 * index (reference field layout: S \t name \t seq [\t tags..],
 * src/graph_broker/graph.rs parse_segment): name spans (start+2, t2),
 * seq spans (t2+1, t3-or-line-end). Threaded over line chunks; memchr
 * does the heavy lifting (sequence bytes dominate real GFAs).
 */

typedef struct {
    const uint8_t* buf;
    const int64_t* starts;
    const int64_t* ends;
    int64_t n;
    int64_t* name_end;
    int64_t* seq_len;
    int64_t* ints;          /* optional: parsed integer names */
    volatile int ints_bad;  /* any non-integer / too-long name seen */
    int64_t next;
    int64_t rc; /* 0 ok, -(i+1) = malformed line i */
    pthread_mutex_t lock;
} sspan_ctx;

static void* sspan_worker(void* arg)
{
    sspan_ctx* c = (sspan_ctx*)arg;
    const int64_t CHUNK = 8192;
    for (;;) {
        pthread_mutex_lock(&c->lock);
        int64_t a = c->next;
        c->next += CHUNK;
        int64_t stop = c->rc != 0;
        pthread_mutex_unlock(&c->lock);
        if (a >= c->n || stop) return NULL;
        int64_t b = a + CHUNK < c->n ? a + CHUNK : c->n;
        for (int64_t i = a; i < b; i++) {
            int64_t s = c->starts[i] + 2;
            int64_t e = c->ends[i];
            if (s > e) s = e;
            const uint8_t* p = memchr(c->buf + s, '\t', (size_t)(e - s));
            if (!p) {
                pthread_mutex_lock(&c->lock);
                if (!c->rc) c->rc = -(i + 1);
                pthread_mutex_unlock(&c->lock);
                return NULL;
            }
            int64_t t2 = p - c->buf;
            const uint8_t* q =
                memchr(c->buf + t2 + 1, '\t', (size_t)(e - t2 - 1));
            int64_t t3 = q ? q - c->buf : e;
            c->name_end[i] = t2;
            c->seq_len[i] = t3 - t2 - 1;
            if (c->ints && !c->ints_bad) {
                /* decimal name parse fused into the span walk (the name
                 * bytes are already in cache); a single non-integer name
                 * turns the whole pass off (benign racy flag: spans stay
                 * valid, caller just discards ints) */
                int64_t len = t2 - s;
                if (len < 1 || len > 18) { c->ints_bad = 1; continue; }
                int64_t v = 0;
                for (int64_t k = s; k < t2; k++) {
                    uint8_t d = c->buf[k] - '0';
                    if (d > 9) { c->ints_bad = 1; v = 0; break; }
                    v = v * 10 + d;
                }
                c->ints[i] = v;
            }
        }
    }
}

EXPORT int64_t pt_s_spans_ints(
    const uint8_t* buf, const int64_t* starts, const int64_t* ends,
    int64_t n, int64_t* name_end, int64_t* seq_len,
    int64_t* ints, int32_t* ints_ok, int32_t n_threads);

EXPORT int64_t pt_s_spans(
    const uint8_t* buf, const int64_t* starts, const int64_t* ends,
    int64_t n, int64_t* name_end, int64_t* seq_len, int32_t n_threads)
{
    return pt_s_spans_ints(
        buf, starts, ends, n, name_end, seq_len, NULL, NULL, n_threads);
}

/* pt_s_spans with the integer-name parse fused in: ints[i] receives the
 * decimal value of S-line i's name; *ints_ok is set to 0 when any name is
 * not a plain 1-18 digit integer (ints contents are then unspecified,
 * name_end/seq_len remain valid). */
EXPORT int64_t pt_s_spans_ints(
    const uint8_t* buf, const int64_t* starts, const int64_t* ends,
    int64_t n, int64_t* name_end, int64_t* seq_len,
    int64_t* ints, int32_t* ints_ok, int32_t n_threads)
{
    sspan_ctx c = {
        buf, starts, ends, n, name_end, seq_len, ints, 0, 0, 0,
        PTHREAD_MUTEX_INITIALIZER,
    };
    if (n_threads < 1) n_threads = 1;
    if (n_threads > 64) n_threads = 64;
    if (n_threads == 1 || n < 2 * 8192) {
        sspan_worker(&c);
        if (ints_ok) *ints_ok = c.ints_bad ? 0 : 1;
        return c.rc;
    }
    pthread_t tids[64];
    int spawned = 0;
    for (int t = 0; t < n_threads - 1; t++) {
        if (pthread_create(&tids[t], NULL, sspan_worker, &c) == 0) spawned++;
        else break;
    }
    sspan_worker(&c);
    for (int t = 0; t < spawned; t++) pthread_join(tids[t], NULL);
    if (ints_ok) *ints_ok = c.ints_bad ? 0 : 1;
    return c.rc;
}

/* ---- edge-id lookup ------------------------------------------------------
 *
 * Map consecutive oriented node pairs of every path to canonical edge ids
 * (reference: Edge::canonical src/graph_broker/graph.rs:142-148 + the
 * pair walk of update_tables_edgecount util.rs:723-795) in one threaded
 * pass: no numpy temporaries, one open-addressing hash probe per pair
 * (~1-2 cache lines vs ~21 for a binary search over millions of edges).
 * out_pref[p]..out_pref[p+1] delimits path p's edge run; out_pref must be
 * precomputed as cumsum(max(counts,1)-1).
 *
 * Hash table: power-of-two slot count, Fibonacci multiplicative hash,
 * linear probing. Canonical keys are (u<<33)|(v<<2)|(o1<<1)|o2 with
 * v >= 1, so every valid key is >= 4 and slot key 0 means "empty".
 */

#define EDGE_HASH_MUL 0x9E3779B97F4A7C15ull

/* Canonical edge key (reference: Edge::canonical
 * src/graph_broker/graph.rs:142-148): flip when u > v, or u == v and o1
 * is backward; pack as (u<<33)|(v<<2)|(o1<<1)|o2. The ONE definition all
 * native index/lookup paths share. */
static inline uint64_t edge_canonical_key(
    int64_t u, uint8_t o1, int64_t v, uint8_t o2)
{
    uint64_t cu, cv, co1, co2;
    if (u > v || (u == v && o1)) {
        cu = (uint64_t)v; co1 = o2 ^ 1u;
        cv = (uint64_t)u; co2 = o1 ^ 1u;
    } else {
        cu = (uint64_t)u; co1 = o1;
        cv = (uint64_t)v; co2 = o2;
    }
    return (cu << 33) | (cv << 2) | (co1 << 1) | co2;
}

/* Probe the interleaved (key, eid) slot table. Returns the eid, or 0 if
 * the key is absent (valid eids are >= 1). */
static inline uint64_t edge_hash_get(
    const uint64_t* slots, uint64_t mask, int shift, uint64_t key)
{
    uint64_t s = (key * EDGE_HASH_MUL) >> shift;
    uint64_t sk;
    while ((sk = slots[2 * s]) != key) {
        if (!sk) return 0;
        s = (s + 1) & mask;
    }
    return slots[2 * s + 1];
}

/* Populate a zeroed slot table (n_slots = 1 << log2_slots, must exceed n).
 * Slots are interleaved (key, eid) uint64 pairs so a probe that hits costs
 * one cache line, not two. */
EXPORT void pt_build_edge_hash(
    const uint64_t* keys, const int64_t* eids, int64_t n,
    uint64_t* slots, int32_t log2_slots)
{
    uint64_t mask = ((uint64_t)1 << log2_slots) - 1;
    int shift = 64 - log2_slots;
    for (int64_t i = 0; i < n; i++) {
        uint64_t s = (keys[i] * EDGE_HASH_MUL) >> shift;
        while (slots[2 * s]) s = (s + 1) & mask;
        slots[2 * s] = keys[i];
        slots[2 * s + 1] = (uint64_t)eids[i];
    }
}

typedef struct {
    const int64_t* ids;
    const uint8_t* orient;
    const int64_t* prefsum;
    int64_t n_paths;
    const uint64_t* slots;
    int32_t log2_slots;
    int64_t* out_eids;
    const int64_t* out_pref;
    int64_t err;
    int64_t next;
    pthread_mutex_t lock;
} edge_ctx;

static void* edge_worker(void* arg)
{
    edge_ctx* c = (edge_ctx*)arg;
    uint64_t mask = ((uint64_t)1 << c->log2_slots) - 1;
    int shift = 64 - c->log2_slots;
    for (;;) {
        pthread_mutex_lock(&c->lock);
        int64_t p = (c->next < c->n_paths && !c->err) ? c->next++ : -1;
        pthread_mutex_unlock(&c->lock);
        if (p < 0) return NULL;
        int64_t a = c->prefsum[p], b = c->prefsum[p + 1];
        int64_t* out = c->out_eids + c->out_pref[p];
        for (int64_t k = a; k + 1 < b; k++) {
            uint64_t key = edge_canonical_key(
                c->ids[k], c->orient[k], c->ids[k + 1], c->orient[k + 1]);
            uint64_t eid = edge_hash_get(c->slots, mask, shift, key);
            if (!eid) {
                pthread_mutex_lock(&c->lock);
                if (!c->err) c->err = -(k + 1);
                pthread_mutex_unlock(&c->lock);
                return NULL;
            }
            *out++ = (int64_t)eid;
        }
    }
}

/* Returns 0 on success, or -(pair_token_idx+1) of the first unknown edge. */
EXPORT int64_t pt_lookup_edges(
    const int64_t* ids, const uint8_t* orient,
    const int64_t* prefsum, int64_t n_paths,
    const uint64_t* slots, int32_t log2_slots,
    int64_t* out_eids, const int64_t* out_pref, int32_t n_threads)
{
    edge_ctx c = {
        ids, orient, prefsum, n_paths, slots, log2_slots,
        out_eids, out_pref, 0, 0, PTHREAD_MUTEX_INITIALIZER,
    };
    if (n_threads > (int32_t)n_paths) n_threads = (int32_t)n_paths;
    if (n_threads < 1) n_threads = 1;
    if (n_threads == 1) {
        edge_worker(&c);
        return c.err;
    }
    pthread_t tids[64];
    if (n_threads > 64) n_threads = 64;
    int spawned = 0;
    for (int t = 0; t < n_threads - 1; t++) {
        if (pthread_create(&tids[t], NULL, edge_worker, &c) == 0) spawned++;
        else break;
    }
    edge_worker(&c);
    for (int t = 0; t < spawned; t++) pthread_join(tids[t], NULL);
    return c.err;
}

/* Sorted-name-table binary search; returns the node id or -1. */
static inline int64_t name_to_id(
    const int64_t* sorted_vals, const int64_t* sorted_ids,
    int64_t n_sorted, int64_t val)
{
    int64_t lo = 0, hi = n_sorted;
    while (lo < hi) {
        int64_t mid = (lo + hi) >> 1;
        if (sorted_vals[mid] < val) lo = mid + 1;
        else hi = mid;
    }
    if (lo >= n_sorted || sorted_vals[lo] != val) return -1;
    return sorted_ids[lo];
}

/* ---- L-line edge indexer ---------------------------------------------------
 *
 * One pass over all L lines: parse `L\tu\t{+-}\tv\t{+-}\t...`, map integer
 * node names to ids (mode 1 identity / mode 2 sorted-table binary search),
 * canonicalize (reference: Edge::canonical src/graph_broker/graph.rs:142-148),
 * and dedupe through the open-addressing hash table while assigning edge ids
 * in first-occurrence order (reference inserts into edge2id the same way,
 * graph.rs:276-306). Replaces parse + np.unique + argsort host passes and
 * leaves the lookup hash table ready for the path itemizer.
 *
 * slots (interleaved key/eid pairs) must be zeroed,
 * n_slots = 1 << log2_slots > 2*n_lines.
 * edges_* have capacity n_lines; degree has n_items+1 zeroed entries.
 * Returns the unique-edge count, or -(line_idx+1) on a malformed line or
 * unknown node name.
 */
EXPORT int64_t pt_index_edges(
    const uint8_t* buf,
    const int64_t* starts, const int64_t* ends, int64_t n_lines,
    int32_t mode, int64_t n_items,
    const int64_t* sorted_vals, const int64_t* sorted_ids, int64_t n_sorted,
    uint64_t* slots, int32_t log2_slots,
    int64_t* edges_u, uint8_t* edges_o1,
    int64_t* edges_v, uint8_t* edges_o2,
    uint32_t* degree,
    const int64_t* nh_slots, int32_t nh_log2,
    const int64_t* nh_starts, const int64_t* nh_ends)
{
    uint64_t mask = ((uint64_t)1 << log2_slots) - 1;
    int shift = 64 - log2_slots;
    int64_t n_unique = 0;
    /* parse a batch of lines, prefetch each key's home slot, then insert:
     * the insert probe is one random line into a table far larger than
     * LLC, so without prefetch every line stalls the full miss latency
     * (the former per-line loop spent most of its time there) */
    enum { EIDX_BATCH = 64 };
    uint64_t keys[EIDX_BATCH];
    int64_t k = 0;
    while (k < n_lines) {
        int64_t bn = n_lines - k;
        if (bn > EIDX_BATCH) bn = EIDX_BATCH;
        for (int64_t j = 0; j < bn; j++) {
            int64_t i = starts[k + j], e = ends[k + j];
            if (i + 1 >= e || buf[i] != 'L' || buf[i + 1] != '\t')
                return -(k + j + 1);
            i += 2;
            int64_t u, v;
            uint8_t o1, o2;
            if (mode == 3) {
                /* string names: span to the next tab, resolve through the
                 * S-line name hash */
                int64_t us = i;
                while (i < e && buf[i] != '\t') i++;
                if (i == us || i + 1 >= e) return -(k + j + 1);
                u = name_hash_find(
                    buf, nh_slots, nh_log2, nh_starts, nh_ends,
                    buf + us, i - us);
                if (!u) return -(k + j + 1);
                i++;
                if (buf[i] == '+') o1 = 0;
                else if (buf[i] == '-') o1 = 1;
                else return -(k + j + 1);
                i++;
                if (i >= e || buf[i] != '\t') return -(k + j + 1);
                i++;
                int64_t vs = i;
                while (i < e && buf[i] != '\t') i++;
                if (i == vs || i + 1 >= e) return -(k + j + 1);
                v = name_hash_find(
                    buf, nh_slots, nh_log2, nh_starts, nh_ends,
                    buf + vs, i - vs);
                if (!v) return -(k + j + 1);
                i++;
                if (buf[i] == '+') o2 = 0;
                else if (buf[i] == '-') o2 = 1;
                else return -(k + j + 1);
            } else {
            int64_t uv = 0, vv = 0;
            int any = 0;
            while (i < e && buf[i] >= '0' && buf[i] <= '9') {
                uv = uv * 10 + (buf[i] - '0');
                any = 1;
                i++;
            }
            if (!any || i + 1 >= e || buf[i] != '\t') return -(k + j + 1);
            if (buf[i + 1] == '+') o1 = 0;
            else if (buf[i + 1] == '-') o1 = 1;
            else return -(k + j + 1);
            i += 2;
            if (i >= e || buf[i] != '\t') return -(k + j + 1);
            i++;
            any = 0;
            while (i < e && buf[i] >= '0' && buf[i] <= '9') {
                vv = vv * 10 + (buf[i] - '0');
                any = 1;
                i++;
            }
            if (!any || i + 1 >= e || buf[i] != '\t') return -(k + j + 1);
            if (buf[i + 1] == '+') o2 = 0;
            else if (buf[i + 1] == '-') o2 = 1;
            else return -(k + j + 1);

            if (mode == 1) {
                if (uv < 1 || uv > n_items || vv < 1 || vv > n_items)
                    return -(k + j + 1);
                u = uv;
                v = vv;
            } else {
                u = name_to_id(sorted_vals, sorted_ids, n_sorted, uv);
                v = name_to_id(sorted_vals, sorted_ids, n_sorted, vv);
                if (u < 0 || v < 0) return -(k + j + 1);
            }
            }

            uint64_t key = edge_canonical_key(u, o1, v, o2);
            keys[j] = key;
            __builtin_prefetch(
                &slots[2 * ((key * EDGE_HASH_MUL) >> shift)], 1, 1);
        }
        for (int64_t j = 0; j < bn; j++) {
            uint64_t key = keys[j];
            uint64_t s = (key * EDGE_HASH_MUL) >> shift;
            uint64_t sk;
            while ((sk = slots[2 * s]) != 0 && sk != key)
                s = (s + 1) & mask;
            if (sk == 0) {
                slots[2 * s] = key;
                slots[2 * s + 1] = (uint64_t)++n_unique;
                uint64_t cu = key >> 33;
                uint64_t cv = (key >> 2) & ((1ull << 31) - 1);
                edges_u[n_unique - 1] = (int64_t)cu;
                edges_o1[n_unique - 1] = (uint8_t)((key >> 1) & 1u);
                edges_v[n_unique - 1] = (int64_t)cv;
                edges_o2[n_unique - 1] = (uint8_t)(key & 1u);
                degree[cu]++;
                degree[cv]++;
            }
        }
        k += bn;
    }
    return n_unique;
}

/* Bulk canonical edge-id lookup for flat oriented pair arrays (the masked
 * itemizer path). Returns 0, or -(i+1) for the first unknown pair. */
EXPORT int64_t pt_lookup_pairs(
    const int64_t* u, const uint8_t* o1,
    const int64_t* v, const uint8_t* o2, int64_t n,
    const uint64_t* slots, int32_t log2_slots,
    int64_t* out_eids)
{
    uint64_t mask = ((uint64_t)1 << log2_slots) - 1;
    int shift = 64 - log2_slots;
    for (int64_t i = 0; i < n; i++) {
        uint64_t key = edge_canonical_key(u[i], o1[i], v[i], o2[i]);
        uint64_t eid = edge_hash_get(slots, mask, shift, key);
        if (!eid) return -(i + 1);
        out_eids[i] = (int64_t)eid;
    }
    return 0;
}

/* ---- CSR adjacency edge lookup --------------------------------------------
 *
 * The open-addressing hash above costs ~one random DRAM cache-line miss
 * per pair once the slot table outgrows the LLC (chr22-scale graphs:
 * 10^6-10^7 edges => 10^2-10^3 MB tables). Real pangenome paths walk
 * mostly-ascending node ids (pggb/smoothxg sort nodes along the genome),
 * so an adjacency layout keyed by the canonical SOURCE node turns the
 * probe stream into near-sequential reads: row offsets are indexed by an
 * ascending u, and each row's (packed dest key, eid) entries sit on the
 * same one or two cache lines as its neighbors'.
 *
 * Row entries are sorted by packed key (insertion sort at build; rows are
 * small — mean canonical out-degree is E/N, typically < 10); lookups scan
 * with sorted early-exit, switching to binary search for hub rows.
 */

/* Build: row_off must have n_items + 2 zeroed entries. Fills
 * adj_ent[n_edges] = (vkey << 32) | eid where vkey = (v << 2) |
 * (o1 << 1) | o2 and eid is the first-occurrence id (1-based == index+1
 * of the edges arrays): one interleaved uint64 per entry, so a row scan
 * touches one cache line per 8 entries. Caller must guarantee
 * v < 2^29 and n_edges < 2^31 (checked Python-side; the open hash is
 * the general fallback). */
EXPORT void pt_build_edge_adj(
    const int64_t* eu, const uint8_t* eo1,
    const int64_t* ev, const uint8_t* eo2,
    int64_t n_edges, int64_t n_items,
    int64_t* row_off, uint64_t* adj_ent)
{
    for (int64_t i = 0; i < n_edges; i++) row_off[eu[i] + 1]++;
    for (int64_t u = 0; u <= n_items; u++) row_off[u + 1] += row_off[u];
    /* place (unsorted), using row_off[u+1] as the fill cursor */
    for (int64_t i = 0; i < n_edges; i++) {
        int64_t pos = row_off[eu[i]]++;
        uint64_t vkey =
            ((uint64_t)ev[i] << 2) | ((uint64_t)eo1[i] << 1) | eo2[i];
        adj_ent[pos] = (vkey << 32) | (uint64_t)(i + 1);
    }
    /* row_off[u] now ends row u; restore starts by shifting down */
    for (int64_t u = n_items; u > 0; u--) row_off[u] = row_off[u - 1];
    row_off[0] = 0;
    /* per-row insertion sort (entries sort by vkey since it occupies the
     * high bits and eids only break exact-duplicate ties, which the
     * indexer never emits) */
    for (int64_t u = 1; u <= n_items; u++) {
        int64_t a = row_off[u], b = row_off[u + 1];
        for (int64_t i = a + 1; i < b; i++) {
            uint64_t e = adj_ent[i];
            int64_t j = i - 1;
            while (j >= a && adj_ent[j] > e) {
                adj_ent[j + 1] = adj_ent[j];
                j--;
            }
            adj_ent[j + 1] = e;
        }
    }
}

/* Canonicalize the consecutive pair at token k into (cu, vkey) — the
 * adjacency row index and packed (v, o1, o2) search key. */
static inline void canon_pair(
    const int64_t* ids, const uint8_t* orient, int64_t k,
    int64_t* cu, uint64_t* vkey)
{
    /* branchless: the swap direction is ~50/50 data-dependent, so a
     * branch here mispredicts every other pair; ternaries compile to
     * cmov/select */
    int64_t u = ids[k], v = ids[k + 1];
    uint64_t o1 = orient[k], o2 = orient[k + 1];
    int swap = (u > v) | ((u == v) & (int)o1);
    int64_t lo = swap ? v : u;
    uint64_t hi = (uint64_t)(swap ? u : v);
    uint64_t p1 = swap ? (o2 ^ 1u) : o1;
    uint64_t p2 = swap ? (o1 ^ 1u) : o2;
    *cu = lo;
    *vkey = (hi << 2) | (p1 << 1) | p2;
}

/* Pairs per prefetch block: the row_off / adj_ent / membership-row
 * accesses are independent random DRAM reads, so staging them in blocks
 * converts a serial ~3-miss chain per pair into batched misses with full
 * memory-level parallelism (same idea as the L-line indexer's prefetched
 * hash inserts). */
#define ADJ_BLK 64

static inline int64_t edge_adj_get(
    const int64_t* row_off, const uint64_t* adj_ent,
    int64_t u, uint64_t vkey)
{
    int64_t a = row_off[u], b = row_off[u + 1];
    if (b - a <= 8) {
        /* full-scan OR with selects: the trip count is data-independent
         * and there is no value-dependent exit branch to mispredict
         * (rows are canonical-unique, so at most one entry matches) */
        int64_t e = 0;
        for (int64_t i = a; i < b; i++) {
            uint64_t ent = adj_ent[i];
            e |= (ent >> 32) == vkey ? (int64_t)(ent & 0xFFFFFFFFu) : 0;
        }
        return e;
    }
    if (b - a <= 32) {
        for (int64_t i = a; i < b; i++) {
            uint64_t k = adj_ent[i] >> 32;
            if (k == vkey) return (int64_t)(adj_ent[i] & 0xFFFFFFFFu);
            if (k > vkey) return 0;
        }
        return 0;
    }
    while (a < b) {
        int64_t mid = (a + b) >> 1;
        if ((adj_ent[mid] >> 32) < vkey) a = mid + 1;
        else b = mid;
    }
    return (a < row_off[u + 1] && (adj_ent[a] >> 32) == vkey)
        ? (int64_t)(adj_ent[a] & 0xFFFFFFFFu)
        : 0;
}

typedef struct {
    const int64_t* ids;
    const uint8_t* orient;
    const int64_t* prefsum;
    int64_t n_paths;
    const int64_t* row_off;
    const uint64_t* adj_ent;
    int64_t* out_eids;
    const int64_t* out_pref;
    int64_t err;
    int64_t next;
    pthread_mutex_t lock;
} adj_ctx;

static void* adj_worker(void* arg)
{
    adj_ctx* c = (adj_ctx*)arg;
    for (;;) {
        pthread_mutex_lock(&c->lock);
        int64_t p = (c->next < c->n_paths && !c->err) ? c->next++ : -1;
        pthread_mutex_unlock(&c->lock);
        if (p < 0) return NULL;
        int64_t a = c->prefsum[p], b = c->prefsum[p + 1];
        int64_t* out = c->out_eids + c->out_pref[p];
        int64_t cu_b[ADJ_BLK];
        uint64_t vk_b[ADJ_BLK];
        for (int64_t base = a; base + 1 < b; base += ADJ_BLK) {
            int64_t n = b - 1 - base;
            if (n > ADJ_BLK) n = ADJ_BLK;
            for (int64_t i = 0; i < n; i++) {
                canon_pair(c->ids, c->orient, base + i, &cu_b[i], &vk_b[i]);
                __builtin_prefetch(&c->row_off[cu_b[i]], 0, 1);
            }
            for (int64_t i = 0; i < n; i++)
                __builtin_prefetch(&c->adj_ent[c->row_off[cu_b[i]]], 0, 1);
            for (int64_t i = 0; i < n; i++) {
                int64_t eid = edge_adj_get(
                    c->row_off, c->adj_ent, cu_b[i], vk_b[i]);
                if (!eid) {
                    pthread_mutex_lock(&c->lock);
                    if (!c->err) c->err = -(base + i + 1);
                    pthread_mutex_unlock(&c->lock);
                    return NULL;
                }
                *out++ = eid;
            }
        }
    }
}

/* Returns 0 on success, or -(pair_token_idx+1) of the first unknown edge. */
EXPORT int64_t pt_lookup_edges_adj(
    const int64_t* ids, const uint8_t* orient,
    const int64_t* prefsum, int64_t n_paths,
    const int64_t* row_off, const uint64_t* adj_ent,
    int64_t* out_eids, const int64_t* out_pref, int32_t n_threads)
{
    adj_ctx c = {
        ids, orient, prefsum, n_paths, row_off, adj_ent,
        out_eids, out_pref, 0, 0, PTHREAD_MUTEX_INITIALIZER,
    };
    if (n_threads > (int32_t)n_paths) n_threads = (int32_t)n_paths;
    if (n_threads < 1) n_threads = 1;
    if (n_threads == 1) {
        adj_worker(&c);
        return c.err;
    }
    pthread_t tids[64];
    if (n_threads > 64) n_threads = 64;
    int spawned = 0;
    for (int t = 0; t < n_threads - 1; t++) {
        if (pthread_create(&tids[t], NULL, adj_worker, &c) == 0) spawned++;
        else break;
    }
    adj_worker(&c);
    for (int t = 0; t < spawned; t++) pthread_join(tids[t], NULL);
    return c.err;
}

/* Fused edge lookup + membership pack: one pass over a slab's node CSR
 * that canonicalizes each consecutive pair, resolves its edge id through
 * the CSR adjacency, and ORs the path's group bit straight into the edge
 * membership row — the edge-id array is never materialized (the streamed
 * -c all path previously wrote + re-read it across two extra passes).
 * Threaded: workers steal paths and OR into PRIVATE rows (thread 0 the
 * output row), merged after the join — bitwise OR is idempotent and
 * commutative, so the merge is exact and race-free.
 * Returns 0, or -(token_idx+1) for the first unknown edge. */

typedef struct {
    const int64_t* ids;
    const uint8_t* orient;
    const int64_t* prefsum;
    int64_t n_paths;
    const int64_t* gbit;
    const int64_t* row_off;
    const uint64_t* adj_ent;
    uint32_t* rows[8]; /* per-thread private rows; [0] = output */
    int64_t row_len;
    int64_t err;
    int64_t next;
    pthread_mutex_t lock;
} pack_ctx;

typedef struct {
    pack_ctx* c;
    int tid;
} pack_arg;

/* OR the canonical edge ids of consecutive pairs ids[a..b) into `row`
 * with `bit` (staged prefetch blocks). Returns 0, or -(token_idx+1) of
 * the first unknown pair. Shared by the standalone packer and the fused
 * tokenize+pack path. */
static int64_t pack_pairs_row(
    const int64_t* ids, const uint8_t* orient, int64_t a, int64_t b,
    uint32_t bit, uint32_t* row,
    const int64_t* row_off, const uint64_t* adj_ent)
{
    int64_t cu_b[ADJ_BLK];
    uint64_t vk_b[ADJ_BLK];
    int64_t eid_b[ADJ_BLK];
    for (int64_t base = a; base + 1 < b; base += ADJ_BLK) {
        int64_t n = b - 1 - base;
        if (n > ADJ_BLK) n = ADJ_BLK;
        for (int64_t i = 0; i < n; i++) {
            canon_pair(ids, orient, base + i, &cu_b[i], &vk_b[i]);
            __builtin_prefetch(&row_off[cu_b[i]], 0, 1);
        }
        for (int64_t i = 0; i < n; i++)
            __builtin_prefetch(&adj_ent[row_off[cu_b[i]]], 0, 1);
        for (int64_t i = 0; i < n; i++) {
            int64_t eid = edge_adj_get(row_off, adj_ent, cu_b[i], vk_b[i]);
            if (!eid) return -(base + i + 1);
            eid_b[i] = eid;
            __builtin_prefetch(&row[eid], 1, 1);
        }
        for (int64_t i = 0; i < n; i++) row[eid_b[i]] |= bit;
    }
    return 0;
}

/* OR item ids[a..b) into `row` with `bit` (node membership pack). */
static void pack_items_row(
    const int64_t* ids, int64_t a, int64_t b, uint32_t bit, uint32_t* row)
{
    int64_t k = a;
    for (; k + 16 < b; k++) {
        __builtin_prefetch(&row[ids[k + 16]], 1, 1);
        row[ids[k]] |= bit;
    }
    for (; k < b; k++) row[ids[k]] |= bit;
}

static void* pack_worker(void* argp)
{
    pack_arg* pa = (pack_arg*)argp;
    pack_ctx* c = pa->c;
    uint32_t* row = c->rows[pa->tid];
    for (;;) {
        pthread_mutex_lock(&c->lock);
        int64_t p = (c->next < c->n_paths && !c->err) ? c->next++ : -1;
        pthread_mutex_unlock(&c->lock);
        if (p < 0) return NULL;
        uint32_t bit = (uint32_t)1 << c->gbit[p];
        int64_t rc = pack_pairs_row(
            c->ids, c->orient, c->prefsum[p], c->prefsum[p + 1],
            bit, row, c->row_off, c->adj_ent);
        if (rc != 0) {
            pthread_mutex_lock(&c->lock);
            if (!c->err) c->err = rc;
            pthread_mutex_unlock(&c->lock);
            return NULL;
        }
    }
}

EXPORT int64_t pt_pack_edges_adj(
    const int64_t* ids, const uint8_t* orient,
    const int64_t* prefsum, int64_t n_paths,
    const int64_t* gbit,
    const int64_t* row_off, const uint64_t* adj_ent,
    uint32_t* edge_row, int64_t row_len, int32_t n_threads)
{
    pack_ctx c = {
        ids, orient, prefsum, n_paths, gbit, row_off, adj_ent,
        {edge_row}, row_len, 0, 0, PTHREAD_MUTEX_INITIALIZER,
    };
    if (n_threads > (int32_t)n_paths) n_threads = (int32_t)n_paths;
    if (n_threads < 1) n_threads = 1;
    if (n_threads > 8) n_threads = 8;
    pack_arg args[8];
    pthread_t tids[8];
    int spawned = 0;
    for (int t = 1; t < n_threads; t++) {
        c.rows[t] = (uint32_t*)calloc((size_t)row_len, sizeof(uint32_t));
        if (!c.rows[t]) break;
        args[t].c = &c;
        args[t].tid = t;
        if (pthread_create(&tids[t], NULL, pack_worker, &args[t]) != 0) {
            free(c.rows[t]);
            break;
        }
        spawned++;
    }
    pack_arg a0 = {&c, 0};
    pack_worker(&a0);
    for (int t = 1; t <= spawned; t++) {
        pthread_join(tids[t], NULL);
        for (int64_t i = 0; i < row_len; i++) edge_row[i] |= c.rows[t][i];
        free(c.rows[t]);
    }
    return c.err;
}

/* ---- membership-matrix builder --------------------------------------------
 *
 * OR the group bit of every (path, group) block's item ids into the packed
 * membership matrix M[n_words][n_items_pad] (the device-side core object).
 * Threads work-steal blocks; extra threads scatter into private zeroed
 * copies that are OR-merged at the end (bitwise OR is idempotent and
 * commutative, so private-copy merge is exact).
 * Threads own disjoint item-id (column) ranges and each walks every
 * (path, group) block, ORing only the ids that fall in its range: writes
 * are disjoint by construction, so no private copies, no merge pass, and
 * no extra memory — each thread re-reads the (shared, cached) items
 * array instead.
 */

typedef struct {
    const int64_t* items;
    const int64_t* prefsum;
    const int64_t* path_ids;
    const int64_t* group_idx;
    int64_t n_entries;
    uint32_t* M;
    int64_t n_words;
    int64_t n_items_pad;
    int32_t n_threads;
} memb_ctx;

typedef struct {
    memb_ctx* c;
    int tid;
} memb_arg;

static void* memb_worker(void* arg)
{
    memb_arg* a = (memb_arg*)arg;
    memb_ctx* c = a->c;
    int64_t chunk = (c->n_items_pad + c->n_threads - 1) / c->n_threads;
    int64_t col_lo = a->tid * chunk;
    int64_t col_hi = col_lo + chunk < c->n_items_pad
        ? col_lo + chunk : c->n_items_pad;
    for (int64_t e = 0; e < c->n_entries; e++) {
        int64_t p = c->path_ids[e];
        int64_t g = c->group_idx[e];
        uint32_t bit = (uint32_t)1 << (g & 31);
        uint32_t* row = c->M + (g >> 5) * c->n_items_pad;
        int64_t lo = c->prefsum[p], hi = c->prefsum[p + 1];
        for (int64_t k = lo; k < hi; k++) {
            int64_t id = c->items[k];
            if (id >= col_lo && id < col_hi) row[id] |= bit;
        }
    }
    return NULL;
}

/* M must be zeroed. Returns 0 (kept as a status code for the caller). */
EXPORT int64_t pt_build_membership(
    const int64_t* items, const int64_t* prefsum,
    const int64_t* path_ids, const int64_t* group_idx, int64_t n_entries,
    uint32_t* M, int64_t n_words, int64_t n_items_pad,
    int32_t n_threads)
{
    if (n_threads > (int32_t)n_entries) n_threads = (int32_t)n_entries;
    if (n_threads < 1) n_threads = 1;
    if (n_threads > 16) n_threads = 16; /* each thread re-reads items once */
    memb_ctx c = {
        items, prefsum, path_ids, group_idx, n_entries,
        M, n_words, n_items_pad, n_threads,
    };
    pthread_t tids[16];
    memb_arg args[16];
    int spawned = 0;
    for (int t = 1; t < n_threads; t++) {
        args[t].c = &c;
        args[t].tid = t;
        if (pthread_create(&tids[t], NULL, memb_worker, &args[t]) == 0)
            spawned = t;
        else {
            /* this thread's column range simply goes unwritten by it —
             * cover it from the main thread afterwards */
            break;
        }
    }
    memb_arg a0 = {&c, 0};
    memb_worker(&a0);
    for (int t = spawned + 1; t < n_threads; t++) {
        /* ranges of threads that failed to spawn */
        memb_arg af = {&c, t};
        memb_worker(&af);
    }
    for (int t = 1; t <= spawned; t++) pthread_join(tids[t], NULL);
    return 0;
}


/* ---- TSV table formatter ------------------------------------------------ */

typedef struct {
    const int64_t* vals;
    int64_t n, g;
    const uint8_t* names;
    int64_t name_w;
    uint8_t* out;
    int64_t row_cap;      /* fixed byte budget per row */
    int64_t* row_lens;    /* written length of each row */
    int32_t n_threads;
} fmt_ctx;

typedef struct { fmt_ctx* c; int32_t tid; } fmt_arg;

static inline uint8_t* fmt_i64(uint8_t* p, int64_t v)
{
    char tmp[20];
    int t = 0;
    if (v < 0) { *p++ = '-'; v = -v; }
    do { tmp[t++] = (char)('0' + (v % 10)); v /= 10; } while (v);
    while (t) *p++ = (uint8_t)tmp[--t];
    return p;
}

static void* fmt_worker(void* arg)
{
    fmt_arg* a = (fmt_arg*)arg;
    fmt_ctx* c = a->c;
    int64_t lo = c->n * a->tid / c->n_threads;
    int64_t hi = c->n * (a->tid + 1) / c->n_threads;
    for (int64_t i = lo; i < hi; i++) {
        uint8_t* p = c->out + i * c->row_cap;
        uint8_t* p0 = p;
        const uint8_t* nm = c->names + i * c->name_w;
        /* NUL bytes are padding anywhere in the fixed-width name cell
         * (composed names interleave NUL-padded blocks) — skip them */
        for (int64_t k = 0; k < c->name_w; k++)
            if (nm[k]) *p++ = nm[k];
        const int64_t* row = c->vals + i * c->g;
        for (int64_t j = 0; j < c->g; j++) {
            *p++ = '\t';
            p = fmt_i64(p, row[j]);
        }
        *p++ = '\n';
        c->row_lens[i] = p - p0;
    }
    return NULL;
}

/* Format n rows "name\tv0\t...\n" into out (row i staged at
 * out[i*row_cap], then compacted in place). row_cap must be
 * >= name_w + g*21 + 2. Returns total bytes written, or -1 on bad args. */
EXPORT int64_t pt_format_table(
    const int64_t* vals, int64_t n, int64_t g,
    const uint8_t* names, int64_t name_w,
    uint8_t* out, int64_t row_cap, int64_t* row_lens,
    int32_t n_threads)
{
    if (row_cap < name_w + g * 21 + 2) return -1;
    if (n == 0) return 0;
    if (n_threads < 1) n_threads = 1;
    if (n_threads > 16) n_threads = 16;
    if (n_threads > n) n_threads = n > 0 ? (int32_t)n : 1;
    fmt_ctx c = {vals, n, g, names, name_w, out, row_cap, row_lens, n_threads};
    pthread_t tids[16];
    fmt_arg args[16];
    int spawned = 0;
    for (int t = 1; t < n_threads; t++) {
        args[t].c = &c;
        args[t].tid = t;
        if (pthread_create(&tids[t], NULL, fmt_worker, &args[t]) == 0)
            spawned = t;
        else break;
    }
    fmt_arg a0 = {&c, 0};
    fmt_worker(&a0);
    for (int t = spawned + 1; t < c.n_threads; t++) {
        fmt_arg af = {&c, t};
        fmt_worker(&af);
    }
    for (int t = 1; t <= spawned; t++) pthread_join(tids[t], NULL);
    /* compact the fixed-slot rows in place; rows only move left */
    int64_t w = row_lens[0];
    for (int64_t i = 1; i < n; i++) {
        memmove(out + w, out + i * row_cap, (size_t)row_lens[i]);
        w += row_lens[i];
    }
    return w;
}
