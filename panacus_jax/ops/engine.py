"""Device compute core: packed node-x-group membership bit matrix.

Device replacement of the reference's mutate-in-place coverage loop
(reference: src/graph_broker/abacus.rs:719-787). The central object is a
uint32 bit matrix M[n_words, n_items_pad] where bit (g % 32) of word
M[g // 32, i] says whether item i occurs in path group g. Because the host
feeds globally deduplicated (item, group) pairs, each pair touches a
distinct bit, so a plain scatter-add IS a scatter-OR — XLA handles it
natively without custom combiners.

Everything downstream is dense array math:
  coverage  = popcount-reduce over words     (== AbacusByTotal.countable)
  hist      = weighted bincount of coverage  (== construct_hist / _bps)
  ordered   = blocked cumulative scans       (== AbacusByGroup::calc_growth)
  similarity= blocked integer matmuls        (== Similarity::set_table)

The item axis is the sharding axis: every op here is either elementwise
over items or a reduction over items, so multi-chip execution shards
M's columns under shard_map (the sharded dispatch section below) and
merges the tiny per-shard partials on the host.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

from ..runtime import configure_jax

configure_jax()

import jax
import jax.numpy as jnp
import numpy as np

ORDERED_BLOCK = 1 << 14  # items per block in the scan kernels


def ordered_block_for(n_groups: int) -> int:
    """Item-block width for the ordered-growth scan. The body
    materializes several [n_groups, B] int32 temporaries (unpack, cumsum,
    cummax), so the block narrows as groups grow. Policy: B=1024 capped
    so G*B <= 2^21, floor 512; powers of two so B divides
    ITEM_ALIGN-padded item counts. On one H100 80GB HBM3 (700 W power
    limit) a pass at 90 groups x 901,120 items (B=1024) takes 9.0 ms of
    device time (scripts/hist_forms_probe.py); the policy has not been
    re-swept on the GPU (scripts/ordered_scale_probe.py does the sweep)."""
    b = 1024
    while b > 512 and n_groups * b > (1 << 21):
        b >>= 1
    return b
# pad item axis to a tile AND block boundary so blocked scans reshape evenly
ITEM_ALIGN = ORDERED_BLOCK
CHUNK = 1 << 20  # scatter chunk size (pairs per jit call)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def dedup_pairs(
    items: np.ndarray, groups: np.ndarray, n_groups: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Distinct (item, group) pairs — the semantic core of the reference's
    `last[sid] != group_id` dedup (abacus.rs:733-743). Host-side sort-unique;
    the native accelerator supersedes this for huge inputs."""
    if len(items) == 0:
        return items.astype(np.int64), groups.astype(np.int64)
    key = items.astype(np.int64) * np.int64(n_groups) + groups.astype(np.int64)
    uniq = np.unique(key)
    return uniq // n_groups, uniq % n_groups


@functools.partial(jax.jit, donate_argnums=(0,))
def _scatter_bits(M, words, items, bits):
    """Accumulate membership bits. The host pre-ORs bits per (item, word),
    so indices are unique and add == or."""
    return M.at[words, items].add(bits, mode="drop", unique_indices=True)


def pack_pairs(
    items: np.ndarray, groups: np.ndarray, n_words: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Reduce sorted dedup'd (item, group) pairs to unique (item, word, bits)
    scatter updates by OR-ing group bits per word host-side."""
    if len(items) == 0:
        z = np.zeros(0, np.int64)
        return z, z.copy(), np.zeros(0, np.uint32)
    words = (groups >> 5).astype(np.int64)
    bits = (np.uint32(1) << (groups & np.int64(31)).astype(np.uint32))
    key = items * np.int64(n_words) + words
    starts = np.empty(len(key), dtype=bool)
    starts[0] = True
    np.not_equal(key[1:], key[:-1], out=starts[1:])
    start_idx = np.flatnonzero(starts)
    orbits = np.bitwise_or.reduceat(bits, start_idx)
    return items[start_idx], words[start_idx], orbits


@jax.jit
def coverage_from_membership(M) -> jax.Array:
    """Popcount reduction over group words -> per-item group coverage."""
    return jnp.sum(
        jax.lax.population_count(M).astype(jnp.int32), axis=0, dtype=jnp.int32
    )


HIST_BLOCK = 4096  # items per private row of bins in the histogram scatter


def _hist_scatter(M, w, n_bins: int) -> jax.Array:
    """Weighted histogram of per-item coverage (reference:
    abacus.rs:746-787): popcount over the group words, then each block of
    HIST_BLOCK items scatter-adds its int32 weights into its own row of
    n_bins bins, and one sum over the rows. Private rows spread the
    scatter's atomics over blocks x bins instead of piling them onto the
    few bins real coverage hits. Exact while the total weight < 2^31.
    Items with zero weight (sentinel slot 0, padding) contribute nothing;
    coverage >= n_bins is dropped."""
    n = M.shape[1]
    cov = jnp.sum(
        jax.lax.population_count(M).astype(jnp.int32), axis=0, dtype=jnp.int32
    )
    row = jax.lax.iota(jnp.int32, n) // HIST_BLOCK
    part = jnp.zeros((-(-n // HIST_BLOCK), n_bins), dtype=jnp.int32)
    part = part.at[row, cov].add(w.astype(jnp.int32), mode="drop")
    return jnp.sum(part, axis=0, dtype=jnp.int32)


fused_hist_scatter = jax.jit(_hist_scatter, static_argnums=(2,))


def membership_from_pairs(
    n_words: int,
    n_items_pad: int,
    items: np.ndarray,
    groups: np.ndarray,
) -> jax.Array:
    """Build the packed membership matrix from dedup'd pairs, chunked so the
    scatter compiles once per chunk shape."""
    M = jnp.zeros((n_words, n_items_pad), dtype=jnp.uint32)
    u_items, u_words, u_bits = pack_pairs(items, groups, n_words)
    n = len(u_items)
    if n == 0:
        return M
    for a in range(0, n, CHUNK):
        b = min(a + CHUNK, n)
        k = b - a
        k_pad = CHUNK if k == CHUNK else min(_round_up(k, 1 << 14), CHUNK)
        it = np.zeros(k_pad, dtype=np.int32)
        wd = np.zeros(k_pad, dtype=np.int32)
        bt = np.zeros(k_pad, dtype=np.uint32)
        it[:k] = u_items[a:b]
        wd[:k] = u_words[a:b]
        bt[:k] = u_bits[a:b]
        M = _scatter_bits(M, jnp.asarray(wd), jnp.asarray(it), jnp.asarray(bt))
    return M


def _put_like(x: np.ndarray, M) -> jax.Array:
    """Commit a host array to M's device (M may be committed to a device
    other than the default one)."""
    devs = M.devices()
    if len(devs) == 1:
        return jax.device_put(x, next(iter(devs)))
    return jnp.asarray(x)


def unpack_block(M_block, n_groups: int) -> jax.Array:
    """[n_words, B] packed uint32 -> [n_groups, B] 0/1 int32 presence."""
    n_words, B = M_block.shape
    shifts = jnp.arange(32, dtype=jnp.uint32).reshape(1, 32, 1)
    P = (M_block.reshape(n_words, 1, B) >> shifts) & jnp.uint32(1)
    return P.reshape(n_words * 32, B)[:n_groups].astype(jnp.int32)


@functools.partial(jax.jit, static_argnums=(3, 4))
def _ordered_growth_all(M, weights, thr_table, c_min: int, n_blocks: int):
    """Single-dispatch ordered growth: lax.map over item blocks in one XLA
    program."""
    n_words, n_items_pad = M.shape
    B = n_items_pad // n_blocks
    Mb = M.reshape(n_words, n_blocks, B).transpose(1, 0, 2)
    Wb = weights.reshape(n_blocks, B)

    def body(args):
        mb, wb = args
        return _ordered_growth_block_body(mb, wb, thr_table, c_min)

    # [n_blocks, n_groups] int32 — summed on host in int64 (per-block
    # partials are < 2^31; the grand total may not be)
    return jax.lax.map(body, (Mb, Wb))


def _ordered_growth_block_body(M_block, weights_block, thr_table, c_min: int):
    """Ordered growth contribution of one item block
    (reference semantics: src/graph_broker/abacus.rs:988-1032).

    For each group position j (in path order): an item with total coverage
    >= c_min contributes its weight iff
        #present-groups<=j  >=  ceil((last-present-group-id<=j + 1) * quorum)
    thr_table[g+1] holds the host-precomputed ceil((g+1)*quorum); index 0
    (no present group yet) maps to a sentinel that never passes.
    int32 accumulation: per-block partials stay < 2^31 (blocks are 2^14
    items); the host accumulates across blocks in int64.
    """
    n_groups = thr_table.shape[0] - 1
    P = unpack_block(M_block, n_groups)  # [G, B]
    cum = jnp.cumsum(P, axis=0, dtype=jnp.int32)
    # thr_table[g+1] = ceil((g+1)*quorum) is NON-DECREASING in g, so the
    # threshold at the last present group <= j equals a running max of the
    # present positions' own thresholds: ONE cummax replaces both a
    # per-item [G,B] table gather and an unrolled select chain (O(G)
    # wheres). The lp == -1 "no present group yet" sentinel is redundant:
    # cum == 0 there and the cum >= 1 term already excludes it.
    tvals = thr_table[1 : n_groups + 1].reshape(-1, 1)
    thr = jax.lax.cummax(jnp.where(P > 0, tvals, -1), axis=0)
    total = cum[-1]
    ok = (cum >= thr) & (cum >= 1) & (total >= c_min).reshape(1, -1)
    return jnp.sum(
        ok.astype(jnp.int32) * weights_block.astype(jnp.int32).reshape(1, -1),
        axis=1,
    )


def ordered_growth(
    M: jax.Array,
    weights: np.ndarray,
    quorum_rel: float,
    c_min: int,
    n_groups: int,
) -> np.ndarray:
    """res[j] per ordered group position (== AbacusByGroup::calc_growth)."""
    n_items_pad = M.shape[1]
    thr = np.zeros(n_groups + 1, dtype=np.int32)
    thr[0] = np.iinfo(np.int32).max  # lp == -1 -> never passes
    for g in range(n_groups):
        thr[g + 1] = int(np.ceil((g + 1) * quorum_rel))
    w = np.zeros(n_items_pad, dtype=np.int32)
    w[: len(weights)] = weights
    mesh = item_mesh_of(M)
    if mesh is not None:
        from jax.sharding import PartitionSpec as P

        per = n_items_pad // mesh.devices.size
        fn = _sharded_ordered_fn(
            mesh, c_min, max(per // ordered_block_for(n_groups), 1)
        )
        partials = fn(
            M, _put_spec(mesh, w, P("items")), _put_spec(mesh, thr, P())
        )
        return fetch_parts(partials).astype(np.int64).sum(axis=0)
    n_blocks = max(n_items_pad // ordered_block_for(n_groups), 1)
    partials = _ordered_growth_all(
        M, _put_like(w, M), _put_like(thr, M), c_min, n_blocks
    )
    return np.asarray(partials).astype(np.int64).sum(axis=0)


# -- similarity ----------------------------------------------------------------

SIM_BLOCK = 1 << 13


@jax.jit
def _sim_block_int(M_block, weights_block):
    """Pairwise group intersection weights of one item block — integer-exact
    (== Similarity::set_table accumulation, similarity.rs:119-150).

    weights are < 2^16 (hi/lo split done by the caller), so per-block dot
    products stay < 2^31: int32 accumulation is exact. The GPU's tensor
    cores take no s32 operands, so XLA emits this product outside them."""
    n_groups = M_block.shape[0] * 32
    P = unpack_block(M_block, n_groups)  # [G, B] int32 0/1
    Pw = P * weights_block.astype(jnp.int32).reshape(1, -1)
    return jax.lax.dot_general(
        P,
        Pw,
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.int32,
    )


@functools.partial(jax.jit, static_argnums=(2,))
def _sim_all(M, weights, n_blocks: int):
    """Single-dispatch similarity: lax.scan over item blocks, int32-exact
    per block. The running sum is carried as two int32 planes (low/high
    16-bit halves of each block partial) so totals up to 2^47 stay exact
    without int64 support; recombined on the host."""
    n_words, n_items_pad = M.shape
    B = n_items_pad // n_blocks
    Mb = M.reshape(n_words, n_blocks, B).transpose(1, 0, 2)
    Wb = weights.reshape(n_blocks, B)
    g_pad = n_words * 32
    init = (
        jnp.zeros((g_pad, g_pad), jnp.int32),
        jnp.zeros((g_pad, g_pad), jnp.int32),
    )

    def step(carry, args):
        mb, wb = args
        p = _sim_block_int(mb, wb)
        lo, hi = carry
        return (lo + (p & 0xFFFF), hi + (p >> 16)), None

    (lo, hi), _ = jax.lax.scan(step, init, (Mb, Wb))
    return lo, hi


def similarity_intersections(
    M: jax.Array, weights: np.ndarray, n_groups: int
) -> np.ndarray:
    """[G, G] weighted co-occurrence counts, exact: weights split into
    16-bit halves, int32 device matmuls, int64 host accumulation."""
    n_items_pad = M.shape[1]
    w = np.zeros(n_items_pad, dtype=np.int64)
    w[: len(weights)] = np.asarray(weights).astype(np.int64)
    w_lo = (w & 0xFFFF).astype(np.int32)
    w_hi = (w >> 16).astype(np.int32)
    mesh = item_mesh_of(M)
    if mesh is not None:
        from jax.sharding import PartitionSpec as P

        per = n_items_pad // mesh.devices.size
        sim_fn = _sharded_sim_fn(mesh, max(per // SIM_BLOCK, 1))

        def run(wv):
            # [n_dev, G, G] planes
            lo, hi = sim_fn(M, _put_spec(mesh, np.asarray(wv), P("items")))
            return fetch_parts(lo).astype(np.int64).sum(axis=0) + (
                fetch_parts(hi).astype(np.int64).sum(axis=0) << 16
            )

    else:
        n_blocks = max(n_items_pad // SIM_BLOCK, 1)

        def run(wv):
            lo, hi = _sim_all(M, _put_like(wv, M), n_blocks)
            return np.asarray(lo).astype(np.int64) + (
                np.asarray(hi).astype(np.int64) << 16
            )

    total = run(w_lo)
    if w_hi.any():
        total = total + (run(w_hi) << 16)
    return total[:n_groups, :n_groups].astype(np.float64)


# -- sharded dispatch (multi-chip) ----------------------------------------------
#
# When M is placed item-sharded (NamedSharding over an "items" mesh axis),
# the blocked scan ops run under shard_map so each device scans ONLY its
# local item columns — no GSPMD-induced reshard of the item axis is even
# expressible. Every output is a tiny per-shard partial ([n_bins],
# [n_blocks, n_groups], [G, G] planes) concatenated along the shard axis
# and summed exactly on the host in int64: the hot loop needs ZERO
# cross-device collectives (tests/test_sharded_dispatch.py asserts the
# compiled HLO is collective-free).


def fetch_parts(x) -> np.ndarray:
    """Host copy of a (possibly cross-process sharded) device array. On a
    single host this is a plain transfer; under a multi-host mesh the
    per-shard partials live on non-addressable devices, so they are
    allgathered first (tiny arrays — O(n_bins) / O(n_groups^2), never M)."""
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils

        return np.asarray(multihost_utils.process_allgather(x, tiled=True))
    return np.asarray(x)


def _put_spec(mesh, x: np.ndarray, spec) -> jax.Array:
    """Commit a host array with an explicit PartitionSpec on the item mesh
    (required under multi-host: an uncommitted local array cannot feed a
    global-mesh program)."""
    from jax.sharding import NamedSharding

    return jax.device_put(x, NamedSharding(mesh, spec))


def item_mesh_of(M) -> Optional[object]:
    """The mesh M is item-sharded over, or None (single device / replicated /
    sharded on a different axis)."""
    s = getattr(M, "sharding", None)
    mesh = getattr(s, "mesh", None)
    spec = getattr(s, "spec", None)
    if mesh is None or spec is None:
        return None
    if "items" not in getattr(mesh, "axis_names", ()):
        return None
    if mesh.devices.size <= 1:
        return None
    if len(spec) < 2 or spec[1] != "items":
        return None
    return mesh


@functools.cache
def _sharded_hist_fn(mesh, n_bins: int):
    from jax.sharding import PartitionSpec as P

    def per_shard(m_local, w_local):
        return _hist_scatter(m_local, w_local, n_bins)[None]

    return jax.jit(
        jax.shard_map(
            per_shard,
            mesh=mesh,
            in_specs=(P(None, "items"), P("items")),
            out_specs=P("items"),
            check_vma=False,
        )
    )


def sharded_hist(M, w: np.ndarray, n_bins: int, mesh) -> np.ndarray:
    """[n_bins] int64 weighted coverage histogram; exact while the global
    total weight < 2^31 (per-shard totals are <= the global one)."""
    from jax.sharding import PartitionSpec as P

    parts = _sharded_hist_fn(mesh, n_bins)(
        M, _put_spec(mesh, np.asarray(w), P("items"))
    )
    return fetch_parts(parts).astype(np.int64).sum(axis=0)


@functools.cache
def _sharded_ordered_fn(mesh, c_min: int, n_blocks_local: int):
    from jax.sharding import PartitionSpec as P

    def per_shard(m_local, w_local, thr):
        return _ordered_growth_all(
            m_local, w_local, thr, c_min, n_blocks_local
        )

    return jax.jit(
        jax.shard_map(
            per_shard,
            mesh=mesh,
            in_specs=(P(None, "items"), P("items"), P()),
            out_specs=P("items"),
            check_vma=False,
        )
    )


@functools.cache
def _sharded_sim_fn(mesh, n_blocks_local: int):
    from jax.sharding import PartitionSpec as P

    def per_shard(m_local, w_local):
        lo, hi = _sim_all(m_local, w_local, n_blocks_local)
        return lo[None], hi[None]

    return jax.jit(
        jax.shard_map(
            per_shard,
            mesh=mesh,
            in_specs=(P(None, "items"), P("items")),
            out_specs=(P("items"), P("items")),
            check_vma=False,
        )
    )


# -- streaming build -----------------------------------------------------------


def _items_sharding():
    """NamedSharding over the item axis when >1 device is visible, else None."""
    devs = jax.devices()
    if len(devs) <= 1:
        return None
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    mesh = Mesh(np.array(devs), ("items",))
    return NamedSharding(mesh, P("items"))


def rows_on_host() -> bool:
    """Membership rows stay host numpy when M is unsharded on a CPU
    default device: an upload there is a same-memory copy, so streams keep
    rows as numpy and hand XLA:CPU the stacked matrix once."""
    return _items_sharding() is None and jax.devices()[0].platform == "cpu"


class MembershipStream:
    """Asynchronous membership-matrix builder: accepts one packed uint32 row
    per 32-group word as the host finishes tokenizing that word's paths, and
    uploads it immediately (jax.device_put is async — transfers ride under
    the host's tokenization of the next slab). `finalize()` stacks the rows
    into the engine's M with one dispatch.

    This is the overlap the blocking `build_from_host_matrix` upload lacked:
    by the time the last path slab is tokenized, every earlier word row is
    already resident in device memory, so the device tail is one row
    upload + the fused hist dispatch.

    Host placement (rows_on_host): rows stay numpy and finalize hands
    XLA:CPU the stacked matrix in one zero-copy device_put — per-row
    "transfers" would just be same-memory copies queued behind the
    tokenizer threads.
    """

    def __init__(self, n_items: int, n_groups: int):
        self.engine = CountingEngine(n_items, n_groups)
        self._rows: dict = {}
        self._sharding = _items_sharding()
        self._host_np = rows_on_host()
        self._M_host = None

    def _put(self, row: np.ndarray):
        if self._sharding is not None:
            return jax.device_put(row, self._sharding)
        return jax.device_put(row)

    def host_row(self, word: int):
        """Host-placed streams: a writable, already-zeroed view of the
        final matrix's row for `word` — packers fill it in place so
        finalize() never stacks/copies. None on device/sharded placement
        (those need per-row uploads)."""
        if not self._host_np:
            return None
        if self._M_host is None:
            self._M_host = np.zeros(
                (self.engine.n_words, self.engine.n_items_pad),
                dtype=np.uint32,
            )
        return self._M_host[word]

    def feed(self, word: int, row: np.ndarray) -> None:
        """row: uint32[n_items_pad] with this word's group bits (host-built).
        Issued asynchronously; do not mutate row afterwards."""
        assert 0 <= word < self.engine.n_words
        assert word not in self._rows, f"word {word} fed twice"
        self._rows[word] = row if self._host_np else self._put(row)

    def finalize(self) -> CountingEngine:
        if self._host_np:
            if self._M_host is not None:
                # rows were packed in place (host_row); copy in any row fed
                # from a foreign buffer, unfed words are already zero
                for w, r in self._rows.items():
                    if not np.shares_memory(r, self._M_host):
                        self._M_host[w] = r
                self.engine.M = self._put(self._M_host)
                return self.engine
            zrow = None
            rows = []
            for w in range(self.engine.n_words):
                r = self._rows.get(w)
                if r is None:
                    if zrow is None:
                        zrow = np.zeros(
                            self.engine.n_items_pad, dtype=np.uint32
                        )
                    r = zrow
                rows.append(r)
            Mh = (
                rows[0].reshape(1, -1)
                if len(rows) == 1
                else np.stack(rows)
            )
            self.engine.M = self._put(Mh)
            return self.engine
        zeros = None
        rows = []
        for w in range(self.engine.n_words):
            r = self._rows.get(w)
            if r is None:
                if zeros is None:
                    zeros = self._put(
                        np.zeros(self.engine.n_items_pad, dtype=np.uint32)
                    )
                r = zeros
            rows.append(r)
        if len(rows) == 1:
            M = rows[0].reshape(1, -1)
        else:
            M = jnp.stack(rows)
        if self._sharding is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P

            M = jax.device_put(
                M, NamedSharding(self._sharding.mesh, P(None, "items"))
            )
        self.engine.M = M
        return self.engine


# -- engine façade -------------------------------------------------------------


class CountingEngine:
    """Holds the membership matrix for one (graph, mask, count-type) state,
    on the default device, or item-sharded over every device when more
    than one is visible.

    items are 1-based dense ids (0 = sentinel, as reference abacus.rs:549-552);
    the matrix is padded to a tile-aligned item count.
    """

    def __init__(self, n_items: int, n_groups: int):
        self.n_items = n_items
        self.n_groups = n_groups
        self.n_words = max((n_groups + 31) // 32, 1)
        # multi-device: pad so every shard splits evenly into scan blocks
        # (ITEM_ALIGN is a multiple of ORDERED_BLOCK and SIM_BLOCK) — the
        # shard_map paths then never reshard
        n_dev = len(jax.devices())
        self.n_items_pad = _round_up(n_items + 1, ITEM_ALIGN * n_dev)
        self.M: Optional[jax.Array] = None
        self._ones = None  # cached device-resident all-ones weights

    def build(self, items: np.ndarray, groups: np.ndarray, dedup: bool = True):
        """items/groups: occurrence pairs (any order). Excluded items must be
        filtered by the caller."""
        if dedup:
            items, groups = dedup_pairs(items, groups, self.n_groups)
        self.M = membership_from_pairs(
            self.n_words, self.n_items_pad, items, groups
        )
        return self

    def build_from_host_matrix(self, M_host: np.ndarray):
        """Adopt a host-assembled packed membership matrix (one upload).

        With multiple devices visible, M is placed sharded over its item
        axis (NamedSharding) and every op runs shard-local under shard_map
        (see the sharded dispatch section)."""
        assert M_host.shape == (self.n_words, self.n_items_pad), (
            M_host.shape,
            (self.n_words, self.n_items_pad),
        )
        sharding = _items_sharding()
        if sharding is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P

            self.M = jax.device_put(
                M_host, NamedSharding(sharding.mesh, P(None, "items"))
            )
        else:
            self.M = jnp.asarray(M_host)
        return self

    def coverage(self) -> np.ndarray:
        """Per-item distinct-group count, length n_items + 1 (slot 0 sentinel)."""
        cov = fetch_parts(coverage_from_membership(self.M))
        return cov[: self.n_items + 1]

    def _m_device(self):
        """M's single device, or None (sharded / unbuilt)."""
        if self.M is None:
            return None
        devs = self.M.devices()
        return next(iter(devs)) if len(devs) == 1 else None

    def _w_np(self, w: "Optional[np.ndarray]") -> np.ndarray:
        """Full-length host weight vector (None = the implicit all-ones)."""
        if w is not None:
            return w
        wn = np.zeros(self.n_items_pad, dtype=np.int32)
        wn[1 : self.n_items + 1] = 1
        return wn

    def _ones_w(self):
        """Device-resident all-ones weights (sentinel + padding zeroed),
        built ON the device — the hot path never uploads a ones vector."""
        if self._ones is None:
            dev = self._m_device()

            def mk():
                i = jax.lax.iota(jnp.int32, self.n_items_pad)
                return ((i >= 1) & (i <= self.n_items)).astype(jnp.int32)

            if dev is not None:
                with jax.default_device(dev):
                    self._ones = jax.jit(mk)()
            else:
                self._ones = jax.jit(mk)()
        return self._ones

    def _w_dev(self, w: "Optional[np.ndarray]"):
        """Weights committed next to M (None = device-built ones)."""
        if w is None:
            return self._ones_w()
        dev = self._m_device()
        return jax.device_put(w, dev) if dev is not None else jnp.asarray(w)

    def hist(self, weights: "Optional[np.ndarray]" = None) -> np.ndarray:
        """Weighted coverage histogram of size n_groups + 1. weights must
        have length n_items + 1 with weights[0] == 0, or None for the
        unweighted (all-ones) histogram, which never leaves the device.

        One device path: the fused popcount + int32 scatter (shard-local
        under shard_map when M is item-sharded). Totals of 2^31 and more
        take the device popcount plus an exact host bincount."""
        if weights is None:
            w = None
            total_w = self.n_items
        else:
            w = np.zeros(self.n_items_pad, dtype=np.int32)
            w[: self.n_items + 1] = weights
            total_w = int(w.astype(np.int64).sum())
        n_bins = self.n_groups + 2
        mesh = item_mesh_of(self.M)
        if total_w >= (1 << 31):
            cov = fetch_parts(coverage_from_membership(self.M))
            assert total_w < (1 << 53)  # float64 bincount stays exact
            h = np.bincount(
                cov, weights=self._w_np(w).astype(np.float64), minlength=n_bins
            )
        elif mesh is not None:
            h = sharded_hist(self.M, self._w_np(w), n_bins, mesh)
        else:
            h = fused_hist_scatter(self.M, self._w_dev(w), n_bins)
        return np.asarray(h[: self.n_groups + 1]).astype(np.int64)

    def ordered_growth(
        self, weights: np.ndarray, quorum_rel: float, c_min: int
    ) -> np.ndarray:
        w = np.zeros(self.n_items_pad, dtype=np.int32)
        w[: self.n_items + 1] = weights
        return ordered_growth(self.M, w, quorum_rel, c_min, self.n_groups)

    def similarity(self, weights: np.ndarray) -> np.ndarray:
        w = np.zeros(self.n_items_pad, dtype=np.float32)
        w[: self.n_items + 1] = weights
        return similarity_intersections(self.M, w, self.n_groups)
