"""Independent brute-force oracle for masked (BED subset/exclude) counting.

The production itemizer replicates the reference's interval-walking
semantics (reference: src/graph_broker/util.rs:569-721 and
abacus.rs:1187-1229) with a cursor-based walk, IntervalContainer interval
merging, and C acceleration. This oracle recomputes every masked quantity
from first principles — per-bp sets instead of interval arithmetic, plain
overlap tests instead of cursors — and diffs hist outputs across ~120
random (graph, BED) instances. The only reference quirks replicated at
event level (they are semantic, not implementation, choices):

  * a full-coverage event removes a node's partial-coverage record
    (util.rs:444-463 documents this as deliberately inexact);
  * the uncovered-bp subtraction uses the reference's exclude-overlap
    arithmetic (util.rs:265-300), applied here to intervals reconstructed
    from the oracle's per-bp sets.
"""

import numpy as np
import pytest

from panacus_jax.abacus import AbacusByTotal, path_order_groups
from panacus_jax.gfa import GraphStorage
from panacus_jax.itemize import itemize_paths
from panacus_jax.mask import GraphMask, GraphMaskParameters
from panacus_jax.utils import CountType

BIG = (1 << 63) - 1


# -- random instance generation -------------------------------------------------


def gen_instance(rng):
    n_nodes = int(rng.integers(3, 13))
    lens = rng.integers(1, 8, size=n_nodes + 1).astype(int)
    lens[0] = 0
    n_samples = int(rng.integers(1, 4))
    n_paths = int(rng.integers(2, 6))
    paths = []  # (name, sample, offset, [(nid, orient)])
    walk_flags = []
    for k in range(n_paths):
        sample = f"s{int(rng.integers(0, n_samples))}"
        n_visits = int(rng.integers(1, 11))
        visits = [
            (int(rng.integers(1, n_nodes + 1)), int(rng.integers(0, 2)))
            for _ in range(n_visits)
        ]
        bp = sum(lens[v] for v, _ in visits)
        # ~30% render as W lines — a walk's start/end fields always give
        # the PathSegment coords, so its span is (start, start+bp) even
        # at offset 0 (unlike an un-suffixed P name, whose span is open)
        walk = rng.random() < 0.3
        if walk or rng.random() < 0.25:
            off = int(rng.integers(0, 20))
            name = f"{sample}#1#p{k}:{off}-{off + bp}"
            offset = off
        else:
            name = f"{sample}#1#p{k}"
            offset = 0
        walk_flags.append(walk)
        paths.append((name, sample, offset, visits, bp))

    lines = ["H\tVN:Z:1.0"]
    for i in range(1, n_nodes + 1):
        lines.append(f"S\t{i}\t" + "A" * lens[i])
    edges = set()
    for _, _, _, visits, _ in paths:
        for (u, o1), (v, o2) in zip(visits, visits[1:]):
            edges.add((u, o1, v, o2))
    for u, o1, v, o2 in sorted(edges):
        lines.append(
            f"L\t{u}\t{'-' if o1 else '+'}\t{v}\t{'-' if o2 else '+'}\t0M"
        )
    for k, (name, sample, offset, visits, bp) in enumerate(paths):
        if walk_flags[k]:
            toks = "".join(f"{'<' if o else '>'}{v}" for v, o in visits)
            lines.append(
                f"W\t{sample}\t1\tp{k}\t{offset}\t{offset + bp}\t{toks}"
            )
        else:
            toks = ",".join(f"{v}{'-' if o else '+'}" for v, o in visits)
            lines.append(f"P\t{name}\t{toks}\t*")
    gfa_text = "\n".join(lines) + "\n"

    def gen_bed(p_any):
        rows = []
        for name, _, offset, visits, bp in paths:
            if rng.random() > p_any:
                continue
            base = name.split(":")[0]
            span = offset + bp + 3
            for _ in range(int(rng.integers(1, 4))):
                a = int(rng.integers(0, max(span, 1)))
                b = int(rng.integers(a + 1, span + 2))
                rows.append(f"{base}\t{a}\t{b}")
        return "\n".join(rows) + "\n" if rows else None

    include = gen_bed(0.7) if rng.random() < 0.75 else None
    exclude = gen_bed(0.5) if rng.random() < 0.55 else None
    if include is None and exclude is None:
        include = gen_bed(1.0)
    return gfa_text, include, exclude, (lens, paths, sorted(edges))


# -- oracle ----------------------------------------------------------------------


def merge_bed(bed_text):
    """BED rows -> {path_base: sorted disjoint merged intervals} via per-bp
    sets (independent of build_subpath_map's merge logic)."""
    if bed_text is None:
        return None
    per = {}
    order = []
    for row in bed_text.strip().splitlines():
        name, a, b = row.split("\t")
        if name not in per:
            order.append(name)
        per.setdefault(name, set()).update(range(int(a), int(b)))
    out = {}
    for name in order:
        out[name] = sets_to_intervals(per[name])
    return out


def sets_to_intervals(s):
    if not s:
        return []
    pos = sorted(s)
    res = []
    start = prev = pos[0]
    for x in pos[1:]:
        if x != prev + 1:
            res.append((start, prev + 1))
            start = x
        prev = x
    res.append((start, prev + 1))
    return res


def ref_total_coverage(cov_iv, exc_iv):
    """The reference's total_coverage arithmetic (src/util.rs:265-300),
    applied to oracle-reconstructed interval lists."""
    if not exc_iv:
        return sum(b - a for a, b in cov_iv)
    res = 0
    i = 0
    for start, end in cov_iv:
        while i < len(exc_iv) and exc_iv[i][1] <= start:
            i += 1
        if i < len(exc_iv) and exc_iv[i][0] < end:
            res += min(exc_iv[i][0] - 1, end) - start
            if exc_iv[i][1] < end:
                res += end - exc_iv[i][1] + 1
        else:
            res += end - start
    return res


def bed_exact_names(bed_text):
    """Full segment identities of BED rows ('base:a-b', or 'base' for
    name-only rows) — a row whose segment EQUALS a path's segment removes
    that path from the group ordering (reference get_path_order:
    abacus.rs:310-347 filters path_segments by set membership of the
    exclude list, coords included)."""
    if bed_text is None:
        return frozenset()
    out = set()
    for row in bed_text.strip().splitlines():
        f = row.split("\t")
        out.add(f[0] if len(f) < 3 else f"{f[0]}:{f[1]}-{f[2]}")
    return frozenset(out)


class Oracle:
    def __init__(self, model, include_map, exclude_map,
                 exclude_exact=frozenset()):
        self.lens, self.paths, self.edges = model
        self.include_map = include_map
        self.exclude_map = exclude_map
        self.exclude_exact = exclude_exact
        n_nodes = len(self.lens) - 1
        # canonical edge ids in L-line order (mirrors first-occurrence order
        # of the sorted edge list fed to the GFA)
        self.edge_id = {}
        for u, o1, v, o2 in self.edges:
            key = self.canonical(u, o1, v, o2)
            if key not in self.edge_id:
                self.edge_id[key] = len(self.edge_id) + 1
        self.n_nodes = n_nodes
        self.node_member = {}  # nid -> set(group)
        self.edge_member = {}  # eid -> set(group)
        self.covrec = {}  # nid -> set of covered node offsets
        self.exc_ann = {}  # nid -> set of excluded node offsets
        # the NODE-slot exclude table activates on ANY overlap
        # (ActiveTable.activate, no annotation); the BP-slot one only on a
        # full-coverage event (activate_n_annotate, util.rs:117-197)
        self.node_excluded_any = set()
        self.node_excluded_full = set()
        self.edge_excluded = set()
        self.paths_len = {}  # path name -> (n_push, bp)

    @staticmethod
    def canonical(u, o1, v, o2):
        if u > v or (u == v and o1 == 1):
            return (v, o2 ^ 1, u, o1 ^ 1)
        return (u, o1, v, o2)

    def group_order(self):
        """Reference path-order rule (abacus.rs:310-347): group blocks in
        first-mention order of the include list (or GFA order), paths of a
        group pulled together."""
        sample_of = {}
        base_of = {}
        for name, sample, _, _, _ in self.paths:
            base = name.split(":")[0]
            sample_of[base] = sample
            base_of.setdefault(base, name)
        if self.include_map is not None:
            mention = [b for b in self.include_map if b in sample_of]
        else:
            # exclude-only: a path whose FULL segment (incl. coords)
            # equals an exclude row drops out of the ordering, so its
            # group is only mentioned through its other paths
            mention = [
                name.split(":")[0]
                for name, *_ in self.paths
                if name not in self.exclude_exact
            ]
        groups = []
        path_order = []
        seen = set()
        for b in mention:
            g = sample_of[b]
            if g in seen:
                continue
            seen.add(g)
            groups.append(g)
            gi = len(groups) - 1
            for k, (name, sample, *_) in enumerate(self.paths):
                if sample == g:
                    path_order.append((k, gi))
        return path_order, groups

    def run(self):
        """Walk paths in GFA order (itemization event order) with group
        columns assigned by the group-block path order."""
        path_order, groups = self.group_order()
        group_of = dict(path_order)
        has_include = self.include_map is not None
        for k in range(len(self.paths)):
            name, sample, offset, visits, bp = self.paths[k]
            # paths whose group never appears in the include list keep their
            # exclusion events but contribute no membership column
            gi = group_of.get(k, -1)
            base = name.split(":")[0]
            inc = (
                self.include_map.get(base, [])
                if has_include
                else [(0, BIG)]
            )
            exc = (
                self.exclude_map.get(base, [])
                if self.exclude_map is not None
                else []
            )
            span = (offset, offset + bp if ":" in name else BIG)
            if has_include and not (
                self._overlaps_any(inc, span) or self._overlaps_any(exc, span)
            ):
                continue
            has_exclude = self.exclude_map is not None
            if (
                not has_include or self._contained_single(inc, span)
            ) and (not has_exclude or self._contained_single(exc, span)):
                # containment fast path (itemize fast branch / reference
                # full-subset path): plain membership, NO coverage events;
                # a fully-contained exclude list excludes every visited node
                for nid, _ in visits:
                    if gi >= 0:
                        self.node_member.setdefault(nid, set()).add(gi)
                    if exc:
                        self.node_excluded_any.add(nid)
                        self.node_excluded_full.add(nid)
                self._walk_edges(gi, offset, visits, inc, exc)
                continue
            self._walk(gi, offset, visits, inc, exc, name)
        return path_order, groups

    @staticmethod
    def _contained_single(ivs, span):
        s, e = span
        return any(a <= s and b >= e for a, b in ivs)

    @staticmethod
    def _overlaps_any(ivs, span):
        s, e = span
        return any(a < e and b > s for a, b in ivs)

    def _walk(self, gi, offset, visits, inc, exc, name):
        p = offset
        n_push = 0
        bp_push = 0
        # node/bp events
        for nid, o in visits:
            l = int(self.lens[nid])
            for s, e in inc:
                ov_s, ov_e = max(s, p), min(e, p + l)
                if ov_s >= ov_e:
                    continue
                a, b = ov_s - p, ov_e - p
                if o:
                    a, b = l - b, l - a
                if gi >= 0:
                    self.node_member.setdefault(nid, set()).add(gi)
                n_push += 1
                bp_push += b - a
                if b - a == l:
                    self.covrec.pop(nid, None)
                else:
                    self.covrec.setdefault(nid, set()).update(range(a, b))
            for s, e in exc:
                ov_s, ov_e = max(s, p), min(e, p + l)
                if ov_s >= ov_e:
                    continue
                a, b = ov_s - p, ov_e - p
                if o:
                    a, b = l - b, l - a
                self.node_excluded_any.add(nid)
                if b - a == l:
                    self.node_excluded_full.add(nid)
                    self.exc_ann.pop(nid, None)
                else:
                    ann = self.exc_ann.setdefault(nid, set())
                    ann.update(range(a, b))
                    if len(ann) == l:
                        # union reached full length: promote to excluded
                        # and clear the record (ActiveTable semantics,
                        # reference util.rs:117-197)
                        self.node_excluded_full.add(nid)
                        self.exc_ann.pop(nid, None)
            p += l
        prev = self.paths_len.get(name, (0, 0))
        self.paths_len[name] = (prev[0] + n_push, prev[1] + bp_push)
        self._walk_edges(gi, offset, visits, inc, exc)

    def _walk_edges(self, gi, offset, visits, inc, exc):
        # edge events: the edge between visit k and k+1 is included/excluded
        # when the SECOND node's bp span overlaps an interval
        # (reference: util.rs:723-795)
        p = offset + int(self.lens[visits[0][0]])
        for (u, o1), (v, o2) in zip(visits, visits[1:]):
            l = int(self.lens[v])
            eid = self.edge_id[self.canonical(u, o1, v, o2)]
            if gi >= 0 and self._overlaps_any(inc, (p, p + l)):
                self.edge_member.setdefault(eid, set()).add(gi)
            if exc and self._overlaps_any(exc, (p, p + l)):
                self.edge_excluded.add(eid)
            p += l

    def node_hist(self, n_groups):
        hist = np.zeros(n_groups + 1, dtype=np.int64)
        for nid in range(1, self.n_nodes + 1):
            c = (
                0
                if nid in self.node_excluded_any
                else len(self.node_member.get(nid, ()))
            )
            hist[c] += 1
        return hist

    def bp_hist(self, n_groups, has_include):
        hist = np.zeros(n_groups + 1, dtype=np.int64)
        for nid in range(1, self.n_nodes + 1):
            c = (
                0
                if nid in self.node_excluded_full
                else len(self.node_member.get(nid, ()))
            )
            hist[c] += int(self.lens[nid])
        if has_include:
            for nid, covered in self.covrec.items():
                if nid in self.node_excluded_full:
                    continue
                l = int(self.lens[nid])
                exc_iv = (
                    sets_to_intervals(self.exc_ann[nid])
                    if nid in self.exc_ann
                    else []
                )
                cov = ref_total_coverage(sets_to_intervals(covered), exc_iv)
                if cov <= l:
                    uncov = l - cov
                    c = (
                        0
                        if nid in self.node_excluded_full
                        else len(self.node_member.get(nid, ()))
                    )
                    hist[c] -= uncov
                    hist[0] += uncov
        return hist

    def edge_hist(self, n_groups):
        n_edges = len(self.edge_id)
        hist = np.zeros(n_groups + 1, dtype=np.int64)
        for eid in range(1, n_edges + 1):
            c = (
                0
                if eid in self.edge_excluded
                else len(self.edge_member.get(eid, ()))
            )
            hist[c] += 1
        return hist


# -- production driver -----------------------------------------------------------


def run_production(tmp_path, idx, gfa_text, include, exclude):
    gfa = tmp_path / f"g{idx}.gfa"
    gfa.write_text(gfa_text)
    kwargs = dict(groupby_sample=True)
    if include is not None:
        f = tmp_path / f"inc{idx}.bed"
        f.write_text(include)
        kwargs["positive_list"] = str(f)
    if exclude is not None:
        f = tmp_path / f"exc{idx}.bed"
        f.write_text(exclude)
        kwargs["negative_list"] = str(f)
    g = GraphStorage(str(gfa), index_edges=True)
    mask = GraphMask.from_datamgr(GraphMaskParameters(**kwargs), g)
    counts = [CountType.NODE, CountType.BP, CountType.EDGE]
    itemized = itemize_paths(g, mask, counts)
    path_order, groups = path_order_groups(mask, g.path_segments)
    abaci = {
        ct: AbacusByTotal.from_itemization(
            ct, i, itemized, path_order, groups, g
        )
        for i, ct in enumerate(counts)
    }
    return g, abaci, groups, itemized


# -- the property test -----------------------------------------------------------


@pytest.mark.parametrize("seed", range(12))
def test_masked_bp_oracle(tmp_path, seed):
    rng = np.random.default_rng(1000 + seed)
    for case in range(10):
        gfa_text, include, exclude, model = gen_instance(rng)
        g, abaci, groups, itemized = run_production(
            tmp_path, f"{seed}_{case}", gfa_text, include, exclude
        )
        oracle = Oracle(
            model,
            merge_bed(include),
            merge_bed(exclude),
            bed_exact_names(exclude),
        )
        oracle.run()
        _, ogroups = oracle.group_order()
        ctx = f"seed={seed} case={case}\n{gfa_text}\ninc={include}\nexc={exclude}"
        assert groups == ogroups, ctx

        n_groups = len(groups)
        got_node = abaci[CountType.NODE].construct_hist()
        want_node = oracle.node_hist(n_groups)
        assert got_node.tolist() == want_node.tolist(), f"node hist\n{ctx}"

        got_bp = abaci[CountType.BP].construct_hist_bps()
        want_bp = oracle.bp_hist(n_groups, include is not None)
        assert got_bp.tolist() == want_bp.tolist(), f"bp hist\n{ctx}"

        got_edge = abaci[CountType.EDGE].construct_hist()
        want_edge = oracle.edge_hist(n_groups)
        assert got_edge.tolist() == want_edge.tolist(), f"edge hist\n{ctx}"


def test_exact_exclude_row_drops_path_from_ordering(tmp_path):
    """An exclude BED row whose segment EQUALS a path's full segment
    (base + coords — W lines always carry coords) removes that path from
    the group ordering (reference abacus.rs:310-347); a group whose only
    path is dropped loses its hist column entirely. Found by the round-4
    extended oracle sweep (seed 1046, case 4)."""
    gfa = tmp_path / "exact.gfa"
    gfa.write_text(
        "H\tVN:Z:1.0\n"
        "S\t1\tAAA\nS\t2\tAA\nS\t3\tAAAA\n"
        "L\t1\t+\t2\t+\t0M\nL\t2\t+\t3\t+\t0M\n"
        "P\ta#1#p0\t1+,2+\t*\n"
        "W\tb\t1\tp1\t2\t8\t>2>3\n"
    )
    bed = tmp_path / "exc.bed"
    # exactly the W path's (start, end) -> segment-equal -> dropped
    bed.write_text("b#1#p1\t2\t8\n")
    from panacus_jax.gfa import GraphStorage
    from panacus_jax.mask import GraphMask, GraphMaskParameters
    from panacus_jax.itemize import itemize_paths
    from panacus_jax.abacus import AbacusByTotal, path_order_groups
    from panacus_jax.utils import CountType

    g = GraphStorage(str(gfa), index_edges=True)
    mask = GraphMask.from_datamgr(
        GraphMaskParameters(groupby_sample=True, negative_list=str(bed)), g
    )
    itemized = itemize_paths(g, mask, [CountType.NODE])
    path_order, groups = path_order_groups(mask, g.path_segments)
    assert groups == ["a"], groups  # group b dropped with its only path
    ab = AbacusByTotal.from_itemization(
        CountType.NODE, 0, itemized, path_order, groups, g
    )
    # nodes 2 and 3 are excluded (covered by the excluded W path's rows);
    # only node 1 counts, under group a
    assert ab.construct_hist().tolist() == [2, 1]
