"""Independent first-principles oracle for the masked golden-grid cells.

The golden-grid TSVs under tests/golden/ are generated by this codebase
(scripts/gen_golden_grid.py) — they pin current behavior, not reference
behavior. This test backs every *masked* grid cell with an INDEPENDENT
recomputation on the real fixtures: a standalone pure-Python GFA parser
(no panacus_jax machinery) feeds the per-bp-set Oracle of
tests/test_bp_oracle.py, and the resulting node/bp/edge hists are diffed
against the golden TSV values directly. Unlike the randomized oracle test,
this also exercises name-only (whole-path) BED rows, which the random
generator never emits.

reference semantics under test: src/graph_broker/abacus.rs:384-473
(masked abacus), src/graph_broker/util.rs:723-795
(update_tables_edgecount), test/bed_chrM/* fixtures.
"""

import os

import pytest

from test_bp_oracle import BIG, Oracle

CHRM = "/root/reference/test/chrM_test.gfa"
BED = "/root/reference/test/bed_chrM"
GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")

pytestmark = pytest.mark.skipif(
    not os.path.exists(CHRM), reason="reference chrM fixture not mounted"
)


def parse_gfa_minimal(path):
    """Standalone S/L/P parser -> the Oracle's (lens, paths, edges) model.

    Deliberately naive (str.split per line) and independent of
    panacus_jax.gfa / native: node ids must be 1..n contiguous (true for
    the chrM fixture)."""
    lens = {}
    edges = []  # canonical first-occurrence order of L lines
    seen_edges = set()
    paths = []
    with open(path) as fh:
        for line in fh:
            if line.startswith("S\t"):
                _, nid, seq = line.rstrip("\n").split("\t")[:3]
                lens[int(nid)] = len(seq)
            elif line.startswith("L\t"):
                f = line.rstrip("\n").split("\t")
                u, o1 = int(f[1]), 0 if f[2] == "+" else 1
                v, o2 = int(f[3]), 0 if f[4] == "+" else 1
                key = Oracle.canonical(u, o1, v, o2)
                if key not in seen_edges:
                    seen_edges.add(key)
                    edges.append(key)
            elif line.startswith("P\t"):
                f = line.rstrip("\n").split("\t")
                name = f[1]
                visits = [
                    (int(tok[:-1]), 0 if tok[-1] == "+" else 1)
                    for tok in f[2].split(",")
                ]
                sample = name.split("#")[0]
                bp = sum(lens[v] for v, _ in visits)
                paths.append((name, sample, 0, visits, bp))
    n_nodes = max(lens)
    assert sorted(lens) == list(range(1, n_nodes + 1)), "ids not contiguous"
    lens_arr = [0] + [lens[i] for i in range(1, n_nodes + 1)]
    return lens_arr, paths, edges


def parse_bed(path):
    """BED rows -> {path_name: [intervals]}; a name-only row selects the
    whole path ((0, BIG)), mirroring the reference's bed1 handling."""
    out = {}
    with open(path) as fh:
        for row in fh:
            row = row.rstrip("\n")
            if not row:
                continue
            f = row.split("\t")
            iv = (int(f[1]), int(f[2])) if len(f) >= 3 else (0, BIG)
            out.setdefault(f[0], []).append(iv)
    # merge overlapping/adjacent intervals per path (sorted), matching the
    # oracle's expectation of disjoint sorted interval lists
    merged = {}
    for name, ivs in out.items():
        ivs.sort()
        acc = [list(ivs[0])]
        for a, b in ivs[1:]:
            if a <= acc[-1][1]:
                acc[-1][1] = max(acc[-1][1], b)
            else:
                acc.append([a, b])
        merged[name] = [tuple(x) for x in acc]
    return merged


def read_golden_hist(case_name):
    vals = []
    with open(os.path.join(GOLDEN_DIR, case_name + ".tsv")) as fh:
        for ln in fh:
            f = ln.rstrip("\n").split("\t")
            if len(f) == 2 and f[0].isdigit():
                assert int(f[0]) == len(vals)
                vals.append(int(f[1]))
    return vals


# (golden case, count, include bed, exclude bed) — exactly the masked
# cells of tests/golden_grid.py CASES
MASKED_CASES = [
    ("hist_subset_bed1_node", "node", "inclusion.bed1", None),
    ("hist_subset_bed1_bp", "bp", "inclusion.bed1", None),
    ("hist_subset_bed3_node", "node", "inclusion.bed3", None),
    ("hist_subset_sub_bed1_bp", "bp", "inclusion_sub.bed1", None),
    ("hist_exclude_bed3_node", "node", None, "exclusion.bed3"),
    ("hist_subset_exclude_bp", "bp", "inclusion.bed1", "exclusion.bed3"),
    ("hist_subset_chm13_edge", "edge", "inclusion_chm13.bed1", None),
]


@pytest.mark.parametrize(
    "case,count,inc,exc", MASKED_CASES, ids=[c[0] for c in MASKED_CASES]
)
def test_masked_grid_cell_oracle(case, count, inc, exc):
    model = parse_gfa_minimal(CHRM)
    include_map = parse_bed(os.path.join(BED, inc)) if inc else None
    exclude_map = parse_bed(os.path.join(BED, exc)) if exc else None
    oracle = Oracle(model, include_map, exclude_map)
    _, groups = oracle.run()
    n_groups = len(groups)
    if count == "node":
        got = oracle.node_hist(n_groups)
    elif count == "bp":
        got = oracle.bp_hist(n_groups, include_map is not None)
    else:
        got = oracle.edge_hist(n_groups)
    want = read_golden_hist(case)
    assert got.tolist() == want, (
        f"{case}: oracle {got.tolist()} vs golden {want}"
    )
