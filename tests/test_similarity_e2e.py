"""End-to-end similarity parity: CLI matrix vs an independent oracle.

The oracle re-derives weighted Jaccard directly from the GFA text with a
throwaway parser (no panacus_jax code on the oracle side), matching the
reference's accumulation semantics (src/analyses/similarity.rs:119-163):
per group, distinct items; intersections weighted by node length for bp,
by 1 for node.
"""

import numpy as np

from panacus_jax.cli import run_cli


def run(capsys, args):
    rc = run_cli(args)
    return rc, capsys.readouterr().out


def parse_gfa_groups(path):
    """(node_lens by name, {sample_group: set(node names)})."""
    node_lens = {}
    groups = {}
    with open(path) as f:
        for line in f:
            if line.startswith("S\t"):
                fields = line.rstrip("\n").split("\t")
                name, seq = fields[1], fields[2]
                if seq == "*":
                    # sequence elided: length must come from an LN:i: tag
                    ln = [x for x in fields[3:] if x.startswith("LN:i:")]
                    assert ln, f"S line {name} has '*' seq and no LN tag"
                    node_lens[name] = int(ln[0][5:])
                else:
                    node_lens[name] = len(seq)
            elif line.startswith("P\t"):
                parts = line.rstrip("\n").split("\t")
                sample = parts[1].split("#")[0]
                toks = parts[2].split(",")
                assert all(t[-1] in "+-" for t in toks), parts[2]
                nodes = {tok[:-1] for tok in toks}
                groups.setdefault(sample, set()).update(nodes)
            elif line.startswith("W\t"):
                parts = line.rstrip("\n").split("\t")
                sample = parts[1]
                walk = parts[6]
                nodes = set()
                cur = []
                for ch in walk:
                    if ch in "<>":
                        if cur:
                            nodes.add("".join(cur))
                            cur = []
                    else:
                        cur.append(ch)
                if cur:
                    nodes.add("".join(cur))
                groups.setdefault(sample, set()).update(nodes)
    return node_lens, groups


def oracle_jaccard(path, weighted):
    node_lens, groups = parse_gfa_groups(path)
    labels = sorted(groups)
    w = (lambda n: node_lens[n]) if weighted else (lambda n: 1)
    size = {g: sum(w(n) for n in groups[g]) for g in labels}
    table = {}
    for a in labels:
        for b in labels:
            inter = sum(w(n) for n in groups[a] & groups[b])
            table[(a, b)] = inter / (size[a] + size[b] - inter)
    return table


def parse_cli_matrix(out):
    lines = [l for l in out.strip().split("\n") if not l.startswith("#")]
    cols = lines[0].split("\t")[1:]
    table = {}
    for row in lines[1:]:
        parts = row.split("\t")
        for col, cell in zip(cols, parts[1:]):
            table[(parts[0], col)] = float(cell)
    return table


def check(capsys, gfa, count, weighted):
    rc, out = run(capsys, ["similarity", "-S", "-c", count, gfa])
    got = parse_cli_matrix(out)
    want = oracle_jaccard(gfa, weighted)
    assert set(got) == set(want)
    for k in want:
        # the writer prints f32 with up to ~7 significant digits
        assert abs(got[k] - want[k]) < 1e-5, (k, got[k], want[k])


def test_similarity_node_chrm(capsys, chrm_gfa):
    check(capsys, chrm_gfa, "node", weighted=False)


def test_similarity_bp_chrm(capsys, chrm_gfa):
    check(capsys, chrm_gfa, "bp", weighted=True)


def test_similarity_bp_t_groups(capsys, t_groups_gfa):
    check(capsys, t_groups_gfa, "bp", weighted=True)
