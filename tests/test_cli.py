"""End-to-end CLI behavior: output formats, fast paths, report round-trip."""

import json

import pytest

from panacus_jax.cli import run_cli


def run(capsys, args):
    rc = run_cli(args)
    out = capsys.readouterr().out
    return rc, out


def test_hist_table_format(capsys, t_groups_gfa):
    rc, out = run(capsys, ["hist", t_groups_gfa])
    lines = out.strip().split("\n")
    assert lines[0].startswith("# ")
    assert lines[1].startswith("# version ")
    assert lines[2] == "panacus\thist"
    assert lines[3] == "count\tnode"
    assert lines[4] == "\t"
    assert lines[5] == "\t"
    body = dict(l.split("\t") for l in lines[6:])
    assert body["0"] == "5"
    assert body["2"] == "10"
    assert body["6"] == "0"


# node hist of the reference's t_groups.gfa (15 nodes, 6 paths): five
# nodes in no path, ten in exactly two
T_GROUPS_HIST_TSV = (
    "panacus\thist\ncount\tnode\n\t\n\t\n"
    + "".join(f"{c}\t{n}\n" for c, n in enumerate([5, 0, 10, 0, 0, 0, 0]))
)


def test_growth_from_hist_tsv(capsys, tmp_path):
    hist_tsv = tmp_path / "t_groups.hist.tsv"
    hist_tsv.write_text(T_GROUPS_HIST_TSV)
    rc, out = run(capsys, ["growth", str(hist_tsv)])
    lines = [l for l in out.strip().split("\n") if not l.startswith("#")]
    assert lines[0] == "panacus\tgrowth"
    assert lines[1] == "count\tnode"
    assert lines[2] == "coverage\t1"
    assert lines[3] == "quorum\t0"
    assert lines[4] == "0\tNaN"
    vals = [l.split("\t")[1] for l in lines[5:]]
    assert vals == ["3", "6", "8", "9", "10", "10"]


def test_histgrowth_roundtrip(capsys, t_groups_gfa, tmp_path):
    """hist output is a valid growth input (reference lib.rs:144-174 path)."""
    rc, out = run(capsys, ["hist", t_groups_gfa])
    f = tmp_path / "h.tsv"
    f.write_text(out)
    rc, out2 = run(capsys, ["growth", str(f), "-q", "0.5", "-l", "1"])
    lines = [l for l in out2.strip().split("\n") if not l.startswith("#")]
    assert lines[0] == "panacus\tgrowth"
    assert len(lines) == 4 + 7  # header + rows 0..6


def test_report_json_render_roundtrip(capsys, t_groups_gfa, tmp_path):
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(
        f"""
- graph: {t_groups_gfa}
  name: demo
  grouping: Sample
  analyses:
    - !Hist
      count_type: Node
    - !Growth
      coverage: "1"
      quorum: "0"
"""
    )
    rc, out = run(capsys, ["report", "--json", str(cfg)])
    sections = json.loads(out)
    assert [s["analysis"] for s in sections] == [
        "Coverage Histogram",
        "Pangenome Growth",
    ]
    jf = tmp_path / "sections.json"
    jf.write_text(out)
    rc, html = run(capsys, ["render", str(jf)])
    assert html.startswith("<!DOCTYPE html>")
    assert "Coverage Histogram" in html
    assert "Pangenome Growth" in html
    # every chart spec embedded
    assert "data-spec" in html


def test_report_html_direct(capsys, t_groups_gfa, tmp_path):
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(
        f"- graph: {t_groups_gfa}\n  analyses:\n    - !Info\n"
    )
    rc, html = run(capsys, ["report", str(cfg)])
    assert "Pangenome Info" in html


def test_similarity_symmetry(capsys, chrm_gfa):
    rc, out = run(capsys, ["similarity", "-S", chrm_gfa])
    lines = [l for l in out.strip().split("\n") if not l.startswith("#")]
    header = lines[0].split("\t")
    assert header[0] == "group"
    labels = header[1:]
    assert sorted(labels) == ["HG00438", "HG00621", "chm13", "grch38"]
    rows = [l.split("\t") for l in lines[1:]]
    mat = {
        (r[0], labels[j]): float(v)
        for r in rows
        for j, v in enumerate(r[1:])
    }
    for a in labels:
        assert mat[(a, a)] == 1.0
        for b in labels:
            assert abs(mat[(a, b)] - mat[(b, a)]) < 1e-6


def test_table_total(capsys, t_groups_gfa):
    rc, out = run(capsys, ["table", "-a", "-S", t_groups_gfa])
    lines = [l for l in out.strip().split("\n") if not l.startswith("#")]
    assert lines[0] == "node\ttotal"
    totals = {l.split("\t")[0]: int(l.split("\t")[1]) for l in lines[1:]}
    # traversed nodes appear in both sample groups
    assert totals["1"] == 2
    assert totals["2"] == 0
    assert len(totals) == 15


def test_ordered_histgrowth_with_order_file(capsys, t_groups_gfa, tmp_path):
    order = tmp_path / "order.txt"
    order.write_text("x\ny#1\ny#2\ny#3\ny#4\ny#5\n")
    rc, out = run(
        capsys,
        ["ordered-histgrowth", "-c", "node", "-S", "-O", str(order), t_groups_gfa],
    )
    lines = [l for l in out.strip().split("\n") if not l.startswith("#")]
    # group order follows the order file: x before y
    assert lines[4].split("\t")[0] == "x"
    assert lines[5].split("\t")[0] == "y"
    assert lines[4].split("\t")[1] == "10"
    assert lines[5].split("\t")[1] == "10"


def test_node_distribution_output(capsys, t_groups_gfa):
    rc, out = run(capsys, ["node-distribution", t_groups_gfa])
    lines = out.strip().split("\n")
    assert lines[0] == "Bin\tCoverage\tLog-Length\tLog-Size"
    assert len(lines) > 1


def test_info_multiple_components(capsys, tmp_path):
    # two disconnected components: {1,2,3} (sizes 1,2,3bp) and {4,5}
    gfa = tmp_path / "two_comp.gfa"
    gfa.write_text(
        "H\tVN:Z:1.0\n"
        "S\t1\tA\nS\t2\tAC\nS\t3\tACG\nS\t4\tACGT\nS\t5\tACGTA\n"
        "L\t1\t+\t2\t+\t0M\n"
        "L\t2\t+\t3\t+\t0M\n"
        "L\t4\t+\t5\t+\t0M\n"
        "P\ta#0#x\t1+,2+,3+\t*\n"
        "P\tb#0#y\t4+,5+\t*\n"
    )
    run_cli(["info", str(gfa)])
    out = capsys.readouterr().out
    assert "graph\ttotal\tcomponent\t2" in out
    assert "graph\tlargest\tcomponent\t3" in out
    assert "graph\tsmallest\tcomponent\t2" in out
    # median of sorted [2, 3] -> 2.5
    assert "graph\tmedian\tcomponent\t2.5" in out


def test_render_merges_multiple_json_files(capsys, t_groups_gfa, tmp_path):
    """`render a.json b.json` concatenates sections into one report
    (reference: src/lib.rs:122-142, the checkpoint+merge mechanism)."""
    j1 = tmp_path / "a.json"
    j2 = tmp_path / "b.json"
    for jf, analysis in ((j1, "!Hist"), (j2, "!Info")):
        cfg = tmp_path / f"{jf.stem}.yaml"
        body = "      count_type: Node\n" if analysis == "!Hist" else ""
        cfg.write_text(
            f"- graph: {t_groups_gfa}\n  grouping: Sample\n"
            f"  analyses:\n    - {analysis}\n{body}"
        )
        rc, out = run(capsys, ["report", "--json", str(cfg)])
        assert rc == 0
        jf.write_text(out)
    rc, html = run(capsys, ["render", str(j1), str(j2)])
    assert rc == 0
    assert "Coverage Histogram" in html
    assert "Pangenome Info" in html


def test_report_dry_run_prints_plan_only(capsys, t_groups_gfa, tmp_path):
    """`report --dry-run` prints the task plan without computing
    (reference: src/lib.rs:180,213-217)."""
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(
        f"- graph: {t_groups_gfa}\n  analyses:\n    - !Hist\n"
        "      count_type: Node\n"
    )
    rc, out = run(capsys, ["report", "--dry-run", str(cfg)])
    assert rc == 0
    assert "Hist" in out
    assert "<!DOCTYPE html>" not in out
