"""YAML-only analyses: CoverageLine and Table through the report pipeline."""

import json

from panacus_jax.cli import run_cli


def test_coverage_line_yaml(capsys, t_groups_gfa, tmp_path):
    cfg = tmp_path / "c.yaml"
    cfg.write_text(
        f"""
- graph: {t_groups_gfa}
  analyses:
    - !CoverageLine
      count_type: Node
      reference: x
"""
    )
    run_cli(["report", "--json", str(cfg)])
    sections = json.loads(capsys.readouterr().out)
    assert sections[0]["analysis"] == "Coverage Line"
    (item,) = sections[0]["items"]
    line = item["Line"]
    assert line["log_x"] and line["log_y"]
    # t_groups hist [5,0,10,0,...]; coverage line drops index 0 and
    # trailing zeros -> [0, 10]
    assert line["y_values"] == [0.0, 10.0]
    # the table uses start index 1
    table = sections[0]["table"]
    assert "\n1\t0\n" in table


def test_table_yaml_total(capsys, t_groups_gfa, tmp_path):
    cfg = tmp_path / "t.yaml"
    cfg.write_text(
        f"""
- graph: {t_groups_gfa}
  grouping: Sample
  analyses:
    - !Table
      total: true
"""
    )
    run_cli(["report", "--json", str(cfg)])
    # Table contributes no report sections (reference table.rs:51-56)
    sections = json.loads(capsys.readouterr().out)
    assert sections == []


def test_multi_run_yaml(capsys, t_groups_gfa, chrm_gfa, tmp_path):
    """Two graphs in one config: broker state switches between runs."""
    cfg = tmp_path / "m.yaml"
    cfg.write_text(
        f"""
- graph: {t_groups_gfa}
  name: tg
  analyses:
    - !Hist
- graph: {chrm_gfa}
  name: chrm
  grouping: Sample
  analyses:
    - !Hist
"""
    )
    run_cli(["report", "--json", str(cfg)])
    sections = json.loads(capsys.readouterr().out)
    names = {s["run_name"] for s in sections}
    assert names == {"tg", "chrm"}
    by_run = {s["run_name"]: s for s in sections}
    chrm_vals = by_run["chrm"]["items"][0]["Bar"]["values"]
    assert chrm_vals == [0.0, 39.0, 29.0, 41.0, 45.0]


def test_ordered_growth_report_json_is_strict(capsys, t_groups_gfa, tmp_path):
    # json.dumps would happily emit bare NaN (invalid JSON) — the report
    # sections must stay strictly parseable (browsers' JSON.parse, and the
    # render merge path, reject NaN)
    cfg = tmp_path / "o.yaml"
    cfg.write_text(
        f"""
- graph: {t_groups_gfa}
  grouping: Sample
  analyses:
    - !OrderedGrowth
      count_type: Node
"""
    )
    run_cli(["report", "--json", str(cfg)])
    out = capsys.readouterr().out

    def no_const(x):
        raise AssertionError(f"non-finite constant {x} in report JSON")

    sections = json.loads(out, parse_constant=no_const)
    (item,) = sections[0]["items"]
    values = item["MultiBar"]["values"]
    # leading sentinel slot is zeroed (JS renderer skips index 0)
    assert values[0][0] == 0.0 and values[0][1:] == [10.0, 10.0]
