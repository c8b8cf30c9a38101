"""Broker state-change protocol: lazily recompute only what changed, and
re-apply masks after a graph switch (fixes a reference quirk where an
unchanged subset was silently dropped on graph change)."""

import json

from panacus_jax.cli import run_cli


def test_subset_survives_graph_switch(capsys, t_groups_gfa, chrm_gfa, tmp_path):
    sub = tmp_path / "sub.bed"
    sub.write_text("x\n")  # path 'x' exists only in t_groups
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(
        f"""
- graph: {chrm_gfa}
  name: a
  subset: {sub}
  grouping: Sample
  analyses:
    - !Hist
- graph: {t_groups_gfa}
  name: b
  subset: {sub}
  grouping: Sample
  analyses:
    - !Hist
"""
    )
    run_cli(["report", "--json", str(cfg)])
    sections = json.loads(capsys.readouterr().out)
    by_run = {s["run_name"]: s for s in sections}
    # run b: subset to path x -> all 10 traversed nodes have coverage 1
    vals = by_run["b"]["items"][0]["Bar"]["values"]
    assert vals == [5.0, 10.0]
    # run a: subset names no chrM path -> nothing covered
    vals_a = by_run["a"]["items"][0]["Bar"]["values"]
    assert vals_a[0] == 154.0


def test_same_graph_two_groupings(capsys, chrm_gfa, tmp_path):
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(
        f"""
- graph: {chrm_gfa}
  name: by-sample
  grouping: Sample
  analyses:
    - !Hist
- graph: {chrm_gfa}
  name: by-path
  analyses:
    - !Hist
"""
    )
    run_cli(["report", "--json", str(cfg)])
    sections = json.loads(capsys.readouterr().out)
    by_run = {s["run_name"]: s for s in sections}
    assert by_run["by-sample"]["items"][0]["Bar"]["values"] == [
        0.0,
        39.0,
        29.0,
        41.0,
        45.0,
    ]
    # ungrouped: one group per path, same histogram shape (4 paths)
    assert by_run["by-path"]["items"][0]["Bar"]["values"] == [
        0.0,
        39.0,
        29.0,
        41.0,
        45.0,
    ]
