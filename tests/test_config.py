"""YAML config schema parity (reference: src/analysis_parameter.rs:82-259,
example in src/commands/report.rs:55-68)."""

import pytest

from panacus_jax.config import AnalysisRun, Grouping, load_config
from panacus_jax.utils import CountType


def test_reference_readme_example():
    cfg = """
- graph: ../graphs/test_graph.gfa
  grouping: Haplotype
  analyses:
    - !Hist
      count_type: Bp
    - !Growth
      coverage: 1,1,2
      quorum: 0,0.9,0
"""
    runs = load_config(cfg)
    assert len(runs) == 1
    r = runs[0]
    assert r.graph == "../graphs/test_graph.gfa"
    assert r.grouping == Grouping.haplotype()
    assert [a.kind for a in r.analyses] == ["hist", "growth"]
    assert r.analyses[0].count_type == CountType.BP
    assert r.analyses[1].coverage == "1,1,2"
    assert r.analyses[1].quorum == "0,0.9,0"


def test_all_analysis_tags():
    cfg = """
- graph: g.gfa
  name: run1
  subset: inc.bed
  exclude: exc.bed
  nice: true
  analyses:
    - !Hist
    - !Growth
    - !Table
      total: true
    - !NodeDistribution
      radius: 12
    - !Info
    - !OrderedGrowth
      count_type: Bp
      order: o.txt
    - !CoverageLine
      count_type: Edge
      reference: chm13
    - !Similarity
      cluster_method: ward
    - !Custom
      name: extra
      file: x.png
"""
    runs = load_config(cfg)
    r = runs[0]
    assert r.nice is True
    assert r.subset == "inc.bed"
    kinds = [a.kind for a in r.analyses]
    assert kinds == [
        "hist",
        "growth",
        "table",
        "node_distribution",
        "info",
        "ordered_growth",
        "coverage_line",
        "similarity",
        "custom",
    ]
    assert r.analyses[2].total is True
    assert r.analyses[3].radius == 12
    assert r.analyses[5].count_type == CountType.BP
    assert r.analyses[5].order == "o.txt"
    assert r.analyses[6].reference == "chm13"
    assert r.analyses[7].cluster_method == "ward"
    assert r.analyses[8].name == "extra"


def test_custom_grouping_string():
    runs = load_config(
        "- graph: g.gfa\n  grouping: groups.tsv\n  analyses: [!Info ]\n"
    )
    assert runs[0].grouping == Grouping.custom("groups.tsv")


def test_bad_cluster_method():
    with pytest.raises(ValueError):
        load_config(
            "- graph: g\n  analyses:\n    - !Similarity\n      cluster_method: bogus\n"
        )


def test_task_conversion_order():
    from panacus_jax.pipeline import (
        AnalysisTask,
        GraphStateChange,
        OrderChange,
        convert_to_tasks,
    )

    runs = load_config(
        """
- graph: g.gfa
  analyses:
    - !OrderedGrowth
      order: o.txt
    - !Hist
"""
    )
    tasks = convert_to_tasks(runs)
    # GraphStateChange first; analyses sorted by kind rank (hist before
    # ordered_growth); OrderChange precedes its analysis
    assert isinstance(tasks[0], GraphStateChange)
    assert isinstance(tasks[1], AnalysisTask)
    assert tasks[1].analysis.get_type() == "Hist"
    assert isinstance(tasks[2], OrderChange)
    assert tasks[2].order == "o.txt"
    assert tasks[3].analysis.get_type() == "OrderedHistgrowth"


def test_cli_imports_without_pyyaml():
    """Only `report` reads YAML: the CLI module loads without PyYAML."""
    import subprocess
    import sys

    code = (
        "import sys; import panacus_jax.cli, panacus_jax.pipeline; "
        "print('yaml' in sys.modules)"
    )
    r = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=120
    )
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip() == "False"


def test_yaml_config_without_pyyaml_says_so(monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, "yaml", None)
    with pytest.raises(SystemExit, match="PyYAML"):
        load_config("- graph: g.gfa\n")
