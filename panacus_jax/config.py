"""Declarative analysis configuration: the YAML schema and task model.

Keeps the reference's serde-yaml schema verbatim
(reference: src/analysis_parameter.rs:82-259): a list of runs, each with
graph/name/subset/exclude/grouping/nice and a list of tagged analyses
(!Hist, !Growth, !Table, !NodeDistribution, !Info, !OrderedGrowth,
!CoverageLine, !Similarity, !Custom).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Set, Tuple

from .utils import CountType

CLUSTER_METHODS = (
    "single",
    "complete",
    "average",
    "weighted",
    "ward",
    "centroid",
    "median",
)


@dataclass(frozen=True)
class Grouping:
    """(reference: src/analysis_parameter.rs:203-218)"""

    kind: str  # 'sample' | 'haplotype' | 'custom'
    file: str = ""

    @classmethod
    def sample(cls) -> "Grouping":
        return cls("sample")

    @classmethod
    def haplotype(cls) -> "Grouping":
        return cls("haplotype")

    @classmethod
    def custom(cls, f: str) -> "Grouping":
        return cls("custom", f)

    def __str__(self) -> str:
        if self.kind == "sample":
            return "Group By Sample"
        if self.kind == "haplotype":
            return "Group By Haplotype"
        return f"Group By {self.file}"


@dataclass
class AnalysisParameter:
    """Tagged analysis parameter (reference: src/analysis_parameter.rs:154-201).

    kind: hist | growth | table | node_distribution | info | ordered_growth |
          coverage_line | similarity | custom
    """

    kind: str
    count_type: CountType = CountType.NODE
    coverage: Optional[str] = None
    quorum: Optional[str] = None
    add_hist: bool = False
    total: bool = False
    order: Optional[str] = None
    radius: int = 20
    reference: str = ""
    cluster_method: str = "centroid"
    name: str = ""
    file: str = ""

    # sort rank mirrors the enum variant order so task scheduling matches
    _RANK = {
        "hist": 0,
        "growth": 1,
        "table": 2,
        "node_distribution": 3,
        "info": 4,
        "ordered_growth": 5,
        "coverage_line": 6,
        "similarity": 7,
        "custom": 8,
    }

    def sort_key(self):
        return (
            self._RANK[self.kind],
            self.count_type.value,
            self.coverage or "",
            self.quorum or "",
        )


@dataclass
class AnalysisRun:
    """(reference: src/analysis_parameter.rs:82-115)"""

    graph: str
    name: Optional[str] = None
    subset: str = ""
    exclude: str = ""
    grouping: Optional[Grouping] = None
    nice: bool = False
    analyses: List[AnalysisParameter] = field(default_factory=list)

    def sort_key(self):
        return (
            self.graph,
            self.name or "",
            self.subset,
            self.exclude,
            str(self.grouping) if self.grouping else "",
            self.nice,
        )


# -- YAML loading --------------------------------------------------------------


def _parse_count_type(v: Any) -> CountType:
    if v is None:
        return CountType.NODE
    return CountType.parse(str(v))


def _parse_grouping(v: Any) -> Optional[Grouping]:
    if v is None:
        return None
    if isinstance(v, Grouping):
        return v
    if isinstance(v, str):
        s = v.strip()
        if s.lower() == "sample":
            return Grouping.sample()
        if s.lower() == "haplotype":
            return Grouping.haplotype()
        return Grouping.custom(s)
    if isinstance(v, dict) and "Custom" in v:
        return Grouping.custom(v["Custom"])
    raise ValueError(f"cannot parse grouping: {v!r}")


_TAG_TO_KIND = {
    "Hist": "hist",
    "Growth": "growth",
    "Table": "table",
    "NodeDistribution": "node_distribution",
    "Info": "info",
    "OrderedGrowth": "ordered_growth",
    "CoverageLine": "coverage_line",
    "Similarity": "similarity",
    "Custom": "custom",
}


def _analysis_from_mapping(tag: str, m: Dict[str, Any]) -> AnalysisParameter:
    kind = _TAG_TO_KIND.get(tag)
    if kind is None:
        raise ValueError(f"unknown analysis tag !{tag}")
    m = m or {}
    p = AnalysisParameter(kind=kind)
    if "count_type" in m:
        p.count_type = _parse_count_type(m["count_type"])
    p.coverage = (
        str(m["coverage"]) if m.get("coverage") is not None else None
    )
    p.quorum = str(m["quorum"]) if m.get("quorum") is not None else None
    p.add_hist = bool(m.get("add_hist", False))
    p.total = bool(m.get("total", False))
    p.order = m.get("order")
    p.radius = int(m.get("radius", 20))
    p.reference = str(m.get("reference", ""))
    cm = str(m.get("cluster_method", "centroid")).lower()
    if cm not in CLUSTER_METHODS:
        raise ValueError(f"unknown cluster method: {cm}")
    p.cluster_method = cm
    p.name = str(m.get("name", ""))
    p.file = str(m.get("file", ""))
    return p


def _config_loader():
    """A yaml SafeLoader that builds AnalysisParameters from the analysis
    tags. PyYAML is imported here, so only `report` needs it."""
    try:
        import yaml
    except ImportError:
        raise SystemExit(
            "reading a YAML config needs PyYAML: pip install pyyaml"
        ) from None

    class ConfigLoader(yaml.SafeLoader):
        pass

    def make_tag_constructor(tag: str):
        def construct(loader, node):
            m = {}
            if isinstance(node, yaml.MappingNode):
                m = loader.construct_mapping(node, deep=True)
            return _analysis_from_mapping(tag, m)

        return construct

    for tag in _TAG_TO_KIND:
        ConfigLoader.add_constructor(f"!{tag}", make_tag_constructor(tag))
    return yaml, ConfigLoader


def load_config(text: str) -> List[AnalysisRun]:
    yaml, loader = _config_loader()
    raw = yaml.load(text, Loader=loader)
    if raw is None:
        return []
    runs = []
    for entry in raw:
        analyses = []
        for a in entry.get("analyses", []) or []:
            if isinstance(a, AnalysisParameter):
                analyses.append(a)
            elif isinstance(a, dict) and len(a) == 1:
                tag, m = next(iter(a.items()))
                analyses.append(_analysis_from_mapping(tag, m or {}))
            else:
                raise ValueError(f"cannot parse analysis entry: {a!r}")
        runs.append(
            AnalysisRun(
                graph=str(entry["graph"]),
                name=entry.get("name"),
                subset=str(entry.get("subset", "") or ""),
                exclude=str(entry.get("exclude", "") or ""),
                grouping=_parse_grouping(entry.get("grouping")),
                nice=bool(entry.get("nice", False)),
                analyses=analyses,
            )
        )
    return runs


def load_config_file(path: str) -> List[AnalysisRun]:
    with open(path) as f:
        return load_config(f.read())
