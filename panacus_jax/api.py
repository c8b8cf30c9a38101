"""High-level Python API.

The reference is CLI-only; this module exposes the same capabilities as a
library surface for notebooks and pipelines:

    import panacus_jax.api as pt

    pg = pt.Pangenome("graph.gfa", grouping="sample")
    pg.histogram("node")                 # coverage histogram (np.ndarray)
    pg.growth("node", coverage="1", quorum="0.9")
    pg.info()                            # dict of graph/path/group stats
    pg.similarity("node")                # (matrix, labels)
    pg.ordered_growth("bp", order=None)  # per-group-position curve
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from .broker import GraphBroker, GraphState, Req
from .config import Grouping
from .utils import CountType, ThresholdContainer


class Pangenome:
    """One graph + mask state, lazily computing device-backed abaci."""

    def __init__(
        self,
        gfa_file: str,
        grouping: Optional[str] = None,
        subset: str = "",
        exclude: str = "",
        count: str = "all",
        nice: bool = False,
    ):
        g = None
        if grouping in ("sample", "Sample", "-S"):
            g = Grouping.sample()
        elif grouping in ("haplotype", "Haplotype", "-H"):
            g = Grouping.haplotype()
        elif grouping:
            g = Grouping.custom(grouping)
        ct = CountType.parse(count)
        reqs = {Req.graph(gfa_file), Req.HIST, Req.PATH_LENS}
        if ct in (CountType.NODE, CountType.ALL):
            reqs.add(Req.NODE)
        if ct in (CountType.BP, CountType.ALL):
            reqs.add(Req.BP)
        if ct in (CountType.EDGE, CountType.ALL):
            reqs.add(Req.EDGE)
        self._gb = GraphBroker()
        self._gb.change_graph_state(
            GraphState(
                graph=gfa_file,
                name=None,
                subset=subset,
                exclude=exclude,
                grouping=g,
            ),
            reqs,
            nice,
        )

    @property
    def broker(self) -> GraphBroker:
        return self._gb

    @property
    def groups(self) -> List[str]:
        return list(self._gb._ordered_groups)

    def histogram(self, count: str = "node") -> np.ndarray:
        """Coverage histogram: hist[c] = number of items (or bp) seen in
        exactly c path groups."""
        h = self._gb.get_hists()[CountType.parse(count)]
        return np.asarray(h.coverage)

    def coverage_vector(self, count: str = "node") -> np.ndarray:
        """Per-item group coverage (index 0 is the sentinel slot)."""
        ab = self._gb.get_abacus_by_total(CountType.parse(count))
        return ab.countable

    def growth(
        self,
        count: str = "node",
        coverage: str = "1",
        quorum: str = "0",
    ) -> np.ndarray:
        """Exact expected growth curve(s); rows = (coverage, quorum) pairs,
        columns = subset sizes 1..n_groups."""
        tc = ThresholdContainer.parse_params(quorum, coverage)
        h = self._gb.get_hists()[CountType.parse(count)]
        rows = [
            h.calc_growth(c, q) for c, q in zip(tc.coverage, tc.quorum)
        ]
        return np.asarray(rows)

    def ordered_growth(
        self,
        count: str = "node",
        coverage: str = "1",
        quorum: str = "0",
        order: Optional[str] = None,
    ) -> Tuple[np.ndarray, List[str]]:
        from .abacus import AbacusByGroup

        ct = CountType.parse(count)
        self._gb.input_requirements.add(Req.abacus_by_group(ct))
        if order is not None:
            self._gb.change_order(order)
        elif self._gb.group_abacus is None or self._gb.group_abacus.count != ct:
            self._gb._set_abacus_by_group(ct)
        ab = self._gb.get_abacus_by_group()
        tc = ThresholdContainer.parse_params(quorum, coverage)
        rows = [
            ab.calc_growth(c, q) for c, q in zip(tc.coverage, tc.quorum)
        ]
        return np.asarray(rows), list(ab.groups)

    def similarity(
        self, count: str = "node", cluster_method: str = "centroid"
    ) -> Tuple[np.ndarray, List[str]]:
        """Pairwise group Jaccard similarity, cluster-ordered."""
        from .analyses.similarity import Similarity
        from .config import AnalysisParameter

        ct = CountType.parse(count)
        self._gb.input_requirements.add(Req.abacus_by_group(ct))
        if self._gb.group_abacus is None or self._gb.group_abacus.count != ct:
            self._gb._set_abacus_by_group(ct)
        s = Similarity(
            AnalysisParameter(
                kind="similarity", count_type=ct, cluster_method=cluster_method
            )
        )
        s._set_table(self._gb)
        return np.asarray(s._table), list(s._labels)

    def info(self) -> Dict:
        from .analyses.info import _graph_info, _group_info, _path_info

        return {
            "graph": _graph_info(self._gb),
            "paths": _path_info(self._gb),
            "groups": _group_info(self._gb),
        }
