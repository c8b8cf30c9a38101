"""GraphBroker: graph-state orchestration between the task pipeline and the
counting engine (reference: src/graph_broker.rs:31-433).

Differences from the reference by design: one host itemization pass feeds
every abacus (the reference re-reads the GFA up to 3 times), and abaci keep
their membership matrices in device memory so analyses pull histograms /
scans / matmuls without re-parsing.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from .abacus import AbacusByGroup, AbacusByTotal, path_order_groups
from .gfa import GraphStorage, PathSegment
from .hist import Hist
from .itemize import itemize_paths
from .mask import GraphMask, GraphMaskParameters
from .utils import CountType

log = logging.getLogger("panacus")


def _process_count() -> int:
    try:
        import jax

        return jax.process_count()
    except Exception:  # pragma: no cover - backend init failure
        return 1


class Req:
    """Input requirement atoms (reference: src/analyses.rs:31-40)."""

    NODE = "node"
    EDGE = "edge"
    BP = "bp"
    PATH_LENS = "path_lens"
    HIST = "hist"

    @staticmethod
    def abacus_by_group(count: CountType) -> Tuple[str, CountType]:
        return ("abacus_by_group", count)

    @staticmethod
    def group_table(count: CountType) -> Tuple[str, CountType]:
        """Per-item multiplicity export (AbacusByGroup.sparse_counts): the
        only group-abacus consumer that reads per-path item runs — ordered
        growth and similarity run off the membership matrix. Multi-host
        uses this to keep the path-sliced build for everything else."""
        return ("group_table", count)

    @staticmethod
    def graph(path: str) -> Tuple[str, str]:
        return ("graph", path)


@dataclass
class GraphState:
    graph: str = ""
    name: Optional[str] = None
    subset: str = ""
    exclude: str = ""
    grouping: Optional[object] = None  # Grouping from config


class GraphBroker:
    def __init__(self):
        self.state: Optional[GraphState] = None
        self.graph_aux: Optional[GraphStorage] = None
        self.name = ""
        self.mask_params = GraphMaskParameters()
        self.mask: Optional[GraphMask] = None
        self.total_abaci: Optional[Dict[CountType, AbacusByTotal]] = None
        self.group_abacus: Optional[AbacusByGroup] = None
        self.hists: Optional[Dict[CountType, Hist]] = None
        self.path_lens: Optional[Dict[PathSegment, Tuple[int, int]]] = None
        self.gfa_file = ""
        self.nice = False
        self.input_requirements: Set = set()
        self.count_type = CountType.ALL

    # -- state-change protocol (reference: graph_broker.rs:96-147) ------------

    def change_graph_state(self, state: GraphState, reqs: Set, nice: bool) -> None:
        from .config import Grouping

        if self.state is not None:
            prev = self.state
            self.state = None
            graph_changed = prev.graph != state.graph
            if graph_changed:
                self._load_graph(reqs, nice)
            else:
                self.input_requirements = set(reqs)
            # on a graph reload the mask params reset, so re-apply the full
            # state (the reference only re-applies *changed* fields here and
            # silently drops an unchanged subset/exclude/grouping after a
            # graph switch, graph_broker.rs:102-121)
            if graph_changed or prev.subset != state.subset:
                self.mask_params.positive_list = state.subset
            if graph_changed or prev.exclude != state.exclude:
                self.mask_params.negative_list = state.exclude
            if graph_changed or prev.grouping != state.grouping:
                self.mask_params.groupby = ""
                self.mask_params.groupby_sample = False
                self.mask_params.groupby_haplotype = False
                self._apply_grouping(state.grouping)
        else:
            self._load_graph(reqs, nice)
            if state.subset:
                self.mask_params.positive_list = state.subset
            if state.exclude:
                self.mask_params.negative_list = state.exclude
            if state.grouping is not None:
                self._apply_grouping(state.grouping)
        self.name = (
            state.name if state.name is not None else self._default_run_name(state)
        )
        self.finish()
        self.state = state

    def change_order(self, order: str) -> None:
        # empty order means "keep GFA path order" (the reference would try to
        # open "" as a file here, lib.rs:282-289 + abacus.rs:75-77)
        self.mask_params.order = order if order else None
        self.finish()

    def _apply_grouping(self, grouping) -> None:
        from .config import Grouping

        if grouping is None:
            return
        if grouping.kind == "sample":
            self.mask_params.groupby_sample = True
        elif grouping.kind == "haplotype":
            self.mask_params.groupby_haplotype = True
        else:
            self.mask_params.groupby = grouping.file

    def _default_run_name(self, state: GraphState) -> str:
        if state.grouping is not None:
            return f"{state.graph}-{state.subset}-{state.grouping}"
        return f"{state.graph}-{state.subset}"

    def _load_graph(self, reqs: Set, nice: bool) -> None:
        count_type = self._derive_count_type(reqs)
        gfa_file = next(
            (r[1] for r in reqs if isinstance(r, tuple) and r[0] == "graph"),
            None,
        )
        if gfa_file is None:
            raise ValueError("Requirements contain gfa file")
        index_edges = count_type in (CountType.EDGE, CountType.ALL)
        self.graph_aux = GraphStorage(gfa_file, index_edges, nice)
        self.gfa_file = gfa_file
        self.nice = nice
        self.input_requirements = set(reqs)
        self.count_type = count_type
        self.mask_params = GraphMaskParameters()
        self.total_abaci = None
        self.group_abacus = None
        self.hists = None
        self.path_lens = None

    @staticmethod
    def _derive_count_type(reqs: Set) -> CountType:
        """(reference: graph_broker.rs:84-94, 149-160)"""
        have = {
            r
            for r in reqs
            if r in (Req.NODE, Req.EDGE, Req.BP)
        }
        if len(have) >= 2:
            return CountType.ALL
        if Req.NODE in have:
            return CountType.NODE
        if Req.BP in have:
            return CountType.BP
        if Req.EDGE in have:
            return CountType.EDGE
        return CountType.NODE

    # -- computation (reference: graph_broker.rs:227-247, 389-432) ------------

    def finish(self) -> None:
        self.mask = GraphMask.from_datamgr(self.mask_params, self.graph_aux)
        self._set_abaci_by_total()
        if Req.HIST in self.input_requirements:
            self._set_hists()
        group_reqs = [
            r
            for r in self.input_requirements
            if isinstance(r, tuple) and r[0] == "abacus_by_group"
        ]
        if len(group_reqs) > 1:
            raise ValueError(
                "panacus-jax currently supports a single AbacusByGroup count "
                "type per run"
            )
        for r in group_reqs:
            self._set_abacus_by_group(r[1])

    def _count_types(self) -> List[CountType]:
        if self.count_type == CountType.ALL:
            return [CountType.NODE, CountType.BP, CountType.EDGE]
        return [self.count_type]

    def _set_abaci_by_total(self) -> None:
        from .runtime import phase_timer

        count_types = self._count_types()
        log.info("calculating abaci for count_types: %s", count_types)
        from .stream import streamed_total_abaci

        with phase_timer("abaci_by_total"):
            streamed = None
            if _process_count() > 1:
                # multi-host: this process tokenizes only its word block;
                # M assembles sharded over the global mesh. Falls back to
                # redundant full itemization per host (still globally
                # sharded) for masked runs / group-table requirements.
                from .parallel.ingest import multihost_total_abaci

                need_itemized = any(
                    isinstance(r, tuple) and r[0] == "group_table"
                    for r in self.input_requirements
                )
                streamed = multihost_total_abaci(
                    self.graph_aux, self.mask, count_types, need_itemized
                )
            if streamed is None:
                streamed = streamed_total_abaci(
                    self.graph_aux, self.mask, count_types
                )
            if streamed is not None:
                abaci, itemized, path_order, groups = streamed
            else:
                with phase_timer("itemize_paths"):
                    itemized = itemize_paths(
                        self.graph_aux, self.mask, count_types
                    )
                path_order, groups = path_order_groups(
                    self.mask, self.graph_aux.path_segments
                )
                abaci = {}
                for slot, ct in enumerate(count_types):
                    with phase_timer(f"abacus_by_total[{ct}]"):
                        abaci[ct] = AbacusByTotal.from_itemization(
                            ct,
                            slot,
                            itemized,
                            path_order,
                            groups,
                            self.graph_aux,
                        )
        self._itemized = itemized
        self._itemized_counts = count_types
        self._path_order = path_order
        self._ordered_groups = groups
        self.total_abaci = abaci
        if Req.PATH_LENS in self.input_requirements:
            self.path_lens = itemized.paths_len

    def _set_hists(self) -> None:
        from .abacus import construct_hists

        self.hists = {
            ct: Hist(ct, [int(x) for x in h])
            for ct, h in construct_hists(self.total_abaci).items()
        }

    def _set_abacus_by_group(self, count: CountType) -> None:
        slot = self._itemized_counts.index(count)
        total = self.total_abaci.get(count)
        if total is not None:
            # ByTotal and ByGroup read the same membership matrix (same
            # itemization slot, exclude set and path order): share the
            # device-resident engine instead of rebuilding + re-uploading it
            self.group_abacus = AbacusByGroup(
                count,
                total.engine,
                total.groups,
                total.uncovered_bps,
                self.graph_aux,
                self._itemized,
                slot,
                self._path_order,
            )
            return
        self.group_abacus = AbacusByGroup.from_itemization(
            count,
            slot,
            self._itemized,
            self._path_order,
            self._ordered_groups,
            self.graph_aux,
        )

    # -- getters (reference: graph_broker.rs:249-343) -------------------------

    def get_run_name(self) -> str:
        return self.name

    def get_run_id(self) -> str:
        rid = self.name.lower()
        for ch in " _#/\"":
            rid = rid.replace(ch, "-")
        return rid

    def get_fname(self) -> str:
        return self.gfa_file

    def get_degree(self) -> np.ndarray:
        return self.graph_aux.degree

    def get_node_lens(self) -> np.ndarray:
        return self.graph_aux.node_lens

    def get_node_count(self) -> int:
        return self.graph_aux.node_count

    def get_edge_count(self) -> int:
        return self.graph_aux.edge_count

    def get_group_count(self) -> int:
        return self.mask.count_groups()

    def get_groups(self) -> Dict[PathSegment, str]:
        return self.mask.groups

    def get_path_lens(self) -> Dict[PathSegment, Tuple[int, int]]:
        return self.path_lens

    def get_hists(self) -> Dict[CountType, Hist]:
        return self.hists

    def get_abacus_by_total(self, count: CountType) -> AbacusByTotal:
        return self.total_abaci[count]

    def get_abacus_by_group(self) -> AbacusByGroup:
        return self.group_abacus
