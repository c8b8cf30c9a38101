"""Path grouping, subset/exclude coordinate lists, and path ordering.

Array-first re-design of the reference GraphMask
(reference: src/graph_broker/abacus.rs:23-474): outputs are dense arrays
(group id per path, interval lists per path id) consumed by the host
itemizer; no per-item hash maps survive to the compute path.
"""

from __future__ import annotations

import logging
import os
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from .gfa import GraphStorage, PathSegment
from .io_utils import parse_bed_to_path_segments, parse_groups
from .utils import ActiveTable, CountType, IntervalContainer

log = logging.getLogger("panacus")


@dataclass
class GraphMaskParameters:
    """(reference: src/graph_broker/abacus.rs:23-44)"""

    positive_list: str = ""
    negative_list: str = ""
    groupby: str = ""
    groupby_sample: bool = False
    groupby_haplotype: bool = False
    order: Optional[str] = None


class GraphMask:
    """Grouping + include/exclude + order state
    (reference: src/graph_broker/abacus.rs:46-150)."""

    def __init__(
        self,
        groups: Dict[PathSegment, str],
        include_coords: Optional[List[PathSegment]],
        exclude_coords: Optional[List[PathSegment]],
        order: Optional[List[PathSegment]],
    ):
        self.groups = groups
        self.include_coords = include_coords
        self.exclude_coords = exclude_coords
        self.order = order

    @classmethod
    def from_datamgr(
        cls, params: GraphMaskParameters, graph: GraphStorage
    ) -> "GraphMask":
        groups = cls.load_groups(
            params.groupby, params.groupby_haplotype, params.groupby_sample, graph
        )
        paths = graph.path_segments
        include_coords = cls.complement_with_group_assignments(
            cls.load_coord_list(params.positive_list, paths), groups
        )
        exclude_coords = cls.complement_with_group_assignments(
            cls.load_coord_list(params.negative_list, paths), groups
        )
        order = None
        if params.order is not None:
            maybe_order = cls.complement_with_group_assignments(
                cls.load_coord_list_file(params.order), groups
            )
            if maybe_order:
                o = maybe_order
                if include_coords is None:
                    exclude = set(exclude_coords) if exclude_coords else set()
                    all_included = [
                        x.clear_coords()
                        for x in graph.path_segments
                        if x not in exclude
                    ]
                else:
                    all_included = [x.clear_coords() for x in include_coords]
                order_set = set(o)
                for p in all_included:
                    if p not in order_set:
                        log.error(
                            "order list does not contain information about path %s", p
                        )
                # groups must not be interspersed in the order
                # (reference: abacus.rs:116-127)
                visited = set()
                cur = groups[o[0]]
                for p in o:
                    g = groups[p]
                    if cur != g:
                        if g in visited:
                            raise ValueError(
                                f"order of paths contains fragmented groups: path {p} "
                                "belongs to group that is interspersed by one or more "
                                "other groups"
                            )
                        visited.add(g)
                    cur = g
            order = maybe_order
        return cls(groups, include_coords, exclude_coords, order)

    @staticmethod
    def complement_with_group_assignments(
        coords: Optional[List[PathSegment]], groups: Dict[PathSegment, str]
    ) -> Optional[List[PathSegment]]:
        """Allow coord lists to name whole groups
        (reference: src/graph_broker/abacus.rs:152-201)."""
        if coords is None:
            return None
        group2paths: Dict[str, List[PathSegment]] = {}
        for p, g in groups.items():
            group2paths.setdefault(g, []).append(p)
        path_to_group = {ps.clear_coords(): g for ps, g in groups.items()}
        out: List[PathSegment] = []
        for p in coords:
            if p.clear_coords() in path_to_group:
                out.append(p)
            elif p.id() in group2paths:
                if p.coords() is not None:
                    raise ValueError(
                        f'invalid coordinate "{p}": group identifiers are not '
                        "allowed to have start/stop information!"
                    )
                paths = group2paths[p.id()]
                log.debug(
                    "complementing coordinate list with %d paths associated with "
                    "group %s",
                    len(paths),
                    p.id(),
                )
                out.extend(paths)
            else:
                log.error("unknown path/group %s", p)
        return out

    @staticmethod
    def load_coord_list_file(file_name: str) -> Optional[List[PathSegment]]:
        log.info("loading coordinates from %s", file_name)
        with open(file_name, "rb") as f:
            coords = parse_bed_to_path_segments(f, use_block_info=True)
        log.debug("loaded %d coordinates", len(coords))
        return coords

    @staticmethod
    def load_coord_list(
        coord_text: str, paths: List[PathSegment]
    ) -> Optional[List[PathSegment]]:
        """A path to a BED file, or a regex over path names
        (reference: src/graph_broker/abacus.rs:212-240)."""
        if not coord_text:
            return None
        if os.path.isfile(coord_text):
            return GraphMask.load_coord_list_file(coord_text)
        try:
            rex = re.compile(coord_text)
        except re.error:
            log.error(
                "string %s is not valid! Neither as a file name nor as a regex",
                coord_text,
            )
            raise ValueError("Invalid file name")
        log.info("filtering paths based on regex %s", coord_text)
        coords = [p for p in paths if rex.search(str(p))]
        if not coords:
            log.warning("filtering with regex did not find any paths!")
        return coords

    @staticmethod
    def load_groups(
        file_name: str,
        groupby_haplotype: bool,
        groupby_sample: bool,
        graph: GraphStorage,
    ) -> Dict[PathSegment, str]:
        """(reference: src/graph_broker/abacus.rs:242-308)"""
        if groupby_haplotype:
            return {
                x.clear_coords(): f"{x.sample}#{x.haplotype or ''}"
                for x in graph.path_segments
            }
        if groupby_sample:
            return {x.clear_coords(): x.sample for x in graph.path_segments}
        if file_name:
            log.info("loading groups from %s", file_name)
            with open(file_name, "rb") as f:
                assignments = parse_groups(f)
            path_to_group: Dict[PathSegment, str] = {}
            for i, (path, group) in enumerate(assignments):
                pnc = path.clear_coords()
                prev = path_to_group.get(pnc)
                if prev is not None:
                    if prev != group:
                        raise ValueError(
                            f"error in line {i}: path {pnc} cannot be assigned to "
                            "more than one group, but is assigned to at least two "
                            f"groups: {prev}, {group}"
                        )
                else:
                    path_to_group[pnc] = group
            log.debug("loaded %d group assignments", len(path_to_group))
            for x in graph.path_segments:
                path_to_group.setdefault(x.clear_coords(), x.id())
            return path_to_group
        log.info(
            "no explicit grouping instruction given, group paths by their IDs "
            "(sample ID+haplotype ID+seq ID)"
        )
        return {x.clear_coords(): x.id() for x in graph.path_segments}

    def get_path_order(
        self, path_segments: List[PathSegment]
    ) -> List[Tuple[int, str]]:
        """Map path indices to group identifiers, ordered by order > include >
        GFA-order-minus-excluded (reference: src/graph_broker/abacus.rs:310-347).
        """
        group_to_paths: Dict[str, List[Tuple[int, str]]] = {}
        for i, p in enumerate(path_segments):
            group = self.groups[p.clear_coords()]
            group_to_paths.setdefault(group, []).append((i, group))

        if self.order is not None:
            order = list(self.order)
        elif self.include_coords is not None:
            order = list(self.include_coords)
        else:
            exclude = set(self.exclude_coords) if self.exclude_coords else set()
            order = [x for x in path_segments if x not in exclude]

        out: List[Tuple[int, str]] = []
        for p in order:
            g = self.groups[p.clear_coords()]
            out.extend(group_to_paths.pop(g, []))
        return out

    def count_groups(self) -> int:
        return len(set(self.groups.values()))

    @staticmethod
    def build_subpath_map(
        path_segments: List[PathSegment],
    ) -> Dict[str, List[Tuple[int, int]]]:
        """Merge per-path-id coordinates into sorted non-overlapping intervals
        (reference: src/graph_broker/abacus.rs:354-382). Intervals are 0-based
        half-open; a segment without coords covers everything."""
        res: Dict[str, set] = {}
        for x in path_segments:
            c = x.coords()
            res.setdefault(x.id(), set()).add(
                (0, (1 << 63) - 1) if c is None else c
            )
        out = {}
        for pid, coords in res.items():
            v = sorted(coords)
            i = 1
            while i < len(v):
                if v[i - 1][1] >= v[i][0]:
                    x = v.pop(i)
                    v[i - 1] = (v[i - 1][0], max(v[i - 1][1], x[1]))
                else:
                    i += 1
            out[pid] = v
        return out

    def load_optional_subsetting(
        self, graph: GraphStorage, count_types: List[CountType]
    ):
        """Allocate exclude tables / subset bp tracking per count type
        (reference: src/graph_broker/abacus.rs:427-473)."""
        subset_covered_bps = (
            IntervalContainer()
            if CountType.BP in count_types and self.include_coords is not None
            else None
        )
        exclude_tables = [
            (
                ActiveTable(
                    graph.number_of_items(count) + 1, count == CountType.BP
                )
                if self.exclude_coords is not None
                else None
            )
            for count in count_types
        ]
        include_map = (
            self.build_subpath_map(self.include_coords)
            if self.include_coords is not None
            else {}
        )
        exclude_map = (
            self.build_subpath_map(self.exclude_coords)
            if self.exclude_coords is not None
            else {}
        )
        return subset_covered_bps, exclude_tables, include_map, exclude_map
