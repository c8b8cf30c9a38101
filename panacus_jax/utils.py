"""Core value types shared across the framework.

Array-first equivalents of the reference's utility layer
(reference: src/util.rs:14-432). Item ids are dense int32 numpy arrays
instead of u64 hash-map values; the device engine (ops/) consumes them
directly.
"""

from __future__ import annotations

import enum
import math
import sys
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np


class CountType(enum.Enum):
    """What graph quantity is counted (reference: src/util.rs:44-70)."""

    NODE = "node"
    BP = "bp"
    EDGE = "edge"
    ALL = "all"

    def __str__(self) -> str:
        return self.value

    @classmethod
    def parse(cls, s: str) -> "CountType":
        s = s.strip().lower()
        for v in cls:
            if v.value == s:
                return v
        raise ValueError(f"unknown count type: {s!r}")

    @classmethod
    def from_yaml(cls, s: str) -> "CountType":
        # YAML configs use serde variant names: Node / Bp / Edge / All
        return cls.parse(s)


@dataclass(frozen=True)
class Threshold:
    """Coverage/quorum threshold, absolute count or relative fraction
    (reference: src/util.rs:327-364)."""

    value: float
    relative: bool

    @classmethod
    def absolute(cls, v: int) -> "Threshold":
        return cls(float(v), False)

    @classmethod
    def rel(cls, v: float) -> "Threshold":
        return cls(float(v), True)

    def to_absolute(self, n: int) -> int:
        if self.relative:
            return int(math.ceil(n * self.value))
        return int(self.value)

    def to_relative(self, n: int) -> float:
        if self.relative:
            return self.value
        return self.value / n if n else 0.0

    def get_string(self) -> str:
        if self.relative:
            return fmt_float(self.value)
        return str(int(self.value))

    def __str__(self) -> str:
        # display form (reference: src/util.rs:333-341)
        return f"{self.get_string()}{'R' if self.relative else 'A'}"


def fmt_float(x: float) -> str:
    """Shortest-roundtrip decimal like Rust's `{}` for f64."""
    s = repr(float(x))
    if s.endswith(".0"):
        s = s[:-2]
    return s


def fmt_f32(x) -> str:
    """Shortest-roundtrip decimal of an f32 value, like Rust Display of f32."""
    x32 = np.float32(x)
    if np.isnan(x32):
        return "NaN"
    if np.isinf(x32):
        return "inf" if x32 > 0 else "-inf"
    s = np.format_float_positional(x32, unique=True, trim="-")
    if s.endswith("."):
        s = s[:-1]
    return s


def fmt_cell(x: float) -> str:
    """Format a table cell: floor()ed f64 printed via Rust f64 Display
    (reference: src/io.rs:484). NaN prints as 'NaN'."""
    if isinstance(x, float) and math.isnan(x):
        return "NaN"
    f = math.floor(x)
    return fmt_float(float(f))


def _parse_usize(el: str) -> int:
    """Parse like Rust usize::from_str: optional '+', ASCII digits only —
    no sign '-', no '_' separators, no surrounding junk."""
    body = el[1:] if el.startswith("+") else el
    if not body or not body.isascii() or not body.isdigit():
        raise ValueError(el)
    return int(body)


def _parse_f64(el: str) -> float:
    """Parse like Rust f64::from_str: Python float() is close but also
    accepts '_' digit separators, which Rust rejects."""
    if "_" in el:
        raise ValueError(el)
    return float(el)


def parse_threshold_list(threshold_str: str, require: str) -> List[Threshold]:
    """Parse a comma-separated threshold list.

    require: 'absolute' | 'relative' | 'either'
    (reference: src/graph_broker/hist.rs:207-258)
    """
    out: List[Threshold] = []
    for i, el in enumerate(threshold_str.split(",")):
        el = el.strip()
        if require == "absolute":
            try:
                out.append(Threshold.absolute(_parse_usize(el)))
            except ValueError:
                raise ValueError(
                    f'threshold "{threshold_str}" ({i + 1}. element in list) is '
                    "required to be integer, but isn't."
                )
        elif require == "relative":
            try:
                t = _parse_f64(el)
            except ValueError:
                raise ValueError(
                    f'threshold "{threshold_str}" ({i + 1}. element in list) is '
                    "required to be float, but isn't."
                )
            if not (0.0 <= t <= 1.0):
                raise ValueError(
                    f'relative threshold "{threshold_str}" ({i + 1}. element in '
                    "list) must be within [0,1]."
                )
            out.append(Threshold.rel(t))
        else:  # either
            try:
                out.append(Threshold.absolute(_parse_usize(el)))
            except ValueError:
                t = _parse_f64(el)
                if not (0.0 <= t <= 1.0):
                    raise ValueError(
                        f'relative threshold "{threshold_str}" must be within [0,1].'
                    )
                out.append(Threshold.rel(t))
    return out


class ThresholdContainer:
    """Paired coverage/quorum threshold lists with broadcast rules
    (reference: src/graph_broker/hist.rs:260-323)."""

    def __init__(self, coverage: List[Threshold], quorum: List[Threshold]):
        self.coverage = coverage
        self.quorum = quorum

    @classmethod
    def parse_params(cls, quorum: str, coverage: str) -> "ThresholdContainer":
        qs: List[Threshold] = []
        if quorum:
            qs = parse_threshold_list(quorum, "relative")
        if not qs:
            raise ValueError(
                "quorum threshold setting requires at least one element, but none is given"
            )
        cs: List[Threshold] = []
        if coverage:
            cs = parse_threshold_list(coverage, "absolute")
        if not cs:
            raise ValueError(
                "coverage threshold setting requires at least one element, but none is given"
            )
        if len(qs) != len(cs):
            if len(qs) == 1:
                qs = qs * len(cs)
            elif len(cs) == 1:
                cs = cs * len(qs)
            else:
                raise ValueError(
                    "number of coverage and quorum threshold must match, or either "
                    "one must have a single value"
                )
        return cls(cs, qs)


# -- interval helpers (sorted, non-overlapping interval lists) -----------------


def intersects(v: Sequence[Tuple[int, int]], el: Tuple[int, int]) -> bool:
    """True if el intersects any interval in sorted non-overlapping v
    (reference: src/util.rs:370-383)."""
    lo, hi = 0, len(v)
    while lo < hi:
        mid = (lo + hi) // 2
        s, e = v[mid]
        if s <= el[1] and e >= el[0]:
            return True
        if e < el[0]:
            lo = mid + 1
        else:
            hi = mid
    return False


def is_contained(v: Sequence[Tuple[int, int]], el: Tuple[int, int]) -> bool:
    """True if el is contained in some interval of sorted non-overlapping v
    (reference: src/util.rs:385-398)."""
    lo, hi = 0, len(v)
    while lo < hi:
        mid = (lo + hi) // 2
        s, e = v[mid]
        if s <= el[0] and e >= el[1]:
            return True
        if e <= el[1]:
            lo = mid + 1
        else:
            hi = mid
    return False


class IntervalContainer:
    """Per-item union of half-open intervals (reference: src/util.rs:199-310)."""

    def __init__(self):
        self.map = {}

    def add(self, iid: int, start: int, end: int) -> None:
        x = self.map.get(iid)
        if x is None:
            self.map[iid] = [(start, end)]
            return
        # binary search on interval starts
        import bisect

        i = bisect.bisect_left(x, start, key=lambda t: t[0])
        if i > 0 and x[i - 1][1] >= start:
            if x[i - 1][1] < end:
                stop = end
                while i < len(x) and x[i][0] <= end:
                    stop = max(stop, x[i][1])
                    x.pop(i)
                x[i - 1] = (x[i - 1][0], stop)
        elif i < len(x) and x[i][1] >= start and x[i][0] <= end:
            new_start = min(x[i][0], start)
            stop = max(x[i][1], end)
            while i + 1 < len(x) and x[i + 1][0] <= end:
                stop = max(stop, x[i + 1][1])
                x.pop(i + 1)
            x[i] = (new_start, stop)
        else:
            x.insert(i, (start, end))

    def get(self, iid: int) -> Optional[List[Tuple[int, int]]]:
        return self.map.get(iid)

    def contains(self, iid: int) -> bool:
        return iid in self.map

    def remove(self, iid: int):
        return self.map.pop(iid, None)

    def keys(self):
        return self.map.keys()

    def total_coverage(self, iid: int, exclude: Optional[List[Tuple[int, int]]]) -> int:
        """Total covered length, excluding intervals in `exclude`
        (reference: src/util.rs:265-300, incl. its off-by-one quirks)."""
        v = self.map.get(iid)
        if v is None:
            return 0
        if exclude is None:
            return sum(b - a for a, b in v)
        res = 0
        i = 0
        for start, end in v:
            while i < len(exclude) and exclude[i][1] <= start:
                i += 1
            if i < len(exclude) and exclude[i][0] < end:
                # replicate reference arithmetic exactly
                res += min(exclude[i][0] - 1, end) - start
                if exclude[i][1] < end:
                    res += end - exclude[i][1] + 1
            else:
                res += end - start
        return res


class ActiveTable:
    """Boolean per-item activation with optional interval annotation
    (reference: src/util.rs:117-197)."""

    def __init__(self, size: int, with_annotation: bool):
        self.items = np.zeros(size, dtype=bool)
        self.annotation: Optional[IntervalContainer] = (
            IntervalContainer() if with_annotation else None
        )

    def activate(self, iid: int) -> None:
        self.items[iid] = True

    def is_active(self, iid: int) -> bool:
        return bool(self.items[iid])

    def with_annotation(self) -> bool:
        return self.annotation is not None

    def activate_n_annotate(
        self, iid: int, item_len: int, start: int, end: int
    ) -> None:
        m = self.annotation
        if m is None:
            raise ValueError("Active Table has no annotations")
        if end - start == item_len:
            self.items[iid] = True
            m.remove(iid)
        else:
            if start > end:
                sys.stderr.write(
                    f"error: start ({start}) is larger than end ({end}) for node {iid}\n"
                )
            else:
                m.add(iid, start, end)
            got = m.get(iid)
            if got is not None and got[0] == (0, item_len):
                m.remove(iid)
                self.items[iid] = True

    def get_active_intervals(self, iid: int, item_len: int) -> List[Tuple[int, int]]:
        if self.items[iid]:
            return [(0, item_len)]
        if self.annotation is not None:
            got = self.annotation.get(iid)
            return list(got) if got is not None else []
        return []


def averageu32(v: np.ndarray) -> np.float32:
    """f32 average of u32 vector (reference: src/util.rs:400-402)."""
    return np.float32(np.float64(v.astype(np.uint64).sum()) / len(v))


def median_already_sorted(v: np.ndarray) -> float:
    n = len(v)
    mid = n // 2
    if n % 2 == 1:
        return float(v[mid])
    return (float(v[mid - 1]) + float(v[mid])) / 2.0


def n50_already_sorted(v: np.ndarray) -> Optional[int]:
    total = int(v.sum())
    running = 0
    for x in v:
        running += int(x)
        if running * 2 >= total:
            return int(x)
    return None
