"""Reference-sequence grouping metadata (layer L3).

Parses the `-i` group-indicator file: one line per reference sequence,
tab-separated columns giving that sequence's group in each *grouping*
(multiple columns = multiple groupings, estimated independently —
include/Reference.hpp:67-94).  Group ids are assigned in order of first
appearance (include/Grouping.hpp:62-67), so group order — and therefore
output row order — matches the reference exactly.

The reference's 16-way adaptive integer-width template dispatch
(src/Grouping.cpp:46-88, src/Reference.cpp:46-54) collapses to numpy
dtype selection via :func:`msweep_tpu_torch.utils.min_uint_dtype`.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..utils import min_uint_dtype


@dataclass
class Grouping:
    """One clustering of the reference sequences into groups."""

    names: list[str]  # group names, id = position (first-appearance order)
    sizes: np.ndarray  # (G,) number of reference sequences per group
    indicators: np.ndarray  # (n_refs,) group id of each reference sequence

    @property
    def n_groups(self) -> int:
        return len(self.names)

    @property
    def max_group_size(self) -> int:
        return int(self.sizes.max()) if len(self.sizes) else 0


@dataclass
class Reference:
    """All groupings parsed from one indicator file."""

    groupings: list[Grouping]
    n_refs: int

    @property
    def n_groupings(self) -> int:
        return len(self.groupings)


def parse_reference(text: str, delimiter: str = "\t") -> Reference:
    """Parse the contents of a group-indicator file.

    Raises on zero reference sequences like the reference
    (include/Reference.hpp:91-93).
    """
    lines = text.splitlines()
    # Reference reads every line incl. empty ones via std::getline; an empty
    # line would become an empty-string group name there. Reproduce that:
    # only a trailing newline produces no extra line (splitlines handles it).
    if not lines:
        raise ValueError("The grouping contains 0 reference sequences")

    columns: list[list[str]] = []
    for line in lines:
        parts = line.split(delimiter)
        for j, part in enumerate(parts):
            if j >= len(columns):
                columns.append([])
            columns[j].append(part)

    groupings = []
    for col in columns:
        names: list[str] = []
        ids: dict[str, int] = {}
        indicators = np.empty(len(col), dtype=np.int64)
        for i, name in enumerate(col):
            gid = ids.get(name)
            if gid is None:
                gid = len(names)
                ids[name] = gid
                names.append(name)
            indicators[i] = gid
        sizes = np.bincount(indicators, minlength=len(names))
        sizes = sizes.astype(min_uint_dtype(int(sizes.max())))
        indicators = indicators.astype(min_uint_dtype(len(names) - 1 if names else 0))
        groupings.append(Grouping(names=names, sizes=sizes, indicators=indicators))

    n_refs = len(columns[0]) if columns else 0
    if n_refs == 0:
        raise ValueError("The grouping contains 0 reference sequences")
    return Reference(groupings=groupings, n_refs=n_refs)


def read_reference(path: str, delimiter: str = "\t") -> Reference:
    from .compressed import read_input_bytes

    return parse_reference(read_input_bytes(path).decode(), delimiter)
