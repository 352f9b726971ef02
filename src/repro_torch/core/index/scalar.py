"""Sorted scalar secondary index (the BTree analog inside the segment).

Per-segment component: the sorted (value, row) mapping created at SST
construction; block-level zone maps (min/max per block) let range probes
touch only overlapping blocks — the paper's 'sorted mappings from secondary
attribute values to data block handles'.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.core.index.base import (ExactSortedAccess, SecondaryIndex,
                                   merge_sorted_runs)
from repro_torch.core.types import BLOCK_ROWS


class ScalarIndex(SecondaryIndex):
    kind = "btree"

    def __init__(self):
        self.values: Optional[np.ndarray] = None     # sorted copy
        self.rows: Optional[np.ndarray] = None       # row ids sorted by value
        self.vmin = 0.0
        self.vmax = 0.0

    def build(self, segment, column) -> None:
        vals = np.asarray(segment.columns[column.name], np.float64)
        order = np.argsort(vals, kind="stable")
        self.values = vals[order]
        self.rows = order.astype(np.int64)
        if len(vals):
            self.vmin = float(self.values[0])
            self.vmax = float(self.values[-1])

    def merge(self, parts, merged_seg, column, row_maps) -> None:
        """Sorted-run merge: each part's (value, row) mapping is already
        value-sorted; remap rows through the compaction row maps, drop
        shadowed entries, and merge the runs — no re-sort of the merged
        column."""
        vals_list, rows_list = [], []
        for part, rmap in zip(parts, row_maps):
            if part.values is None or not len(part.values):
                continue
            new_rows = rmap[part.rows]
            keep = new_rows >= 0
            vals_list.append(part.values[keep])
            rows_list.append(new_rows[keep])
        self.values, self.rows = merge_sorted_runs(vals_list, rows_list)
        self.values = np.asarray(self.values, np.float64)
        self.rows = np.asarray(self.rows, np.int64)
        if len(self.values):
            self.vmin = float(self.values[0])
            self.vmax = float(self.values[-1])

    def to_arrays(self):
        return {"values": np.asarray(self.values, np.float64),
                "rows": np.asarray(self.rows, np.int64)}

    def from_arrays(self, arrays, segment, column) -> None:
        self.values = np.asarray(arrays["values"], np.float64)
        self.rows = np.asarray(arrays["rows"], np.int64)
        if len(self.values):
            self.vmin = float(self.values[0])
            self.vmax = float(self.values[-1])

    def bitmap(self, segment, predicate) -> np.ndarray:
        lo, hi = predicate.lo, predicate.hi
        mask = np.zeros(segment.n_rows, bool)
        i = np.searchsorted(self.values, lo, side="left")
        j = np.searchsorted(self.values, hi, side="right")
        mask[self.rows[i:j]] = True
        return mask

    def selectivity(self, segment, predicate) -> float:
        if segment.n_rows == 0:
            return 0.0
        i = np.searchsorted(self.values, predicate.lo, side="left")
        j = np.searchsorted(self.values, predicate.hi, side="right")
        return (j - i) / segment.n_rows

    def probe_cost_blocks(self, segment, predicate) -> float:
        """Index blocks touched: the matching run of the sorted mapping."""
        n = self.selectivity(segment, predicate) * segment.n_rows
        return max(1.0, n / BLOCK_ROWS)

    def iterator(self, segment, query) -> ExactSortedAccess:
        """Sorted access by |value - query.point| (rank by scalar proximity)."""
        target = float(query)
        d = np.abs(self.values - target)
        return ExactSortedAccess(d, self.rows)
