"""Unified statistics catalog (paper §5: "detailed statistics and
selectivity estimates for all secondary indexes (vector, spatial, text) in
a unified catalog").

Store-wide estimates are row-weighted aggregates of per-segment index
statistics; rank-modality distance bounds (D_max) feed the NRA upper
bounds and cost estimates.
"""
from __future__ import annotations

import math

import numpy as np

from repro_torch.core import query as q
from repro_torch.core.types import BLOCK_ROWS


class Catalog:
    def __init__(self, store):
        self.store = store

    # ------------------------------------------------------- selectivity
    def selectivity(self, predicate) -> float:
        """Row-weighted average of per-segment index selectivity.  A
        negated literal's selectivity is the complement of its leaf's."""
        if isinstance(predicate, q.Not):
            return min(1.0, max(0.0,
                                1.0 - self.selectivity(predicate.child)))
        col = getattr(predicate, "col", None)
        total, acc = 0, 0.0
        for seg in self.store.segments:
            idx = seg.indexes.get(col)
            n = seg.n_rows
            total += n
            if idx is not None:
                acc += idx.selectivity(seg, predicate) * n
            else:
                acc += self._fallback_selectivity(seg, predicate) * n
        if total == 0:
            return 1.0
        return min(1.0, max(0.0, acc / total))

    def _fallback_selectivity(self, seg, predicate) -> float:
        if isinstance(predicate, q.Range):
            vals = np.asarray(seg.columns[predicate.col], np.float64)
            if len(vals) == 0:
                return 0.0
            lo, hi = float(vals.min()), float(vals.max())
            if hi <= lo:
                return 1.0
            frac = (min(predicate.hi, hi) - max(predicate.lo, lo)) / (hi - lo)
            return max(0.0, min(1.0, frac))
        return 0.5

    # --------------------------------------------------- distance bounds
    def dist_bound(self, rank) -> float:
        """Finite upper bound on the rank term's distance (for NRA UB)."""
        if isinstance(rank, q.TextRank):
            return 1.0                                   # 1/(1+score) <= 1
        if isinstance(rank, q.SpatialRank):
            diag = 0.0
            for seg in self.store.segments:
                idx = seg.indexes.get(rank.col)
                bb = getattr(idx, "bbox", None)
                if bb:
                    diag = max(diag, math.hypot(bb[2] - bb[0], bb[3] - bb[1]))
            px, py = rank.point
            return diag + abs(px) + abs(py) + 1.0
        # vector: (max ||v|| + ||q||)^2 via per-segment max norms
        qn = float(np.linalg.norm(np.asarray(rank.q, np.float32)))
        vmax = 0.0
        for seg in self.store.segments:
            vecs = seg.columns.get(rank.col)
            if vecs is not None and len(vecs):
                idx = seg.indexes.get(rank.col)
                cents = getattr(idx, "centroids", None)
                if cents is not None and len(cents):
                    vmax = max(vmax, float(
                        np.sqrt((cents ** 2).sum(1)).max()) * 2.0)
                else:
                    vmax = max(vmax, float(
                        np.sqrt((np.asarray(vecs[:64]) ** 2).sum(1)).max())
                        * 2.0)
        return (vmax + qn) ** 2 + 1.0

    # ------------------------------------------------------- cardinality
    @property
    def total_rows(self) -> int:
        return self.store.n_rows

    @property
    def total_blocks(self) -> float:
        return sum(s.n_blocks for s in self.store.segments) + \
            max(1, self.store.memtable_rows / BLOCK_ROWS)

    def index_probe_blocks(self, predicate) -> float:
        """Blocks touched probing the predicate's index across (global-
        index-pruned) segments."""
        col = getattr(predicate, "col", None)
        pruned = self.store.global_index.prune(self.store.segments, predicate)
        blocks = 0.0
        for seg in pruned:
            idx = seg.indexes.get(col)
            blocks += idx.probe_cost_blocks(seg, predicate) if idx is not None \
                else seg.n_blocks
        return blocks

    def has_index(self, col: str) -> bool:
        return any(col in seg.indexes for seg in self.store.segments) or \
            not self.store.segments
