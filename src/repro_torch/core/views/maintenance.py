"""Incremental view maintenance from write deltas (paper §6).

"To identify affected views, we check which selection predicates of views
cover the updated point. For spatial and vector filters, each view defines
a coverage region (e.g., hypersphere), stored in an in-memory spatial
index (e.g., kd-tree). Upon data updates, we query this index to locate
and update all relevant views efficiently."

Coverage index: uniform grid over view rects (spatial) + centroid table
(vector). Backfill on creation scans the current store once.  Rectangle
membership tests run on the store's device (``kops.rect_filter``, the
bitmap filter).
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.views.view import SpatialRangeView, VectorNNView
from repro_torch.kernels import ops as kops


class CoverageIndex:
    """Locates views affected by an inserted/deleted row."""

    def __init__(self, grid: int = 16):
        self.spatial: List[SpatialRangeView] = []
        self.vector: List[VectorNNView] = []
        self.grid = grid
        self._cells: Dict[tuple, List[int]] = {}
        self._bbox = None
        self._centers: Optional[np.ndarray] = None

    def rebuild(self, views) -> None:
        self.spatial = [v for v in views if isinstance(v, SpatialRangeView)]
        self.vector = [v for v in views if isinstance(v, VectorNNView)]
        self._cells = {}
        if self.spatial:
            xs0 = min(v.rect[0] for v in self.spatial)
            ys0 = min(v.rect[1] for v in self.spatial)
            xs1 = max(v.rect[2] for v in self.spatial)
            ys1 = max(v.rect[3] for v in self.spatial)
            self._bbox = (xs0, ys0, max(xs1, xs0 + 1e-9),
                          max(ys1, ys0 + 1e-9))
            for i, v in enumerate(self.spatial):
                for cell in self._cells_of(v.rect):
                    self._cells.setdefault(cell, []).append(i)
        self._centers = np.stack([v.center for v in self.vector]) \
            if self.vector else None

    def _cells_of(self, rect):
        x0, y0, x1, y1 = self._bbox
        g = self.grid
        cx0 = int((rect[0] - x0) / (x1 - x0) * g)
        cx1 = int((rect[2] - x0) / (x1 - x0) * g)
        cy0 = int((rect[1] - y0) / (y1 - y0) * g)
        cy1 = int((rect[3] - y0) / (y1 - y0) * g)
        for cx in range(max(0, cx0), min(g, cx1 + 1)):
            for cy in range(max(0, cy0), min(g, cy1 + 1)):
                yield (cx, cy)

    def spatial_views_for(self, xy) -> List[SpatialRangeView]:
        if not self.spatial or self._bbox is None:
            return []
        x0, y0, x1, y1 = self._bbox
        g = self.grid
        cx = int((float(xy[0]) - x0) / (x1 - x0) * g)
        cy = int((float(xy[1]) - y0) / (y1 - y0) * g)
        if not (0 <= cx < g and 0 <= cy < g):
            return [v for v in self.spatial if v.covers_point(xy)]
        out = []
        for i in self._cells.get((cx, cy), []):
            v = self.spatial[i]
            if v.covers_point(xy):
                out.append(v)
        return out

    def vector_views_for(self, vec) -> List[VectorNNView]:
        if self._centers is None:
            return []
        d2 = ((self._centers - np.asarray(vec)[None, :]) ** 2).sum(axis=1)
        out = []
        for i, v in enumerate(self.vector):
            r = v.coverage_radius()
            if d2[i] <= r * r:
                out.append(v)
        return out


class ViewMaintainer:
    """Wires the coverage index into the store's delta hook."""

    def __init__(self, store):
        self.store = store
        self.views: List = []
        self.coverage = CoverageIndex()
        self.deltas_applied = 0
        store.on_delta(self._on_delta)

    # ------------------------------------------------------------- admin
    def install(self, views: List) -> None:
        self.views = list(views)
        self.coverage.rebuild(self.views)
        self._backfill()

    def _backfill(self) -> None:
        """Populate new views from current store contents — one columnar
        pass per (source, view) pair, vectorized membership tests."""
        mt_pk, _, mt_tomb, mt_cols = self.store.memtable_arrays()
        sources = [(seg.pk, seg.tombstone, seg.columns)
                   for seg in self.store.segments]
        sources.append((mt_pk, mt_tomb, mt_cols))
        for spk, stomb, scols in sources:
            live = ~np.asarray(stomb, bool)
            if not live.any():
                continue
            lpks = np.asarray(spk, np.int64)[live]
            for v in self.views:
                arr = scols.get(v.col)
                if arr is None:
                    continue
                vals = np.asarray(arr, np.float32)[live]
                if isinstance(v, SpatialRangeView):
                    inside = kops.rect_filter(vals, v.rect,
                                              device=self.store.device)
                    v.insert_many(lpks[inside], vals[inside])
                else:
                    v.insert_many(lpks, vals)

    # ------------------------------------------------------------- delta
    def _on_delta(self, pks, batch, deleted: bool) -> None:
        """Apply one columnar write delta ``(pks, batch, deleted)`` to all
        installed views — one vectorized membership test per view over the
        whole batch, never a per-row Python loop."""
        pks = np.asarray(pks, np.int64)
        if deleted:
            for v in self.views:
                v.remove_many(pks)
            self.deltas_applied += len(pks)
            return
        for v in self.coverage.spatial:
            pts = np.asarray(batch[v.col], np.float32)
            inside = kops.rect_filter(pts, v.rect, device=self.store.device)
            v.insert_many(pks[inside], pts[inside])
        for v in self.coverage.vector:
            vecs = np.asarray(batch[v.col], np.float32)
            d2 = ((vecs - v.center[None, :]) ** 2).sum(axis=1)
            r = v.coverage_radius()
            m = d2 <= r * r
            # sqrt only for the admitted rows (the view stores euclid)
            v.insert_many(pks[m], vecs[m], np.sqrt(d2[m]))
        self.deltas_applied += len(pks)
