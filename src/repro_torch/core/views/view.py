"""Incremental materialized views (paper §6).

Two view types, mirroring the paper's "Materialized View Selection":
  * SpatialRangeView — all rows inside a representative rect; shared by
    every query whose region is contained in it.
  * VectorNNView — top-(x*k) candidates around a representative query
    embedding, sorted by distance; queries with similar embeddings re-rank
    the materialized candidates at runtime to approximate their top-k.

Views hold (pk, key attrs, sort keys) — not full rows — and are maintained
incrementally from write deltas (maintenance.py).
"""
from __future__ import annotations

import itertools
from typing import Dict, List, Optional, Tuple

import numpy as np

_view_ids = itertools.count()


class SpatialRangeView:
    kind = "spatial_range"

    def __init__(self, col: str, rect: Tuple[float, float, float, float]):
        self.view_id = next(_view_ids)
        self.col = col
        self.rect = tuple(rect)
        self.rows: Dict[int, Tuple[float, float]] = {}   # pk -> point
        self.hits = 0

    # coverage -------------------------------------------------------------
    def covers_rect(self, rect) -> bool:
        return (self.rect[0] <= rect[0] and self.rect[1] <= rect[1]
                and self.rect[2] >= rect[2] and self.rect[3] >= rect[3])

    def covers_point(self, xy) -> bool:
        x, y = float(xy[0]), float(xy[1])
        return (self.rect[0] <= x <= self.rect[2]
                and self.rect[1] <= y <= self.rect[3])

    # maintenance ------------------------------------------------------------
    def insert(self, pk: int, xy) -> None:
        self.rows[int(pk)] = (float(xy[0]), float(xy[1]))

    def insert_many(self, pks: np.ndarray, xys: np.ndarray) -> None:
        """Columnar delta application: one C-level dict update."""
        if len(pks):
            self.rows.update(zip(np.asarray(pks, np.int64).tolist(),
                                 map(tuple, np.asarray(xys).tolist())))

    def remove(self, pk: int) -> None:
        self.rows.pop(int(pk), None)

    def remove_many(self, pks: np.ndarray) -> None:
        for pk in np.asarray(pks, np.int64).tolist():
            self.rows.pop(pk, None)

    # read --------------------------------------------------------------
    def pks_in(self, rect) -> List[int]:
        x0, y0, x1, y1 = rect
        return [pk for pk, (x, y) in self.rows.items()
                if x0 <= x <= x1 and y0 <= y <= y1]

    @property
    def size_bytes(self) -> int:
        return 24 * len(self.rows) + 64


class VectorNNView:
    kind = "vector_nn"

    def __init__(self, col: str, center: np.ndarray, xk: int,
                 sim_radius: float):
        self.view_id = next(_view_ids)
        self.col = col
        self.center = np.asarray(center, np.float32)
        self.xk = xk                      # materialize top-(x*k)
        self.sim_radius = float(sim_radius)  # query-match radius
        # sorted candidate list: (dist_to_center, pk, vector)
        self.cand: List[Tuple[float, int, np.ndarray]] = []
        self.hits = 0
        self._arrays_cache = None      # stacked (vecs, pks), read path

    # coverage ---------------------------------------------------------
    def matches_query(self, qvec: np.ndarray) -> bool:
        return float(np.linalg.norm(self.center - qvec)) <= self.sim_radius

    def coverage_radius(self) -> float:
        """A new point closer to center than the current worst candidate
        may belong in the view."""
        if len(self.cand) < self.xk:
            return float("inf")
        return self.cand[-1][0]

    # maintenance --------------------------------------------------------
    def insert(self, pk: int, vec: np.ndarray) -> None:
        d = float(np.linalg.norm(self.center - vec))
        if len(self.cand) >= self.xk and d >= self.cand[-1][0]:
            return
        import bisect
        keys = [c[0] for c in self.cand]
        i = bisect.bisect_left(keys, d)
        self.cand.insert(i, (d, int(pk), np.asarray(vec, np.float32)))
        if len(self.cand) > self.xk:
            self.cand.pop()
        self._arrays_cache = None

    def insert_many(self, pks: np.ndarray, vecs: np.ndarray,
                    dists: Optional[np.ndarray] = None) -> None:
        """Columnar delta application: merge a whole batch into the sorted
        candidate list with one argsort instead of per-row bisects."""
        if not len(pks):
            return
        vecs = np.asarray(vecs, np.float32)
        if dists is None:
            dists = np.sqrt(((vecs - self.center[None, :]) ** 2).sum(axis=1))
        # (score, pk) comparator keeps the candidate list's tie order
        # identical to the query-path ranking
        cut = np.lexsort((np.asarray(pks, np.int64), dists))
        if len(cut) > self.xk:
            cut = cut[:self.xk]
        new = [(float(dists[i]), int(pks[i]), vecs[i]) for i in cut]
        import heapq
        merged = list(heapq.merge(self.cand, new, key=lambda c: c[0]))
        self.cand = merged[:self.xk]
        self._arrays_cache = None

    def remove(self, pk: int) -> None:
        self.cand = [c for c in self.cand if c[1] != pk]
        self._arrays_cache = None

    def remove_many(self, pks: np.ndarray) -> None:
        gone = set(np.asarray(pks, np.int64).tolist())
        self.cand = [c for c in self.cand if c[1] not in gone]
        self._arrays_cache = None

    # read ----------------------------------------------------------------
    def _arrays(self) -> Tuple[np.ndarray, np.ndarray]:
        """Candidates as stacked arrays, cached between maintenance ops."""
        if self._arrays_cache is None:
            if self.cand:
                vecs = np.stack([c[2] for c in self.cand])
                pks = np.asarray([c[1] for c in self.cand], np.int64)
            else:
                vecs = np.zeros((0, len(self.center)), np.float32)
                pks = np.zeros(0, np.int64)
            self._arrays_cache = (vecs, pks)
        return self._arrays_cache

    def topk_for(self, qvec: np.ndarray, k: int) -> List[Tuple[float, int]]:
        """Re-rank materialized candidates for the actual query vector."""
        vecs, pks = self._arrays()
        if not len(pks):
            return []
        d = np.sqrt(((vecs - qvec[None, :]) ** 2).sum(axis=1))
        if k < len(d):
            idx = np.argpartition(d, k)[:k]
            idx = idx[np.lexsort((pks[idx], d[idx]))]
        else:
            idx = np.lexsort((pks, d))
        return [(float(d[i]), int(pks[i])) for i in idx]

    @property
    def size_bytes(self) -> int:
        dim = len(self.center)
        return len(self.cand) * (8 + 4 + 4 * dim) + 4 * dim + 64
