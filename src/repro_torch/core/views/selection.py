"""View selection: cluster registered queries, then knapsack under the
memory budget (paper §6: "Views are selected from registered continuous
queries using a knapsack-based strategy that balances reuse benefit and
storage overhead").

Spatial queries cluster by rect overlap (union-find on intersecting
rects -> one covering rect per cluster); vector queries cluster by k-means
on their query embeddings (one view per cluster center, sim_radius = max
member distance + slack). Benefit = expected block reads saved * queries
covered; cost = estimated view bytes. Greedy by benefit density — the
classic 1/2-approximation.

The k-means over query embeddings runs on the store's device.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from repro_torch.core import query as q
from repro_torch.core.index.ivf import kmeans
from repro_torch.core.optimizer.stats import Catalog
from repro_torch.core.views.view import SpatialRangeView, VectorNNView


@dataclasses.dataclass
class ViewCandidate:
    view: object
    benefit: float
    bytes_est: float
    members: int


def _rect_union(a, b):
    return (min(a[0], b[0]), min(a[1], b[1]),
            max(a[2], b[2]), max(a[3], b[3]))


def _rects_overlap(a, b) -> bool:
    return not (a[2] < b[0] or b[2] < a[0] or a[3] < b[1] or b[3] < a[1])


def cluster_spatial(rects: List[Tuple]) -> List[Tuple[Tuple, int]]:
    """Union-find on overlapping rects -> [(covering rect, n_members)]."""
    parent = list(range(len(rects)))

    def find(i):
        while parent[i] != i:
            parent[i] = parent[parent[i]]
            i = parent[i]
        return i

    for i in range(len(rects)):
        for j in range(i + 1, len(rects)):
            if _rects_overlap(rects[i], rects[j]):
                parent[find(i)] = find(j)
    groups = {}
    for i, r in enumerate(rects):
        root = find(i)
        if root in groups:
            groups[root] = (_rect_union(groups[root][0], r),
                            groups[root][1] + 1)
        else:
            groups[root] = (r, 1)
    return list(groups.values())


def cluster_vectors(qvecs: np.ndarray, max_clusters: int = 8,
                    device="cuda") -> List[Tuple[np.ndarray, float, int]]:
    """k-means clusters (assignments on ``device``) -> [(center, radius,
    n_members)]."""
    if len(qvecs) == 0:
        return []
    k = min(max_clusters, len(qvecs))
    cents = kmeans(np.asarray(qvecs, np.float32), k, iters=6, device=device)
    d = np.sqrt(((qvecs[:, None, :] - cents[None, :, :]) ** 2).sum(-1))
    assign = d.argmin(axis=1)
    out = []
    for c in range(len(cents)):
        members = np.nonzero(assign == c)[0]
        if not len(members):
            continue
        radius = float(d[members, c].max())
        out.append((cents[c], radius * 1.2 + 1e-3, len(members)))
    return out


def build_candidates(store, queries: List[q.HybridQuery],
                     xk_factor: int = 8) -> List[ViewCandidate]:
    """One candidate view per query cluster."""
    spatial_rects, vector_qs, vec_col, sp_col = [], [], None, None
    ks = []
    for query in queries:
        # clustering hints only: every GeoWithin leaf counts, wherever it
        # sits in the expression tree (matching stays semantics-checked)
        for p in q.leaf_predicates(query.where):
            if isinstance(p, q.GeoWithin):
                spatial_rects.append(p.rect)
                sp_col = p.col
        for r in query.ranks:
            if isinstance(r, q.VectorRank):
                vector_qs.append(r.q)
                vec_col = r.col
                ks.append(query.k)
            elif isinstance(r, q.SpatialRank):
                pass
    cands: List[ViewCandidate] = []
    n_rows = max(store.n_rows, 1)
    total_blocks = sum(s.n_blocks for s in store.segments) or 1

    for rect, members in cluster_spatial(spatial_rects):
        # expected rows in view from area fraction (catalog-style estimate)
        frac = 0.05
        try:
            frac = Catalog(store).selectivity(q.GeoWithin(sp_col, rect))
        except Exception:
            pass
        rows = frac * n_rows
        view = SpatialRangeView(sp_col, rect)
        benefit = members * total_blocks * (1 - frac)
        cands.append(ViewCandidate(view, benefit, rows * 24 + 64, members))

    if vector_qs:
        k_avg = int(np.mean(ks)) if ks else 10
        dim = len(vector_qs[0])
        for center, radius, members in cluster_vectors(
                np.stack(vector_qs), device=store.device):
            xk = k_avg * xk_factor
            view = VectorNNView(vec_col, center, xk, radius)
            benefit = members * total_blocks * 0.5
            cands.append(ViewCandidate(
                view, benefit, xk * (12 + 4 * dim) + 4 * dim, members))
    return cands


def knapsack_select(cands: List[ViewCandidate],
                    budget_bytes: float) -> List[ViewCandidate]:
    """Greedy by benefit/size density (1/2-approx for knapsack)."""
    chosen, used = [], 0.0
    for c in sorted(cands, key=lambda c: -(c.benefit / max(c.bytes_est, 1))):
        if used + c.bytes_est <= budget_bytes:
            chosen.append(c)
            used += c.bytes_est
    return chosen
