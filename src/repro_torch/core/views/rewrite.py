"""Query rewriting over materialized views (paper §6).

Continuous queries: views matched and *statically* bound at registration
(reused every execution). Snapshot queries: matched at runtime with
rule-based heuristics — region containment for spatial filters, embedding
similarity for vector ranks — and rewritten per execution (greedy: the
first/highest-hit matching view wins).  The residual filter and the
rank scores run on the store's device.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from repro_torch.core import executor as ex
from repro_torch.core import query as q
from repro_torch.core import visibility as vis_lib
from repro_torch.core.views.view import SpatialRangeView, VectorNNView


@dataclasses.dataclass
class Rewrite:
    """A bound (view, query-part) substitution."""
    spatial_view: Optional[SpatialRangeView] = None
    spatial_pred: Optional[q.GeoWithin] = None
    vector_view: Optional[VectorNNView] = None
    vector_rank: Optional[q.VectorRank] = None

    @property
    def any(self) -> bool:
        return self.spatial_view is not None or self.vector_view is not None


def match(views: List, query: q.HybridQuery) -> Rewrite:
    """Greedy rule-based matching (used at registration for continuous
    queries, at runtime for snapshot queries).

    Spatial substitution requires the matched ``GeoWithin`` to be a
    top-level conjunct (replacing a predicate nested under ``Or``/``Not``
    with a view scan would change semantics), so it is attempted only for
    pure-conjunction queries.  Vector-NN matching post-filters candidates
    through the full expression tree and works for any ``where`` shape."""
    rw = Rewrite()
    try:
        top_literals = q.conjunction_literals(query.where)
    except ValueError:
        top_literals = []              # disjunctive: no spatial rewrite
    for p in top_literals:
        if isinstance(p, q.GeoWithin) and rw.spatial_view is None:
            best = None
            for v in views:
                if isinstance(v, SpatialRangeView) and v.col == p.col \
                        and v.covers_rect(p.rect):
                    if best is None or v.hits > best.hits:
                        best = v
            if best is not None:
                rw.spatial_view, rw.spatial_pred = best, p
    for r in query.ranks:
        if isinstance(r, q.VectorRank) and rw.vector_view is None:
            best = None
            for v in views:
                if isinstance(v, VectorNNView) and v.col == r.col \
                        and v.matches_query(r.q):
                    if best is None or v.hits > best.hits:
                        best = v
            if best is not None:
                rw.vector_view, rw.vector_rank = best, r
    return rw


def _lookup_visible(store, pks: np.ndarray):
    """Vectorized point lookup through the shared visibility index: pk ->
    winning (segment, row), memtable included; absent/tombstoned pks are
    dropped.  Returns (pks, sids, rows) in input order."""
    pks = np.asarray(pks, np.int64)
    if len(pks):
        sids, rows, found = vis_lib.visibility_index(store).lookup_pks(pks)
        return pks[found], sids[found], rows[found]
    z = np.zeros(0, np.int64)
    return z, z, z


def _gather(store, sids: np.ndarray, rows: np.ndarray, cols) -> dict:
    """Columnar gather of (segment|memtable, row) pairs, input order."""
    if not len(sids):
        return {c: np.zeros(0) for c in cols}
    seg_by_id = {s.seg_id: s for s in store.segments}
    idx_parts: List[np.ndarray] = []
    val_parts = {c: [] for c in cols}
    for sid in np.unique(sids):
        sel = np.nonzero(sids == sid)[0]
        src = store.memtable_arrays()[3] if sid < 0 \
            else seg_by_id[int(sid)].columns
        idx_parts.append(sel)
        for c in cols:
            val_parts[c].append(np.asarray(src[c])[rows[sel]])
    idx = np.concatenate(idx_parts)
    inv = np.empty(len(idx), np.int64)
    inv[idx] = np.arange(len(idx))
    return {c: np.concatenate(val_parts[c])[inv] for c in cols}


def _finish(store, query: q.HybridQuery, pks, sids, rows, where, stats,
            k=None):
    """Shared tail of both rewrite paths: the residual filter expression
    and rank scores evaluated columnar over only the needed columns, then
    the (score, pk) sort/cut; full rows are materialized only for the ≤ k
    returned results.  ``where`` is a filter expression tree or a list of
    literals (implicit conjunction).  Returns (result_rows, n_survivors)."""
    if isinstance(where, (list, tuple)):
        where = None if not where else \
            where[0] if len(where) == 1 else q.And(tuple(where))
    if len(pks):
        need = sorted(set(q.expr_cols(where)) |
                      {r.col for r in query.ranks})
        vals = _gather(store, sids, rows, need)
        keep = ex.eval_expr_rows(vals, where, store.device) if need else \
            np.ones(len(pks), bool)
        pks, sids, rows = pks[keep], sids[keep], rows[keep]
        vals = {c: v[keep] for c, v in vals.items()}
    if not len(pks):
        return [], 0
    stats.rows_scanned += int(len(pks))
    scores = ex.combined_scores(vals, query.ranks, store.device) \
        if query.ranks else np.zeros(len(pks), np.float32)
    order = np.lexsort((pks, scores))
    if k is not None:
        order = order[:k]
    out_cols = [c.name for c in store.schema.columns]
    final = _gather(store, sids[order], rows[order], out_cols)
    return ([ex.ResultRow(pk=int(pks[t]), score=float(scores[t]),
                          values={c: final[c][j] for c in out_cols})
             for j, t in enumerate(order)], int(len(pks)))


def execute_with_views(executor, query: q.HybridQuery, rw: Rewrite):
    """Execute using the bound views; residual parts go to the base
    executor. Returns (results, stats, used_view: bool)."""
    if not rw.any:
        res, st = executor.execute(query)
        return res, st, False

    stats = ex.ExecStats(plan="view_rewrite")
    store = executor.store

    # Vector-NN rewrite: re-rank materialized candidates, then apply
    # filters; fall back if the view can't fill k after filtering.
    if rw.vector_view is not None and query.is_nn:
        rw.vector_view.hits += 1
        cand = rw.vector_view.topk_for(rw.vector_rank.q,
                                       max(query.k * 4, query.k))
        pks, sids, seg_rows = _lookup_visible(
            store, np.asarray([pk for _, pk in cand], np.int64))
        res, n = _finish(store, query, pks, sids, seg_rows,
                         query.where, stats, k=query.k)
        if n >= query.k:
            return res, stats, True
        res, st = executor.execute(query)   # underfilled: fall back
        return res, st, False

    # Spatial-range rewrite: pks from the view replace the GeoWithin scan.
    if rw.spatial_view is not None:
        rw.spatial_view.hits += 1
        pks, sids, seg_rows = _lookup_visible(
            store, np.asarray(list(rw.spatial_view.pks_in(
                rw.spatial_pred.rect)), np.int64))
        residual = [p for p in query.filters if p is not rw.spatial_pred]
        res, _ = _finish(store, query, pks, sids, seg_rows, residual,
                         stats, k=query.k if query.is_nn else None)
        return res, stats, True

    res, st = executor.execute(query)
    return res, st, False
