"""Hybrid NN query processing — paper Algorithm 1 (NRA-style aggregation).

Every rank modality exposes the unified sorted ``Next()`` interface
(paper §5: "a standardized Next() interface for all supported
modalities"); per-segment streams are heap-merged into one global stream
per modality. Bounds per object o:

  LB(o) = Σ_seen λ_j d_j(o) + Σ_unseen λ_j bottom_j      (true score >= LB)
  UB(o) = Σ_seen λ_j d_j(o) + Σ_unseen λ_j D_max_j       (true score <= UB)

where bottom_j is the largest distance modality j has yielded so far and
D_max_j a finite domain bound from the catalog. Stop when the k-th
smallest UB among buffered objects is <= the LB of every other object and
of any completely-unseen object (Σ λ_j bottom_j).

Block adaptation (DESIGN.md §8.1): streams yield *blocks*; bound updates are
vectorized over each block; the stop test runs once per round. Yielded
distances only grow, so block granularity preserves bound correctness.

Final scores are refined by random access (exact distances for the winner
set) — a TA-style refinement the storage layout makes cheap, giving exact
scores for the returned k (the paper returns "sorted by LB").
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core import query as q
from repro_torch.core import visibility as vis_lib
from repro_torch.core.executor import ExecStats  # noqa: F401 (type only)
from repro_torch.core.index.base import MergedSortedAccess


def _per_segment_lookup(masks: Dict[int, np.ndarray], sids: np.ndarray,
                        rows: np.ndarray) -> np.ndarray:
    """Vectorized masks[sid][row] gather, grouped by segment."""
    keep = np.empty(len(sids), bool)
    for sid in np.unique(sids):
        sel = sids == sid
        keep[sel] = masks[int(sid)][rows[sel]]
    return keep


def _modality_stream(segments, rank, stats) -> Optional[MergedSortedAccess]:
    streams = []
    for seg in segments:
        idx = seg.indexes.get(rank.col)
        if idx is None or seg.n_rows == 0:
            return None
        if isinstance(rank, q.VectorRank):
            it = idx.iterator(seg, rank.q)
        elif isinstance(rank, q.SpatialRank):
            it = idx.iterator(seg, np.asarray(rank.point, np.float32))
        elif isinstance(rank, q.TextRank):
            it = idx.iterator(seg, list(rank.terms))
        else:
            return None
        streams.append((seg.seg_id, it))

    def key_fn(sid, rows):
        return np.stack([np.full_like(rows, sid), rows], axis=1)

    return MergedSortedAccess(streams, key_fn=key_fn)


def nra_topk(store, catalog, query: q.HybridQuery, stats) -> List:
    from repro_torch.core import executor as ex

    ranks = list(query.ranks)
    ell = len(ranks)
    weights = np.asarray([r.weight for r in ranks], np.float32)
    dmax = np.asarray([catalog.dist_bound(r) for r in ranks], np.float32)
    k = query.k
    # snapshot under the store lock: the whole NRA walk (sorted-access
    # streams, filter bitmaps, refinement) runs against one segment list
    # even while a background flush republishes mid-walk
    lock = getattr(store, "_lock", None)
    with lock if lock is not None else contextlib.nullcontext():
        segments = list(store.segments)
        vis = None if store.unique_pks else vis_lib.visibility_index(store)
    seg_by_id = {s.seg_id: s for s in segments}

    streams = [_modality_stream(segments, r, stats) for r in ranks]
    if any(s is None for s in streams):
        # missing index: planner should not have chosen NRA; full-scan
        from repro_torch.core.optimizer import planner as pl
        plan = pl.Plan(kind="full_scan_nn", residual=query.filters,
                       ranks=ranks, k=k)
        return ex.Executor(store)._prefilter_nn(query, plan, stats)

    # filter bitmaps per segment (pre-computed once)
    masks: Dict[int, np.ndarray] = {}
    if query.filters:
        dummy = ex.ExecStats()
        for seg in segments:
            m = np.ones(seg.n_rows, bool)
            for pred in query.filters:
                m &= ex.eval_predicate_seg(seg, pred, dummy,
                                            device=store.device)
            masks[seg.seg_id] = m
        stats.blocks_read += dummy.blocks_read

    # --- growable candidate table (block-vectorized bookkeeping) --------
    # encoded key = sid << 32 | row; keymap: enc -> table row
    keymap: Dict[int, int] = {}
    cap = 1024
    dmat = np.full((cap, ell), np.nan, np.float32)
    enc_arr = np.zeros(cap, np.int64)
    n_seen = 0
    bottoms = np.zeros(ell, np.float32)
    exhausted = np.zeros(ell, bool)

    ROUND_ROWS = 256   # drain this many rows per modality per round:
    #                    the merged stream certifies small prefixes, so
    #                    multiple pulls amortize the per-round bound check

    while True:
        progressed = False
        for j, st in enumerate(streams):
            if exhausted[j]:
                continue
            parts_d, parts_k, got = [], [], 0
            while got < ROUND_ROWS:
                blk = st.next_block()
                if blk is None:
                    exhausted[j] = True
                    bottoms[j] = dmax[j]
                    break
                parts_d.append(blk[0])
                parts_k.append(blk[1])
                got += len(blk[0])
            if not parts_d:
                continue
            dists = np.concatenate(parts_d)
            keys = np.concatenate(parts_k)
            progressed = True
            bottoms[j] = max(bottoms[j], float(dists[-1]))
            sids = keys[:, 0].astype(np.int64)
            rows = keys[:, 1].astype(np.int64)
            if query.filters:
                keep = _per_segment_lookup(masks, sids, rows)
                sids, rows, dists = sids[keep], rows[keep], dists[keep]
            if vis is not None and len(sids):
                keep = vis.visible_mask(sids, rows)
                sids, rows, dists = sids[keep], rows[keep], dists[keep]
            if not len(sids):
                continue
            encs = (sids << 32) | rows
            idxs = np.empty(len(encs), np.int64)
            for t, e in enumerate(encs.tolist()):     # one dict op per row
                i = keymap.get(e)
                if i is None:
                    i = n_seen
                    keymap[e] = i
                    n_seen += 1
                    if n_seen > cap:
                        cap *= 2
                        dmat = np.concatenate(
                            [dmat, np.full((cap - len(dmat), ell), np.nan,
                                           np.float32)])
                        enc_arr = np.concatenate(
                            [enc_arr, np.zeros(cap - len(enc_arr),
                                               np.int64)])
                    enc_arr[i] = e
                idxs[t] = i
            cur = dmat[idxs, j]
            dmat[idxs, j] = np.where(np.isnan(cur), dists,
                                     np.minimum(cur, dists))
        if n_seen == 0:
            if not progressed:
                return []
            continue

        # vectorized bound check once per round over the live table
        live = dmat[:n_seen]
        mask = ~np.isnan(live)
        lbs = np.sum(np.where(mask, weights * live, weights * bottoms),
                     axis=1)
        ubs = np.sum(np.where(mask, weights * live, weights * dmax), axis=1)
        if n_seen >= k:
            top_idx = np.argpartition(ubs, k - 1)[:k]
            kth_ub = float(np.max(ubs[top_idx]))
            others_lb = np.inf
            if n_seen > k:
                rest_mask = np.ones(n_seen, bool)
                rest_mask[top_idx] = False
                others_lb = float(np.min(lbs[rest_mask]))
            unseen_lb = float(np.sum(weights * bottoms))
            if kth_ub <= others_lb and kth_ub <= unseen_lb:
                winners = [(int(enc_arr[i]) >> 32,
                            int(enc_arr[i]) & 0xFFFFFFFF) for i in top_idx]
                break
        if not progressed:
            # everything exhausted: all candidates fully seen — rank by
            # (score, key) so equal scores break deterministically
            order = np.lexsort((enc_arr[:n_seen], ubs))[:k]
            winners = [(int(enc_arr[i]) >> 32,
                        int(enc_arr[i]) & 0xFFFFFFFF) for i in order]
            break

    # --- random-access refinement: exact scores for the winner set, then
    # the shared finishing pipeline (visibility + memtable overlay + topk)
    from repro_torch.core import operators as ops_lib

    parts = []
    for sid, row in winners:
        seg = seg_by_id[sid]
        vals = {r.col: seg.columns[r.col][np.asarray([row])] for r in ranks}
        score = float(ex.combined_scores(vals, ranks, store.device)[0])
        stats.rows_scanned += 1
        parts.append(ops_lib.Candidates(
            np.asarray([sid], np.int64), np.asarray([row], np.int64),
            np.asarray([score], np.float32)))
    cand = ops_lib.Candidates.concat(parts)
    from repro_torch.core.optimizer import planner as pl
    plan = pl.Plan(kind="nra", residual=query.filters, ranks=ranks, k=k)
    ctx = ops_lib.PipelineContext(store, catalog, [query], [plan], [stats])
    return ops_lib.finish_candidates(ctx, [cand])[0]
