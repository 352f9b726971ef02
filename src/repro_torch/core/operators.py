"""Composable physical operators over columnar batches (paper §5).

The read path is a pipeline of physical operators that pass columnar
batches — never per-row Python loops:

  SegmentScan / IndexProbe   leaf sources: per-segment candidate bitmaps
  FilterBitmap               residual predicates ANDed into the bitmaps
  RankScore                  batched distance kernels over the bitmap union
  VisibilityResolve          shared lexsort-based MVCC winner filtering
  MemtableOverlay            brute-force scan of the RAM write buffer
  TopKMerge                  per-query (score, pk) merge and cut

Every operator doubles as an EXPLAIN node (``explain()`` renders the tree
with per-operator cost estimates) and as an execution unit.  Execution is
*multi-query*: a ``PipelineContext`` carries a batch of queries, leaf
scans are shared across the batch (each predicate bitmap is computed once
per segment, whatever the batch size), and ``RankScore`` stacks the batch
query vectors into single ``l2_distances(Q, X)`` kernel calls — N
sequential segment sweeps become one.

Kernel work runs on the store's device (``ctx.device``); the fused and
quantized scans read the packed column and codes where ``pack_segments``
and ``pack_quantized`` keep them, on that device; the graph beam search
reads the packed column there too.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import query as q
from repro_torch.obs import trace as obs_trace
from repro_torch.core import visibility as vis_lib
from repro_torch.core.index.text import tokenize
from repro_torch.core.optimizer.cost import (C_FILTER_BLOCK, C_MERGE,
                                       C_RERANK_ROW, C_ROW_RESIDUAL,
                                       C_VECTOR_BLOCK, conjunct_passing)
from repro_torch.core.types import BLOCK_ROWS
from repro_torch.kernels import ops as kops


@dataclasses.dataclass
class ExecStats:
    blocks_read: float = 0.0
    rows_scanned: int = 0
    plan: str = ""
    # kernel-dispatch accounting (deltas of kernels.ops.stats_snapshot()
    # around this query's execution; batched queries in one scan group
    # share kernel calls, so — like blocks_read for shared bitmaps — each
    # member is charged the group's full delta to stay comparable with
    # sequential execution; benchmarks measuring fleet totals diff
    # stats_snapshot() themselves)
    kernel_launches: int = 0
    bytes_to_host: int = 0
    jit_shape_misses: int = 0
    # sharded scatter-gather accounting (core/shards ShardedExecutor):
    # fan-out width (0 = unsharded execution), candidate rows entering the
    # cross-shard device merge (bounded by shards * k), and the critical
    # path — rows scanned on the busiest shard (the wall-clock proxy when
    # shards execute in parallel)
    shards: int = 0
    merge_rows: int = 0
    shard_rows_max: int = 0
    # read-path bandwidth accounting (logical bytes, machine-independent):
    # rank-column bytes streamed for this query's candidate generation —
    # the quantized dispatch reads m code bytes/row instead of 4*d fp32
    # bytes, plus 4*d for each of the rerank_rows it re-scores exactly
    bytes_scanned: int = 0
    rerank_rows: int = 0


@dataclasses.dataclass
class ResultRow:
    pk: int
    score: float
    values: Dict[str, Any]


# ---------------------------------------------------------------------------
# predicate evaluation (segment bitmaps + materialized rows)
# ---------------------------------------------------------------------------

def vrange_mask(d2: np.ndarray, thresh: float) -> np.ndarray:
    """VectorRange admission from SQUARED distances: d < r compared as
    d2 < r*r — same rows, no full-matrix sqrt pass.  (sqrt is monotone
    and d2 is clamped >= 0 by construction; r <= 0 admits nothing, as
    sqrt(d2) >= 0 > r did before.)"""
    if thresh <= 0:
        return np.zeros(d2.shape, bool)
    return d2 < float(thresh) * float(thresh)


def eval_predicate_seg(seg, pred, stats: ExecStats,
                       use_index: bool = True,
                       device: kops.Device = "cuda") -> np.ndarray:
    """Bool mask over segment rows for one predicate.  Accepts any filter
    expression — And/Or recurse over their children's masks — so a
    ``residual`` slot can hold a whole sub-expression (the degenerate
    full-scan fallback for arbitrary boolean shapes)."""
    if isinstance(pred, q.Not):
        # complementing an APPROXIMATE bitmap (IVF probes a subset of
        # lists) would re-admit rows the user excluded; the vector leaf
        # must take the exact kernel path under negation
        exact_needed = isinstance(pred.child, q.VectorRange)
        return ~eval_predicate_seg(seg, pred.child, stats,
                                   use_index=use_index and not exact_needed,
                                   device=device)
    if isinstance(pred, q.And):
        m = np.ones(seg.n_rows, bool)
        for c in pred.children:
            m &= eval_predicate_seg(seg, c, stats, use_index=use_index,
                                    device=device)
        return m
    if isinstance(pred, q.Or):
        m = np.zeros(seg.n_rows, bool)
        for c in pred.children:
            m |= eval_predicate_seg(seg, c, stats, use_index=use_index,
                                    device=device)
        return m
    idx = seg.indexes.get(getattr(pred, "col", None)) if use_index else None
    if idx is not None:
        try:
            mask = idx.bitmap(seg, pred)
            stats.blocks_read += idx.probe_cost_blocks(seg, pred)
            return mask
        except NotImplementedError:
            pass
    # kernel fallback (full column scan)
    stats.blocks_read += seg.n_blocks
    if isinstance(pred, q.Range):
        col = np.asarray(seg.columns[pred.col], np.float32)[:, None]
        return kops.range_bitmap(col, np.asarray([[pred.lo, pred.hi]]),
                                 device=device)
    if isinstance(pred, q.GeoWithin):
        return kops.rect_filter(np.asarray(seg.columns[pred.col],
                                           np.float32), pred.rect,
                                device=device)
    if isinstance(pred, q.TextContains):
        term = pred.term.lower()
        return np.asarray([term in tokenize(t)
                           for t in seg.columns[pred.col]], bool)
    if isinstance(pred, q.VectorRange):
        d2 = kops.l2_distances(
            pred.q[None, :], np.asarray(seg.columns[pred.col],
                                        np.float32), device=device)[0]
        return vrange_mask(d2, pred.thresh)
    raise TypeError(f"unknown predicate {pred!r}")


def eval_predicate_rows(row_values: Dict[str, np.ndarray], pred,
                        device: kops.Device = "cuda") -> np.ndarray:
    """Predicate over materialized rows (memtable / residual eval).
    Accepts any filter expression — And/Or recurse."""
    if isinstance(pred, q.Not):
        return ~eval_predicate_rows(row_values, pred.child, device)
    if isinstance(pred, (q.And, q.Or)):
        return eval_expr_rows(row_values, pred, device)
    if isinstance(pred, q.Range):
        v = np.asarray(row_values[pred.col], np.float64)
        return (v >= pred.lo) & (v <= pred.hi)
    if isinstance(pred, q.GeoWithin):
        return kops.rect_filter(np.asarray(row_values[pred.col],
                                           np.float32), pred.rect,
                                device=device)
    if isinstance(pred, q.TextContains):
        term = pred.term.lower()
        return np.asarray([term in tokenize(t)
                           for t in row_values[pred.col]], bool)
    if isinstance(pred, q.VectorRange):
        vecs = np.asarray(row_values[pred.col], np.float32)
        if len(vecs) == 0:
            return np.zeros((0,), bool)
        return vrange_mask(kops.l2_distances(pred.q[None, :], vecs,
                                             device=device)[0],
                           pred.thresh)
    raise TypeError(f"unknown predicate {pred!r}")


def eval_expr_rows(row_values: Dict[str, np.ndarray], expr,
                   device: kops.Device = "cuda") -> np.ndarray:
    """Boolean filter expression tree over materialized rows.

    ``row_values`` must contain every column the expression references
    (``q.expr_cols``).  ``None`` means "no filter" (all rows pass)."""
    n = len(next(iter(row_values.values()))) if row_values else 0
    if expr is None:
        return np.ones(n, bool)
    if isinstance(expr, q.And):
        out = np.ones(n, bool)
        for c in expr.children:
            out &= eval_expr_rows(row_values, c, device)
            if not out.any():
                break
        return out
    if isinstance(expr, q.Or):
        out = np.zeros(n, bool)
        for c in expr.children:
            out |= eval_expr_rows(row_values, c, device)
            if out.all():
                break
        return out
    if isinstance(expr, q.Not):
        return ~eval_expr_rows(row_values, expr.child, device)
    return eval_predicate_rows(row_values, expr, device)


def pred_cache_key(pred) -> Tuple:
    """Hashable identity for a predicate (VectorRange holds an ndarray)."""
    if isinstance(pred, q.Not):
        return ("not",) + pred_cache_key(pred.child)
    if isinstance(pred, (q.And, q.Or)):
        return (type(pred).__name__.lower(),) + tuple(
            pred_cache_key(c) for c in pred.children)
    if isinstance(pred, q.Range):
        return ("range", pred.col, pred.lo, pred.hi)
    if isinstance(pred, q.GeoWithin):
        return ("geo", pred.col, tuple(pred.rect))
    if isinstance(pred, q.TextContains):
        return ("text", pred.col, pred.term)
    if isinstance(pred, q.VectorRange):
        return ("vrange", pred.col, pred.q.tobytes(), pred.thresh)
    return ("id", id(pred))


# ---------------------------------------------------------------------------
# rank-distance evaluation (exact; single-query and batched)
# ---------------------------------------------------------------------------

def rank_distances(values: Dict[str, np.ndarray], rank, seg=None,
                   rows: Optional[np.ndarray] = None,
                   device: kops.Device = "cuda") -> np.ndarray:
    if isinstance(rank, q.VectorRank):
        vecs = np.asarray(values[rank.col], np.float32)
        if len(vecs) == 0:
            return np.zeros((0,), np.float32)
        return np.sqrt(np.maximum(
            kops.l2_distances(rank.q[None, :], vecs, device=device)[0], 0))
    if isinstance(rank, q.SpatialRank):
        pts = np.asarray(values[rank.col], np.float32)
        p = np.asarray(rank.point, np.float32)
        if len(pts) == 0:
            return np.zeros((0,), np.float32)
        return np.sqrt(((pts - p) ** 2).sum(axis=1))
    if isinstance(rank, q.TextRank):
        out = np.empty(len(values[rank.col]), np.float32)
        qterms = [t.lower() for t in rank.terms]
        for i, text in enumerate(values[rank.col]):
            toks = tokenize(text)
            score = sum(toks.count(t) for t in qterms) / (len(toks) + 1.0)
            out[i] = 1.0 / (1.0 + score * 10.0)
        return out
    raise TypeError(f"unknown rank {rank!r}")


def combined_scores(values: Dict[str, np.ndarray], ranks,
                    device: kops.Device = "cuda") -> np.ndarray:
    n = len(next(iter(values.values()))) if values else 0
    total = np.zeros(n, np.float32)
    for r in ranks:
        total += r.weight * rank_distances(values, r, device=device)
    return total


def rank_signature(ranks) -> Tuple:
    """Queries with equal signatures can share one batched kernel call."""
    return tuple((type(r).__name__, r.col) for r in ranks)


def batched_rank_scores(values: Dict[str, np.ndarray],
                        rank_lists: Sequence[Sequence],
                        device: kops.Device = "cuda") -> np.ndarray:
    """Weighted-sum scores for a batch of structurally-identical rank
    lists -> (nq, n).  Vector and spatial modalities stack the batch's
    query points into one ``l2_distances(Q, X)`` kernel call."""
    nq = len(rank_lists)
    n = len(next(iter(values.values()))) if values else 0
    total = np.zeros((nq, n), np.float32)
    for j in range(len(rank_lists[0])):
        terms = [rl[j] for rl in rank_lists]
        r0 = terms[0]
        w = np.asarray([t.weight for t in terms], np.float32)[:, None]
        if isinstance(r0, (q.VectorRank, q.SpatialRank)):
            pts = np.asarray(values[r0.col], np.float32)
            Q = np.stack([np.asarray(
                t.q if isinstance(t, q.VectorRank) else t.point, np.float32)
                for t in terms])
            D = np.sqrt(np.maximum(kops.l2_distances(Q, pts, device=device),
                                   0))
        else:
            D = np.stack([rank_distances(values, t, device=device)
                          for t in terms])
        total += w * D
    return total


# ---------------------------------------------------------------------------
# execution context: one per query batch
# ---------------------------------------------------------------------------

class PipelineContext:
    """Shared state for executing a batch of queries in one pipeline pass:
    per-(segment, predicate) bitmap cache, global-index pruning sets, the
    shared visibility index, and memtable arrays.  Kernel work runs on
    the store's device."""

    def __init__(self, store, catalog, queries, plans,
                 stats: List[ExecStats],
                 pred_cache: Optional[Dict] = None):
        self.store = store
        self.device = store.device
        self.catalog = catalog
        self.queries = list(queries)
        self.plans = list(plans)
        self.stats = list(stats)
        self.nq = len(self.queries)
        self._pred_cache: Dict = pred_cache if pred_cache is not None else {}
        self._mt_pred: Dict = {}
        # snapshot the store's shared state under its lock: every operator
        # in this pass reads ctx.segments / ctx.memtable_arrays() so the
        # whole batch executes against ONE consistent store state even
        # while a background flush republishes mid-pass
        lock = getattr(store, "_lock", None)
        with lock if lock is not None else contextlib.nullcontext():
            self.segments: List = list(store.segments)
            self._mt = store.memtable_arrays()
            if not store.unique_pks:
                # eagerly pin the matching visibility index; resolving it
                # lazily could pick up a post-flush index whose winner
                # rows don't exist in the snapshotted segment list
                self._vis = vis_lib.visibility_index(store)
            else:
                self._vis = None
            # zone-map pruning per query (filter plans only, matching the
            # sequential executor: NN scans visit every segment)
            self._allowed: List[Optional[set]] = []
            for qq, plan in zip(self.queries, self.plans):
                if plan.kind in ("full_scan", "index_intersect"):
                    preds = plan.indexed or plan.residual
                    segs = self.segments
                    for p in preds:
                        segs = store.global_index.prune(segs, p)
                    self._allowed.append({s.seg_id for s in segs})
                elif plan.kind == "union":
                    # a segment is needed if ANY conjunct may match in it
                    allowed: set = set()
                    for sub in plan.subplans:
                        segs = self.segments
                        for p in list(sub.indexed) + list(sub.residual):
                            segs = store.global_index.prune(segs, p)
                        allowed |= {s.seg_id for s in segs}
                    self._allowed.append(allowed)
                else:
                    self._allowed.append(None)

    # ------------------------------------------------------------- caches
    @property
    def visibility(self):
        return self._vis

    def allowed(self, qi: int, seg) -> bool:
        a = self._allowed[qi]
        return a is None or seg.seg_id in a

    def pred_mask(self, seg, pred, use_index: bool
                  ) -> Tuple[np.ndarray, float]:
        """(bool mask over segment rows, block cost) — computed once per
        (segment, predicate) whatever the batch size; the block cost is
        charged to every query that uses the mask so per-query stats stay
        comparable with sequential execution."""
        key = (seg.seg_id, use_index, pred_cache_key(pred))
        hit = self._pred_cache.get(key)
        if hit is None:
            s = ExecStats()
            mask = eval_predicate_seg(seg, pred, s, use_index=use_index,
                                      device=self.device)
            hit = (mask, s.blocks_read)
            self._pred_cache[key] = hit
        return hit

    def memtable_arrays(self):
        # sealed-aware (includes memtables queued for flush), captured at
        # snapshot time in __init__
        return self._mt

    def memtable_pred_mask(self, pred) -> np.ndarray:
        key = pred_cache_key(pred)
        hit = self._mt_pred.get(key)
        if hit is None:
            _, _, _, cols = self.memtable_arrays()
            hit = eval_predicate_rows(cols, pred, self.device)
            self._mt_pred[key] = hit
        return hit

    def memtable_expr_mask(self, expr) -> np.ndarray:
        """Filter expression tree over the memtable, with per-literal
        mask caching shared across the batch."""
        pk, _, _, _ = self.memtable_arrays()
        if expr is None:
            return np.ones(len(pk), bool)
        if q.is_literal(expr):
            return self.memtable_pred_mask(expr)
        if isinstance(expr, q.And):
            out = np.ones(len(pk), bool)
            for c in expr.children:
                out &= self.memtable_expr_mask(c)
            return out
        if isinstance(expr, q.Or):
            out = np.zeros(len(pk), bool)
            for c in expr.children:
                out |= self.memtable_expr_mask(c)
            return out
        if isinstance(expr, q.Not):
            return ~self.memtable_expr_mask(expr.child)
        raise TypeError(f"unknown filter expression {expr!r}")


@dataclasses.dataclass
class Candidates:
    """Per-query columnar candidate set: parallel arrays of (segment id,
    row index, score).  ``sid == -1`` denotes a memtable row."""
    sids: np.ndarray
    rows: np.ndarray
    scores: np.ndarray

    @staticmethod
    def empty() -> "Candidates":
        return Candidates(np.zeros(0, np.int64), np.zeros(0, np.int64),
                          np.zeros(0, np.float32))

    @staticmethod
    def concat(parts: List["Candidates"]) -> "Candidates":
        if not parts:
            return Candidates.empty()
        return Candidates(np.concatenate([p.sids for p in parts]),
                          np.concatenate([p.rows for p in parts]),
                          np.concatenate([p.scores for p in parts]))


# ---------------------------------------------------------------------------
# physical operators
# ---------------------------------------------------------------------------

class PhysicalOp:
    name = "Op"

    def __init__(self, children: Sequence["PhysicalOp"] = (),
                 detail: str = "", est_cost: float = 0.0,
                 est_rows: float = 0.0):
        self.children = list(children)
        self.detail = detail
        self.est_cost = est_cost
        self.est_rows = est_rows

    def explain(self, indent: int = 0, annotate=None) -> str:
        """EXPLAIN rendering; ``annotate`` is an optional callback
        ``node -> suffix`` used by EXPLAIN ANALYZE to append actuals —
        the cached plain rendering never passes one."""
        pad = "  " * indent
        head = f"{pad}-> {self.name}"
        if self.detail:
            head += f" [{self.detail}]"
        head += f" cost={self.est_cost:.1f}"
        if annotate is not None:
            head += annotate(self)
        lines = [head]
        for c in self.children:
            lines.append(c.explain(indent + 1, annotate))
        return "\n".join(lines)

    # -- execution interface (leaf sources / transforms override) --------
    def batches(self, ctx: PipelineContext
                ) -> Iterator[Tuple[Any, np.ndarray]]:
        """Yield (segment, mask (nq, n_rows) bool) columnar batches.
        When tracing is on the drain is wrapped so each source records
        one ``operator:<Name>`` span; the disabled path returns the raw
        generator (zero per-batch overhead)."""
        if not obs_trace.enabled():
            return self._batches(ctx)
        return _traced_batches(self, ctx)

    def _batches(self, ctx: PipelineContext
                 ) -> Iterator[Tuple[Any, np.ndarray]]:
        raise NotImplementedError(self.name)


def _stat_sums(stats: List[ExecStats]) -> Tuple[float, int, int]:
    blocks = 0.0
    rows = nbytes = 0
    for s in stats:
        blocks += s.blocks_read
        rows += s.rows_scanned
        nbytes += s.bytes_scanned
    return blocks, rows, nbytes


def _traced_batches(op: PhysicalOp, ctx: PipelineContext
                    ) -> Iterator[Tuple[Any, np.ndarray]]:
    """Timed drain of a source generator: each ``next()`` window runs
    only the source's own code (consumers work between yields), so the
    ``ExecStats`` delta across the windows is exactly what this operator
    charged.  Nested sources (FilterBitmap over IndexProbe) attribute
    exclusively via a ctx-level accumulator of inner-drain charges; one
    completed span is recorded at exhaustion."""
    acc = getattr(ctx, "_drain_acc", None)
    if acc is None:
        acc = ctx._drain_acc = [0.0, 0, 0]
    gen = op._batches(ctx)
    total = 0.0
    blocks = 0.0
    rows = nbytes = out_rows = 0
    while True:
        pre = _stat_sums(ctx.stats)
        in0 = (acc[0], acc[1], acc[2])
        t0 = time.perf_counter()
        try:
            item = next(gen)
        except StopIteration:
            item = None
        total += time.perf_counter() - t0
        post = _stat_sums(ctx.stats)
        blocks += (post[0] - pre[0]) - (acc[0] - in0[0])
        rows += (post[1] - pre[1]) - (acc[1] - in0[1])
        nbytes += (post[2] - pre[2]) - (acc[2] - in0[2])
        if item is None:
            break
        out_rows += int(item[1].sum())
        yield item
    acc[0] += blocks
    acc[1] += rows
    acc[2] += nbytes
    obs_trace.record_span("operator:" + op.name, total, rows=rows,
                          bytes=nbytes, blocks=blocks, out_rows=out_rows)


class SegmentScan(PhysicalOp):
    """Leaf: every row of every (unpruned) segment."""
    name = "SegmentScan"

    def _batches(self, ctx):
        for seg in ctx.segments:
            if seg.n_rows == 0:
                continue
            mask = np.zeros((ctx.nq, seg.n_rows), bool)
            for qi in range(ctx.nq):
                if ctx.allowed(qi, seg):
                    mask[qi, :] = True
            if mask.any():
                yield seg, mask


class IndexProbe(PhysicalOp):
    """Leaf: per-segment index bitmaps for each query's probe predicates,
    intersected.  Falls back to a kernel column scan where a segment lacks
    the index."""
    name = "IndexProbe"

    def _batches(self, ctx):
        for seg in ctx.segments:
            if seg.n_rows == 0:
                continue
            mask = np.zeros((ctx.nq, seg.n_rows), bool)
            for qi, plan in enumerate(ctx.plans):
                if not ctx.allowed(qi, seg):
                    continue
                m = np.ones(seg.n_rows, bool)
                for pred in plan.indexed:
                    pm, blocks = ctx.pred_mask(seg, pred, use_index=True)
                    ctx.stats[qi].blocks_read += blocks
                    m &= pm
                    if not m.any():
                        break
                mask[qi] = m
            if mask.any():
                yield seg, mask


class FilterBitmap(PhysicalOp):
    """Residual predicates ANDed into the candidate bitmaps.  Each
    predicate is evaluated once per segment per batch, row-wise over the
    UNION of the batch's surviving candidate rows — N queries sharing a
    filter pay for one evaluation, and a selective index probe upstream
    keeps residual work O(survivors), never O(segment)."""
    name = "FilterBitmap"

    def _batches(self, ctx):
        for seg, mask in self.children[0].batches(ctx):
            rows = np.nonzero(mask.any(axis=0))[0]
            evaluated: Dict[Tuple, np.ndarray] = {}

            def residual_mask(pred) -> np.ndarray:
                key = pred_cache_key(pred)
                hit = evaluated.get(key)
                if hit is None:
                    vals = {c: seg.columns[c][rows]
                            for c in q.expr_cols(pred)}
                    hit = np.zeros(seg.n_rows, bool)
                    hit[rows[eval_predicate_rows(vals, pred,
                                                 ctx.device)]] = True
                    evaluated[key] = hit
                return hit

            for qi, plan in enumerate(ctx.plans):
                if not plan.residual or not mask[qi].any():
                    continue
                ctx.stats[qi].rows_scanned += int(mask[qi].sum())
                for pred in plan.residual:
                    mask[qi] &= residual_mask(pred)
                    if not mask[qi].any():
                        break
            if mask.any():
                yield seg, mask


class BitmapUnion(PhysicalOp):
    """OR-merge of per-conjunct candidate bitmaps — the DNF execution
    operator.  A disjunctive query's plan carries one sub-plan per DNF
    conjunct (``plan.subplans``); each conjunct is evaluated with the
    conjunctive machinery (cached index-probe bitmaps, row-restricted
    residual evaluation) and the per-conjunct ``(n_rows,)`` masks are
    OR-merged into the query's row of the shared ``(nq, n_rows)`` batch
    bitmap.  Conjunctive plans grouped into the same batch pass through
    as single-conjunct unions, so mixed batches still share one segment
    sweep."""
    name = "BitmapUnion"

    @staticmethod
    def _conjunct_mask(ctx, seg, sub, stats, residual_mask) -> np.ndarray:
        m = np.ones(seg.n_rows, bool)
        for pred in sub.indexed:
            pm, blocks = ctx.pred_mask(seg, pred, use_index=True)
            stats.blocks_read += blocks
            m &= pm
            if not m.any():
                return m
        for pred in sub.residual:
            rows = np.nonzero(m)[0]
            if not len(rows):
                break
            stats.rows_scanned += len(rows)
            m &= residual_mask(pred, rows)
        return m

    def _batches(self, ctx):
        for seg in ctx.segments:
            if seg.n_rows == 0:
                continue
            # residual literals evaluated row-restricted but at most once
            # per (segment, literal, row) across ALL queries and conjuncts
            # in the batch: `done` tracks which rows a literal has been
            # evaluated on, `vals` which of those passed
            evaluated: Dict[Tuple, Tuple[np.ndarray, np.ndarray]] = {}

            def residual_mask(pred, rows: np.ndarray) -> np.ndarray:
                key = pred_cache_key(pred)
                hit = evaluated.get(key)
                if hit is None:
                    hit = (np.zeros(seg.n_rows, bool),
                           np.zeros(seg.n_rows, bool))
                    evaluated[key] = hit
                done, vals_mask = hit
                todo = rows[~done[rows]]
                if len(todo):
                    vals = {c: seg.columns[c][todo]
                            for c in q.expr_cols(pred)}
                    vals_mask[todo[eval_predicate_rows(vals, pred,
                                                       ctx.device)]] = True
                    done[todo] = True
                return vals_mask

            mask = np.zeros((ctx.nq, seg.n_rows), bool)
            for qi, plan in enumerate(ctx.plans):
                if not ctx.allowed(qi, seg):
                    continue
                m = np.zeros(seg.n_rows, bool)
                for sub in (plan.subplans or [plan]):
                    m |= self._conjunct_mask(ctx, seg, sub, ctx.stats[qi],
                                             residual_mask)
                    if m.all():
                        break
                mask[qi] = m
            if mask.any():
                yield seg, mask


class RankScore(PhysicalOp):
    """Exact rank scores for surviving candidates.  The batch's query
    vectors are stacked into one ``l2_distances(Q, X)`` call per segment
    over the union of candidate rows."""
    name = "RankScore"

    def collect(self, ctx: PipelineContext) -> List[List[Candidates]]:
        with obs_trace.span("operator:" + self.name) as sp:
            return self._collect(ctx, sp)

    def _collect(self, ctx: PipelineContext, sp) -> List[List[Candidates]]:
        out: List[List[Candidates]] = [[] for _ in range(ctx.nq)]
        rank_lists = [qq.ranks for qq in ctx.queries]
        rank_cols = {r.col for r in rank_lists[0]}
        for seg, mask in self.children[0].batches(ctx):
            union = mask.any(axis=0)
            rows = np.nonzero(union)[0]
            if not len(rows):
                continue
            vals = {c: seg.columns[c][rows] for c in rank_cols}
            # logical rank-column bytes per candidate row (text columns
            # hold object refs, not streamable bytes — skip them)
            row_bytes = sum(v.nbytes // max(1, len(rows))
                            for v in vals.values() if v.dtype != object)
            scores = batched_rank_scores(vals, rank_lists, ctx.device)
            for qi, plan in enumerate(ctx.plans):
                sel = mask[qi][rows]
                if not sel.any():
                    continue
                if not plan.indexed and not plan.residual \
                        and not plan.subplans:
                    blocks = seg.n_blocks * len(rank_lists[qi])
                    ctx.stats[qi].blocks_read += blocks
                    if sp.live:
                        sp.add("blocks", blocks)
                qrows = rows[sel]
                ctx.stats[qi].rows_scanned += len(qrows)
                ctx.stats[qi].bytes_scanned += len(qrows) * row_bytes
                if sp.live:
                    sp.add("rows", len(qrows))
                    sp.add("bytes", len(qrows) * row_bytes)
                out[qi].append(Candidates(
                    np.full(len(qrows), seg.seg_id, np.int64),
                    qrows.astype(np.int64), scores[qi][sel]))
        return out


class FusedScanTopK(PhysicalOp):
    """Fused masked scan -> top-k over the packed cross-segment
    superbatch (kernels/fused_scan.py).  Drains the source's per-segment
    bitmaps, packs every surviving segment's rank column (plus bitmaps,
    pks and row-provenance maps) into ONE bucket-padded matrix, and makes
    a single kernel dispatch for the whole query batch — only ``(nq, k)``
    distances + row ids return to the host, instead of per-segment
    ``(nq, n)`` matrices.  The packed column stays on the store's device
    across batches (``pack_segments``' cache); the batch bitmap is
    uploaded per batch.

    Sound only under the planner's ``_fusable`` gate: unique pks (the
    device-side cut precedes visibility resolution and the memtable
    overlay, so no candidate may be shadowed) and exactly one
    positive-weight vector/spatial rank term (a monotone transform of the
    kernel's squared-L2 order, so the device (distance, pk) tie-break
    equals the host merge's lexsort by (score, pk))."""
    name = "FusedScanTopK"

    def _gather(self, ctx: PipelineContext):
        """Drain the source into (segments, packed column, batch bitmap,
        stacked query matrix) — shared by the exact and quantized scans."""
        from repro_torch.core import segment as seg_lib
        r0 = ctx.queries[0].ranks[0]
        segs, masks = [], []
        for seg, mask in self.children[0].batches(ctx):
            segs.append(seg)
            masks.append(mask)
        if not segs:
            return None
        packed = seg_lib.pack_segments(segs, r0.col, ctx.device)
        mask_all = np.concatenate(masks, axis=1)
        Q = np.stack([np.asarray(
            t.q if isinstance(t, q.VectorRank) else t.point, np.float32)
            for t in (qq.ranks[0] for qq in ctx.queries)])
        return segs, packed, mask_all, Q

    def _emit(self, ctx: PipelineContext, segs, packed, mask_all,
              d2, rows, scan_row_bytes: int,
              rerank_rows: Optional[List[int]] = None
              ) -> List[List[Candidates]]:
        """Turn kernel (d2, rows) output into per-query candidates and
        charge stats.  ``scan_row_bytes`` is the logical rank-column bytes
        the candidate-generation scan streams per mask-passing row (4*d
        exact, m quantized) — ``bytes_scanned`` measures the scan phase
        only; the exact re-rank's full-precision gather is reported
        separately as ``rerank_rows`` (x 4*d bytes, derivable)."""
        out: List[List[Candidates]] = [[] for _ in range(ctx.nq)]
        unfiltered_blocks = sum(s.n_blocks for s in segs)
        sp = obs_trace.current_span()
        for qi, (qq, plan) in enumerate(zip(ctx.queries, ctx.plans)):
            # stats parity with the staged RankScore operator: candidate
            # rows ranked, and full scan blocks charged to filterless plans
            n_cand = int(mask_all[qi].sum())
            ctx.stats[qi].rows_scanned += n_cand
            ctx.stats[qi].bytes_scanned += n_cand * scan_row_bytes
            if sp is not None:
                sp.add("rows", n_cand)
                sp.add("bytes", n_cand * scan_row_bytes)
            if rerank_rows is not None:
                ctx.stats[qi].rerank_rows += rerank_rows[qi]
            if not plan.indexed and not plan.residual and not plan.subplans:
                blocks = unfiltered_blocks * len(qq.ranks)
                ctx.stats[qi].blocks_read += blocks
                if sp is not None:
                    sp.add("blocks", blocks)
            keep = rows[qi] >= 0
            rr = rows[qi][keep]
            if not len(rr):
                continue
            w = np.float32(qq.ranks[0].weight)
            scores = w * np.sqrt(np.maximum(d2[qi][keep], 0)
                                 ).astype(np.float32)
            out[qi].append(Candidates(packed.sids[rr], packed.rows[rr],
                                      scores))
        return out

    def collect(self, ctx: PipelineContext) -> List[List[Candidates]]:
        with obs_trace.span("operator:" + self.name):
            return self._collect(ctx)

    def _collect(self, ctx: PipelineContext) -> List[List[Candidates]]:
        g = self._gather(ctx)
        if g is None:
            return [[] for _ in range(ctx.nq)]
        segs, packed, mask_all, Q = g
        k = max(qq.k for qq in ctx.queries)
        d2, rows = kops.fused_scan_topk(Q, packed.x, mask_all,
                                        packed.pks, k, device=ctx.device)
        return self._emit(ctx, segs, packed, mask_all, d2, rows,
                          scan_row_bytes=packed.x.shape[1]
                          * packed.x.element_size())


class QuantizedScanTopK(FusedScanTopK):
    """Quantized dispatch: PQ-ADC candidate generation over the packed
    code matrix (``kernels/quantized_scan.py`` — m bytes/row instead of
    4*d) keeping k' = refine*k survivors per query, then an exact re-rank
    of the survivors through the ordinary fused scan with the survivor
    bitmap.  The re-rank reuses ``kops.fused_scan_topk`` verbatim, so the
    final (score, pk) results carry the exact path's arithmetic and
    tie-break comparator — whenever the survivors cover the true top-k
    (refine high enough), results are bitwise identical to the exact
    dispatch.  Admissible only under the planner's ``_quantized_params``
    gate (explicit recall_target, all-segment PQ residence); a pack-time
    codebook mismatch falls back to the exact fused scan."""
    name = "QuantizedScanTopK"

    def _collect(self, ctx: PipelineContext) -> List[List[Candidates]]:
        from repro_torch.core import segment as seg_lib
        g = self._gather(ctx)
        if g is None:
            return [[] for _ in range(ctx.nq)]
        segs, packed, mask_all, Q = g
        k = max(qq.k for qq in ctx.queries)
        fp_bytes = packed.x.shape[1] * packed.x.element_size()
        pc = seg_lib.pack_quantized(segs, ctx.queries[0].ranks[0].col,
                                    ctx.device)
        if pc is None:
            # quantized residence fell behind (mixed codebooks / missing
            # codes): exact fused scan, correctness before bandwidth
            d2, rows = kops.fused_scan_topk(Q, packed.x, mask_all,
                                            packed.pks, k, device=ctx.device)
            return self._emit(ctx, segs, packed, mask_all, d2, rows,
                              scan_row_bytes=fp_bytes)
        refine = max((getattr(p, "refine", 0) for p in ctx.plans),
                     default=0) or 4
        kprime = min(kops.fs_kernel.KMAX, refine * k)
        _, crows = kops.quantized_scan_topk(
            Q, pc.codes, pc.codebooks, mask_all, packed.pks, kprime,
            device=ctx.device)
        # survivor bitmap for the exact re-rank (per query)
        rmask = np.zeros_like(mask_all)
        rerank_rows: List[int] = []
        for qi in range(ctx.nq):
            rr = crows[qi][crows[qi] >= 0]
            rmask[qi, rr] = True
            rerank_rows.append(len(rr))
        d2, rows = kops.fused_scan_topk(Q, packed.x, rmask, packed.pks, k,
                                        device=ctx.device)
        return self._emit(ctx, segs, packed, mask_all, d2, rows,
                          scan_row_bytes=pc.codes.shape[1],
                          rerank_rows=rerank_rows)


class GraphSearchTopK(FusedScanTopK):
    """Graph dispatch: batched beam search over the stitched per-segment
    CSR proximity graphs (``kernels/graph_search.py``) generates
    candidates by traversal — only the rows the frontier touches are ever
    gathered, no column stream — then an exact re-rank of the beam
    survivors through the ordinary fused scan with the survivor bitmap.
    The re-rank reuses ``kops.fused_scan_topk`` verbatim, so the final
    (score, pk) results carry the exact path's arithmetic and tie-break
    comparator — whenever the beam covers the true top-k (beam wide
    enough for the recall target), results are bitwise identical to the
    exact dispatch.  Admissible only under the planner's
    ``_graph_params`` gate (explicit recall_target, all-segment graph
    residence); a pack-time missing graph falls back to the exact fused
    scan, never to wrong answers.

    Stats reflect the traversal: ``rows_scanned`` / ``bytes_scanned``
    charge the rows the beam actually gathered (the visited-bitmap
    popcount the kernel returns), not the mask-passing row count the
    streaming dispatches charge."""
    name = "GraphSearchTopK"

    def _collect(self, ctx: PipelineContext) -> List[List[Candidates]]:
        from repro_torch.core.index import graph as graph_lib
        g = self._gather(ctx)
        if g is None:
            return [[] for _ in range(ctx.nq)]
        segs, packed, mask_all, Q = g
        k = max(qq.k for qq in ctx.queries)
        fp_bytes = packed.x.shape[1] * packed.x.element_size()
        pg = graph_lib.pack_graphs(segs, ctx.queries[0].ranks[0].col)
        if pg is None:
            # graph residence fell behind (a segment without a built
            # graph): exact fused scan, correctness before traversal
            d2, rows = kops.fused_scan_topk(Q, packed.x, mask_all,
                                            packed.pks, k, device=ctx.device)
            return self._emit(ctx, segs, packed, mask_all, d2, rows,
                              scan_row_bytes=fp_bytes)
        beam = max((getattr(p, "graph_beam", 0) for p in ctx.plans),
                   default=0) or 32
        hops = max((getattr(p, "graph_hops", 0) for p in ctx.plans),
                   default=0) or 8
        beam = min(beam, int(kops.fs_kernel.KMAX))
        _, brows, gathered = kops.graph_search_topk(
            Q, packed.x, pg.neighbors, pg.entries, mask_all, packed.pks,
            beam, hops, device=ctx.device)
        # survivor bitmap for the exact re-rank (per query)
        rmask = np.zeros_like(mask_all)
        rerank_rows: List[int] = []
        for qi in range(ctx.nq):
            rr = brows[qi][brows[qi] >= 0]
            rmask[qi, rr] = True
            rerank_rows.append(len(rr))
        d2, rows = kops.fused_scan_topk(Q, packed.x, rmask, packed.pks, k,
                                        device=ctx.device)
        out: List[List[Candidates]] = [[] for _ in range(ctx.nq)]
        sp = obs_trace.current_span()
        for qi, (qq, plan) in enumerate(zip(ctx.queries, ctx.plans)):
            n_gath = int(gathered[qi])
            ctx.stats[qi].rows_scanned += n_gath
            ctx.stats[qi].bytes_scanned += n_gath * fp_bytes
            ctx.stats[qi].rerank_rows += rerank_rows[qi]
            if sp is not None:
                sp.add("rows", n_gath)
                sp.add("bytes", n_gath * fp_bytes)
            if not plan.indexed and not plan.residual and not plan.subplans:
                blocks = -(-n_gath // BLOCK_ROWS) * len(qq.ranks)
                ctx.stats[qi].blocks_read += blocks
                if sp is not None:
                    sp.add("blocks", blocks)
            keep = rows[qi] >= 0
            rr = rows[qi][keep]
            if not len(rr):
                continue
            w = np.float32(qq.ranks[0].weight)
            scores = w * np.sqrt(np.maximum(d2[qi][keep], 0)
                                 ).astype(np.float32)
            out[qi].append(Candidates(packed.sids[rr], packed.rows[rr],
                                      scores))
        return out


class VisibilityResolve(PhysicalOp):
    """Drop candidates shadowed by a newer version of their pk anywhere in
    the store (shared lexsort winner set — core/visibility.py)."""
    name = "VisibilityResolve"

    def apply(self, ctx: PipelineContext,
              cands: List[Candidates]) -> List[Candidates]:
        with obs_trace.span("operator:" + self.name) as sp:
            vis = ctx.visibility
            if vis is None:                   # unique-pk fast path
                out = cands
            else:
                out = []
                for c in cands:
                    keep = vis.visible_mask(c.sids, c.rows)
                    out.append(Candidates(c.sids[keep], c.rows[keep],
                                          c.scores[keep]))
            if sp.live:
                sp.set(out_rows=sum(len(c.scores) for c in out))
            return out


class MemtableOverlay(PhysicalOp):
    """Brute-force scan of the RAM write buffer: newest visible version
    per pk, the query's filters applied, exact rank scores."""
    name = "MemtableOverlay"

    def apply(self, ctx: PipelineContext,
              cands: List[Candidates]) -> List[Candidates]:
        with obs_trace.span("operator:" + self.name) as sp:
            out = self._apply(ctx, cands)
            if sp.live:
                sp.set(out_rows=sum(len(c.scores) for c in out))
            return out

    def _apply(self, ctx: PipelineContext,
               cands: List[Candidates]) -> List[Candidates]:
        pk, _, tomb, cols = ctx.memtable_arrays()
        if not len(pk):
            return cands
        base = vis_lib.memtable_visible(pk, tomb)
        out = []
        for qi, (qq, c) in enumerate(zip(ctx.queries, cands)):
            keep = base & ctx.memtable_expr_mask(qq.where)
            rows = np.nonzero(keep)[0]
            if not len(rows):
                out.append(c)
                continue
            if qq.ranks:
                vals = {r.col: cols[r.col][rows] for r in qq.ranks}
                scores = combined_scores(vals, qq.ranks, ctx.device)
            else:
                scores = np.zeros(len(rows), np.float32)
            mt_c = Candidates(np.full(len(rows), -1, np.int64),
                              rows.astype(np.int64),
                              scores.astype(np.float32))
            out.append(Candidates.concat([c, mt_c]))
        return out


class TopKMerge(PhysicalOp):
    """Per-query merge of scored candidates: order by (score, pk), cut to
    k, materialize only the returned rows."""
    name = "TopKMerge"

    def finish(self, ctx: PipelineContext,
               cands: List[Candidates]) -> List[List[ResultRow]]:
        with obs_trace.span("operator:" + self.name) as sp:
            out = [materialize(ctx, qq, c, k=qq.k)
                   for qq, c in zip(ctx.queries, cands)]
            if sp.live:
                sp.set(out_rows=sum(len(r) for r in out))
            return out


class NRAMerge(PhysicalOp):
    """No-random-access aggregation over per-modality sorted streams
    (paper Algorithm 1) — executed by core.nra over the merged ``Next()``
    iterators; appears here as the plan's EXPLAIN node."""
    name = "NRAMerge"


class EmptyResult(PhysicalOp):
    """The filter expression normalized to FALSE: nothing to scan."""
    name = "EmptyResult"



class ShardFanout(PhysicalOp):
    """Scatter one query batch to every shard's independent pipeline
    (rows are hash-partitioned by pk across shards — core/shards).  The
    children are the per-shard operator subtrees, each costed against
    that shard's own catalog; execution runs them over each shard's
    segments, memtable and visibility state in full."""
    name = "ShardFanout"


class CrossShardTopKMerge(PhysicalOp):
    """Device-side merge of the per-shard top-k candidate lists into the
    global top-k (``kernels/topk_merge.py::batched_topk_merge``, ordered
    by the host comparator (score, pk)).  Shards partition pks, so the
    merge of per-shard top-ks IS the exact global top-k; the host never
    handles more than shards * k rows per query."""
    name = "CrossShardTopKMerge"


class ShardConcat(PhysicalOp):
    """Shard-wise concatenation of filter/scan results: shards hold
    disjoint pk sets, so concatenating and re-sorting by the result
    comparator (score, pk) reproduces the single-store output exactly."""
    name = "ShardConcat"


# ---------------------------------------------------------------------------
# materialization
# ---------------------------------------------------------------------------

def candidate_pks(ctx: PipelineContext, c: Candidates) -> np.ndarray:
    pks = np.empty(len(c.sids), np.int64)
    seg_by_id = {s.seg_id: s for s in ctx.segments}
    for sid in np.unique(c.sids):
        sel = c.sids == sid
        if sid < 0:
            mt_pk, _, _, _ = ctx.memtable_arrays()
            pks[sel] = mt_pk[c.rows[sel]]
        else:
            pks[sel] = seg_by_id[sid].pk[c.rows[sel]]
    return pks


def materialize(ctx: PipelineContext, query, c: Candidates,
                k: Optional[int] = None) -> List[ResultRow]:
    """Sort candidates by (score, pk), optionally cut to k, and gather the
    selected columns for the surviving rows only."""
    pks = candidate_pks(ctx, c)
    order = np.lexsort((pks, c.scores))
    if k is not None:
        order = order[:k]
    select = query.select or [col.name for col in ctx.store.schema.columns]
    seg_by_id = {s.seg_id: s for s in ctx.segments}
    out: List[ResultRow] = []
    for t in order:
        sid, row = int(c.sids[t]), int(c.rows[t])
        if sid < 0:
            _, _, _, cols = ctx.memtable_arrays()
            values = {name: cols[name][row] for name in select}
        else:
            seg = seg_by_id[sid]
            values = {name: seg.columns[name][row] for name in select}
        out.append(ResultRow(pk=int(pks[t]), score=float(c.scores[t]),
                             values=values))
    return out


# ---------------------------------------------------------------------------
# pipeline drivers
# ---------------------------------------------------------------------------

def collect_rows(ctx: PipelineContext, source: PhysicalOp
                 ) -> List[Candidates]:
    """Drain a bitmap-producing operator into per-query candidates with
    zero scores (filter-query path)."""
    out: List[List[Candidates]] = [[] for _ in range(ctx.nq)]
    for seg, mask in source.batches(ctx):
        for qi in range(ctx.nq):
            rows = np.nonzero(mask[qi])[0]
            if len(rows):
                out[qi].append(Candidates(
                    np.full(len(rows), seg.seg_id, np.int64),
                    rows.astype(np.int64),
                    np.zeros(len(rows), np.float32)))
    return [Candidates.concat(parts) for parts in out]


def run_scan_group(store, catalog, queries, plans, stats,
                   pred_cache: Optional[Dict] = None
                   ) -> List[List[ResultRow]]:
    """Execute a batch of scan-based queries (full_scan, index_intersect,
    full_scan_nn, prefilter_nn) in ONE shared pass over the segments."""
    ctx = PipelineContext(store, catalog, queries, plans, stats, pred_cache)
    is_nn = bool(queries[0].ranks)
    if any(p.kind in ("union", "union_nn") for p in plans):
        # DNF plans in the batch: the union source evaluates every plan
        # (conjunctive ones as single-conjunct unions) in one sweep
        source: PhysicalOp = BitmapUnion()
    else:
        source = IndexProbe() if any(p.indexed for p in plans) \
            else SegmentScan()
        if any(p.residual for p in plans):
            source = FilterBitmap([source])
    if is_nn:
        # planner-chosen dispatch: graph beam-search + exact re-rank,
        # quantized ADC + exact re-rank, fused packed kernel (one launch
        # per batch), or staged per-segment RankScore; the executor
        # groups by the (fused, quantized, graph) flags so a group is
        # always homogeneous
        if all(getattr(p, "graph", False) for p in plans):
            ranker = GraphSearchTopK
        elif all(getattr(p, "quantized", False) for p in plans):
            ranker = QuantizedScanTopK
        elif all(getattr(p, "fused", False) for p in plans):
            ranker = FusedScanTopK
        else:
            ranker = RankScore
        parts = ranker([source]).collect(ctx)
        cands = [Candidates.concat(p) for p in parts]
    else:
        cands = collect_rows(ctx, source)
    cands = VisibilityResolve().apply(ctx, cands)
    cands = MemtableOverlay().apply(ctx, cands)
    if is_nn:
        return TopKMerge().finish(ctx, cands)
    return [materialize(ctx, qq, c) for qq, c in zip(ctx.queries, cands)]


def finish_candidates(ctx: PipelineContext, cands: List[Candidates]
                      ) -> List[List[ResultRow]]:
    """Visibility + memtable overlay + top-k for externally-produced
    candidates (post-filter probes, NRA winner sets)."""
    cands = VisibilityResolve().apply(ctx, cands)
    cands = MemtableOverlay().apply(ctx, cands)
    return TopKMerge().finish(ctx, cands)


# ---------------------------------------------------------------------------
# EXPLAIN tree construction
# ---------------------------------------------------------------------------

def _pred_detail(preds) -> str:
    def one(p):
        if isinstance(p, q.Not):
            return "Not(" + one(p.child) + ")"
        if isinstance(p, (q.And, q.Or)):
            return f"{type(p).__name__}[{len(p.children)}]"
        return type(p).__name__ + ":" + str(getattr(p, "col", "?"))
    return ",".join(one(p) for p in preds)


def build_tree(plan, catalog=None) -> PhysicalOp:
    """Operator tree for a plan — the EXPLAIN structure.  With a catalog,
    nodes carry cost estimates in block-read units; without one (manual
    plans in tests) costs render as 0."""
    have = catalog is not None
    n_segs = len(catalog.store.segments) if have else 0
    total_blocks = catalog.total_blocks if have else 0.0
    mt_rows = catalog.store.memtable_rows if have else 0

    def conj_passing(pl_) -> float:
        if not have:
            return 0.0
        return conjunct_passing(catalog,
                                list(pl_.indexed) + list(pl_.residual))

    passing = conj_passing(plan)
    if plan.subplans:                     # DNF: rows passing ANY conjunct
        passing = min(sum(conj_passing(sp) for sp in plan.subplans),
                      float(catalog.total_rows) if have else 0.0)

    def source(pl_=plan) -> PhysicalOp:
        if pl_.indexed:
            est = sum(catalog.index_probe_blocks(p) for p in pl_.indexed) \
                if have else 0.0
            probe_rows = conjunct_passing(catalog, list(pl_.indexed)) \
                if have else 0.0
            return IndexProbe(detail=_pred_detail(pl_.indexed),
                              est_cost=est, est_rows=probe_rows)
        return SegmentScan(detail=f"{n_segs} segments",
                           est_cost=total_blocks * C_FILTER_BLOCK,
                           est_rows=float(catalog.total_rows)
                           if have else 0.0)

    def with_residual(node: PhysicalOp, pl_=plan) -> PhysicalOp:
        if not pl_.residual:
            return node
        est = conj_passing(pl_) * C_ROW_RESIDUAL * len(pl_.residual)
        return FilterBitmap([node], detail=_pred_detail(pl_.residual),
                            est_cost=est, est_rows=conj_passing(pl_))

    def finishers(node: PhysicalOp, with_topk: bool) -> PhysicalOp:
        node = VisibilityResolve([node], detail="lexsort winners")
        node = MemtableOverlay([node], detail=f"{mt_rows} rows",
                               est_cost=mt_rows / BLOCK_ROWS)
        if with_topk:
            node = TopKMerge([node], detail=f"k={plan.k}",
                             est_cost=C_MERGE * n_segs,
                             est_rows=float(plan.k))
        return node

    def ranker(node: PhysicalOp) -> PhysicalOp:
        """RankScore (staged per-segment kernels), FusedScanTopK (one
        packed launch), QuantizedScanTopK (ADC scan + exact re-rank), or
        GraphSearchTopK (CSR beam search + exact re-rank) per the plan's
        dispatch choice."""
        est = (passing / BLOCK_ROWS) * C_VECTOR_BLOCK * \
            max(1, len(plan.ranks))
        if getattr(plan, "graph", False):
            from repro_torch.core.optimizer.cost import C_GATHER_ROW, C_HOP
            gathered = plan.graph_beam * plan.graph_r * plan.graph_hops / 2
            return GraphSearchTopK(
                [node],
                detail=(f"beam search R={plan.graph_r} "
                        f"beam={plan.graph_beam} hops={plan.graph_hops} "
                        f"-> exact re-rank k={plan.k}"),
                est_cost=(plan.graph_hops * C_HOP
                          + gathered * C_GATHER_ROW
                          + plan.graph_beam * C_RERANK_ROW),
                est_rows=gathered)
        if getattr(plan, "quantized", False):
            d = plan.ranks[0].q.shape[0] if plan.ranks else 1
            ratio = plan.pq_m / max(1.0, 4.0 * d)
            return QuantizedScanTopK(
                [node],
                detail=(f"adc pq m={plan.pq_m} refine={plan.refine} "
                        f"-> exact re-rank k={plan.k}"),
                est_cost=est * ratio + plan.refine * plan.k * C_RERANK_ROW,
                est_rows=passing)
        if plan.fused:
            return FusedScanTopK(
                [node],
                detail=(f"packed {n_segs} segments, k={plan.k}, "
                        f"1 launch (est_launches=1 vs {max(1, n_segs)} "
                        "staged)"),
                est_cost=est, est_rows=passing)
        return RankScore(
            [node], detail=f"{len(plan.ranks)} modalities (batched)",
            est_cost=est, est_rows=passing)

    kind = plan.kind
    if kind == "empty":
        return EmptyResult(detail=plan.note or "unsatisfiable filter")
    if kind in ("union", "union_nn"):
        # one child subtree per DNF conjunct, each with its own costs
        kids = [with_residual(source(sp), sp) for sp in plan.subplans]
        node = BitmapUnion(kids,
                           detail=f"{len(kids)} conjuncts (OR-merge)",
                           est_cost=C_MERGE * n_segs * max(1, len(kids)),
                           est_rows=passing)
        if kind == "union_nn":
            node = ranker(node)
        return finishers(node, with_topk=(kind == "union_nn"))
    if kind in ("full_scan", "index_intersect"):
        return finishers(with_residual(source()), with_topk=False)
    if kind in ("full_scan_nn", "prefilter_nn"):
        node = ranker(with_residual(source()))
        return finishers(node, with_topk=True)
    if kind == "postfilter_nn":
        r = plan.ranks[0] if plan.ranks else None
        probe = IndexProbe(
            detail=f"topk probe:{getattr(r, 'col', '?')}",
            est_cost=catalog.index_probe_blocks(
                q.VectorRange(r.col, r.q, float("inf"))) * C_VECTOR_BLOCK
            if (have and r is not None) else 0.0)
        return finishers(with_residual(probe), with_topk=True)
    if kind == "nra":
        leaves = [IndexProbe(
            detail=f"sorted access:{getattr(r, 'col', '?')}",
            est_cost=0.0) for r in plan.ranks]
        node = NRAMerge(leaves,
                        detail=f"{len(plan.ranks)} modalities",
                        est_cost=C_MERGE * n_segs * max(1, len(plan.ranks)))
        return finishers(node, with_topk=True)
    # unknown kinds (baseline strategies): render the generic scan shape
    node = with_residual(source())
    if plan.ranks:
        node = RankScore([node], detail=f"{len(plan.ranks)} modalities")
    return finishers(node, with_topk=bool(plan.ranks))
