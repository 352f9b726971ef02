"""Cost-based plan enumeration for hybrid queries (paper §5).

Filter expressions are normalized to DNF first (``query.where`` may be an
arbitrary And/Or/Not tree over the four leaf predicates).  A single
conjunct plans exactly as before; a disjunction plans every conjunct
independently via the per-subset index enumeration and OR-merges the
per-conjunct bitmaps with the ``BitmapUnion`` operator inside the shared
scan pipeline (plan kinds ``union`` / ``union_nn``).

Hybrid search (Type 1, one conjunct): enumerate every subset of
index-supported literals as the probe set (bitmap intersection), remaining
literals as residuals; compare against a full scan; pick min cost. This is
exactly the "optimal combination of index access paths" claim — single-
index pre-filter and post-filter plans are special cases.

Hybrid NN (Type 2, one conjunct): candidate plans are NRA (Algorithm 1
over unified sorted iterators), pre-filtered exact scan, post-filtered
vector index probe (single vector rank only), and full-scan ranking.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import List, Optional, Sequence

from repro_torch.analysis.plan_validator import maybe_validate
from repro_torch.core import query as q
from repro_torch.core.optimizer import cost as cost_lib
from repro_torch.core.optimizer.stats import Catalog
from repro_torch.core.types import BLOCK_ROWS
from repro_torch.kernels import fused_scan as fs_kernel

# global kill switch for the fused kernel path (benchmarks/tests compare
# against the staged per-segment fallback by flipping this)
FUSED_ENABLED = True


@dataclasses.dataclass
class Plan:
    kind: str                      # full_scan | index_intersect |
    #                                prefilter_nn | postfilter_nn | nra |
    #                                full_scan_nn | union | union_nn
    indexed: List = dataclasses.field(default_factory=list)
    residual: List = dataclasses.field(default_factory=list)
    ranks: List = dataclasses.field(default_factory=list)
    k: int = 0
    cost: float = 0.0
    note: str = ""
    subplans: List["Plan"] = dataclasses.field(default_factory=list)
    #                                one search-shaped plan per DNF conjunct
    fused: bool = False            # scan-NN dispatch: fused packed kernel
    #                                (one launch) vs staged per-segment
    quantized: bool = False        # scan-NN dispatch: PQ-ADC candidate
    #                                generation + exact re-rank (recall-
    #                                bounded; only with a recall_target)
    pq_m: int = 0                  # subquantizers of the quantized dispatch
    refine: int = 0                # exact re-rank factor (k' = refine*k)
    graph: bool = False            # scan-NN dispatch: CSR beam-search
    #                                candidate generation + exact re-rank
    #                                (recall-bounded; only with a
    #                                recall_target and per-segment graphs)
    graph_r: int = 0               # CSR out-degree of the probed graphs
    graph_beam: int = 0            # beam width (survivors re-ranked)
    graph_hops: int = 0            # fixed frontier-expansion count
    root: object = None            # operator tree (operators.PhysicalOp)

    def operator_tree(self, catalog=None):
        """The plan's physical-operator tree; built lazily (without cost
        estimates) for hand-constructed plans."""
        if self.root is None:
            from repro_torch.core import operators as ops_lib
            self.root = ops_lib.build_tree(self, catalog)
        return self.root

    _describe_cache: Optional[str] = dataclasses.field(
        default=None, repr=False, compare=False)

    def describe(self) -> str:
        """EXPLAIN: one summary line followed by the operator tree with
        per-operator cost estimates (block-read units).  Rendered once
        per plan object — a plan is immutable after planning, and the
        executor stamps this string into every query's ``ExecStats``
        (N shards re-describing the same plan would otherwise re-render
        the tree N times)."""
        if self._describe_cache is not None:
            return self._describe_cache
        from repro_torch.core.operators import _pred_detail
        if self.graph:
            disp = (f" dispatch=graph(R={self.graph_r}, "
                    f"beam={self.graph_beam}, hops={self.graph_hops})")
        elif self.quantized:
            disp = (f" dispatch=quantized(pq m={self.pq_m}, "
                    f"refine={self.refine})")
        elif self.fused:
            disp = " dispatch=fused"
        else:
            disp = ""
        if self.subplans:
            head = (f"{self.kind}(conjuncts={len(self.subplans)} "
                    f"ranks={len(self.ranks)} cost={self.cost:.1f}{disp})")
        else:
            ix = _pred_detail(self.indexed)
            rs = _pred_detail(self.residual)
            head = (f"{self.kind}(indexed=[{ix}] residual=[{rs}] "
                    f"ranks={len(self.ranks)} cost={self.cost:.1f}{disp})")
        self._describe_cache = head + "\n" + self.operator_tree().explain(1)
        return self._describe_cache


def _index_supported(catalog: Catalog, p) -> bool:
    # negated literals are residual-only: a NOT probe would complement a
    # bitmap whose cost/selectivity bookkeeping assumes positive matches
    if isinstance(p, q.Not):
        return False
    col = getattr(p, "col", None)
    return col is not None and catalog.has_index(col)


def _plan_conjunct(catalog: Catalog, literals: Sequence) -> Plan:
    """Best search-shaped plan (full_scan | index_intersect) for one
    conjunction of literals — the per-subset index enumeration."""
    filters = list(literals)
    supported = [p for p in filters if _index_supported(catalog, p)]
    best = Plan(kind="full_scan", residual=filters,
                cost=cost_lib.full_scan_cost(catalog, filters).total,
                note="fallback")
    # every non-empty subset of supported predicates as the probe set
    for r in range(1, len(supported) + 1):
        for subset in itertools.combinations(supported, r):
            residual = [p for p in filters if p not in subset]
            c = cost_lib.intersect_cost(catalog, list(subset), residual)
            if c.total < best.cost:
                best = Plan(kind="index_intersect", indexed=list(subset),
                            residual=residual, cost=c.total)
    return best


def _empty_plan(query: q.HybridQuery) -> Plan:
    """DNF normalized to FALSE (e.g. ``And(p, Not(p))``): no row can
    match — distinct from the no-filter case, which scans everything."""
    return Plan(kind="empty", ranks=list(query.ranks), k=query.k,
                cost=0.0, note="unsatisfiable filter (DNF = false)")


def plan_hybrid_search(catalog: Catalog, query: q.HybridQuery) -> Plan:
    conjuncts = q.to_dnf(query.where)
    if not conjuncts:
        return _empty_plan(query)
    if len(conjuncts) > 1:
        return plan_union(catalog, query, conjuncts)
    return _plan_conjunct(catalog, conjuncts[0])


def plan_hybrid_nn(catalog: Catalog, query: q.HybridQuery) -> Plan:
    conjuncts = q.to_dnf(query.where)
    if not conjuncts:
        return _empty_plan(query)
    if len(conjuncts) > 1:
        return plan_union(catalog, query, conjuncts)
    filters = list(conjuncts[0])
    ranks = list(query.ranks)
    k = query.k
    candidates: List[Plan] = []

    # full-scan ranking (always valid)
    fc = cost_lib.full_scan_cost(catalog, filters + ranks)
    candidates.append(Plan(kind="full_scan_nn", residual=filters,
                           ranks=ranks, k=k, cost=fc.total))

    # NRA over sorted iterators — needs an index per rank modality
    if ranks and all(_index_supported(catalog, r) for r in ranks):
        nc = cost_lib.nra_cost(catalog, ranks, filters, k)
        candidates.append(Plan(kind="nra", residual=filters, ranks=ranks,
                               k=k, cost=nc.total))

    # pre-filter: best filter sub-plan, then exact ranking of survivors
    if filters:
        fplan = _plan_conjunct(catalog, filters)
        fcost = cost_lib.PlanCost(blocks=fplan.cost, candidates=0)
        pc = cost_lib.prefilter_nn_cost(catalog, filters, ranks, fcost)
        candidates.append(Plan(kind="prefilter_nn", indexed=fplan.indexed,
                               residual=fplan.residual, ranks=ranks, k=k,
                               cost=pc.total))

    # post-filter: single vector rank via IVF probe, filters applied after
    vec_ranks = [r for r in ranks if isinstance(r, q.VectorRank)]
    if len(ranks) == 1 and len(vec_ranks) == 1 and \
            _index_supported(catalog, vec_ranks[0]):
        oc = cost_lib.postfilter_nn_cost(catalog, vec_ranks[0], filters, k)
        candidates.append(Plan(kind="postfilter_nn", residual=filters,
                               ranks=ranks, k=k, cost=oc.total))

    return min(candidates, key=lambda p: p.cost)


def plan_union(catalog: Catalog, query: q.HybridQuery,
               conjuncts: Optional[List] = None) -> Plan:
    """Disjunctive plan: one search-shaped sub-plan per DNF conjunct,
    OR-merged by ``BitmapUnion``; NN queries rank the merged bitmap
    (prefilter shape), so batching and EXPLAIN work unchanged."""
    if conjuncts is None:
        conjuncts = q.to_dnf(query.where)
    subs = [_plan_conjunct(catalog, list(c)) for c in conjuncts]
    total = sum(s.cost for s in subs)
    ranks = list(query.ranks)
    if not ranks:
        return Plan(kind="union", subplans=subs, cost=total,
                    note=f"{len(subs)} conjuncts")
    # rows passing ANY conjunct get exact-ranked (union selectivity bound)
    passing = min(float(catalog.total_rows),
                  sum(cost_lib.conjunct_passing(catalog, list(c))
                      for c in conjuncts))
    rank_blocks = (passing / BLOCK_ROWS) * cost_lib.C_VECTOR_BLOCK * \
        max(1, len(ranks))
    return Plan(kind="union_nn", subplans=subs, ranks=ranks, k=query.k,
                cost=total + rank_blocks + passing * cost_lib.C_ROW_RESIDUAL,
                note=f"{len(subs)} conjuncts")


def _fusable(catalog: Catalog, query: q.HybridQuery) -> bool:
    """Can this query take the fused packed scan->top-k kernel path?

    The fused kernel cuts to k ON DEVICE, before visibility resolution,
    so it is only sound when no candidate can be shadowed by a newer
    version (``unique_pks``).  It ranks by a single monotone distance —
    one positive-weight vector/spatial term — and tie-breaks by pk in
    int32 registers."""
    if not FUSED_ENABLED or len(query.ranks) != 1:
        return False
    r = query.ranks[0]
    if not isinstance(r, (q.VectorRank, q.SpatialRank)) or not r.weight > 0:
        return False
    if not 0 < query.k <= fs_kernel.KMAX:
        return False
    store = catalog.store
    if not store.unique_pks or not store.segments:
        return False
    return max(s.pk_max for s in store.segments) < int(fs_kernel.SENTINEL)


def _quantized_params(catalog: Catalog, query: q.HybridQuery):
    """(pq_m, refine) when the quantized dispatch is admissible for this
    query, else None.  Requires an explicit per-query ``recall_target``
    below 1.0 (the default contract stays exact), a single vector rank
    whose column carries PQ codes on EVERY visible segment (same m), and
    room for the k' = refine*k survivor set in the kernel's top-k
    registers.  Codebook identity across segments is re-checked at pack
    time (``pack_quantized``) — a mixed-book store falls back to the
    exact scan at execution, never to wrong answers."""
    rt = getattr(query, "recall_target", None)
    if rt is None or rt >= 1.0:
        return None
    r = query.ranks[0]
    if not isinstance(r, q.VectorRank):
        return None
    qcols = [s.quantized.get(r.col) if hasattr(s, "quantized") else None
             for s in catalog.store.segments]
    if not qcols or any(c is None or not len(c.codes) for c in qcols):
        return None
    ms = {c.m for c in qcols}
    if len(ms) != 1:
        return None
    # looser targets need fewer survivors re-ranked; the refine ladder is
    # deliberately coarse — recall is monotone in refine and the exact
    # re-rank makes every tier sound, just not equally cheap
    refine = 4 if rt <= 0.95 else (8 if rt <= 0.99 else 16)
    while refine >= 2 and refine * query.k > fs_kernel.KMAX:
        refine //= 2
    if refine < 2:
        return None
    return ms.pop(), refine


def _graph_params(catalog: Catalog, query: q.HybridQuery):
    """(r_degree, beam, hops) when the graph dispatch is admissible for
    this query, else None.  Requires an explicit per-query
    ``recall_target`` below 1.0 (the default contract stays exact) and a
    single vector rank whose column carries a built proximity graph on
    EVERY visible segment — a segment without a graph would silently
    fall back to scanning, voiding the cost advantage (execution still
    checks at pack time and falls back to the exact scan, never to wrong
    answers).  The beam ladder widens with the target: tighter recall
    needs more survivors re-ranked, and the fixed hop count grows so the
    traversal converges before the cut."""
    rt = getattr(query, "recall_target", None)
    if rt is None or rt >= 1.0:
        return None
    r = query.ranks[0]
    if not isinstance(r, q.VectorRank):
        return None
    segs = [s for s in catalog.store.segments if s.n_rows]
    if not segs:
        return None
    idxs = [s.indexes.get(r.col) for s in segs]
    if any(ix is None or getattr(ix, "kind", None) != "graph"
           or getattr(ix, "neighbors", None) is None for ix in idxs):
        return None
    r_deg = max(int(ix.R) for ix in idxs)
    base = 2 if rt <= 0.9 else (4 if rt <= 0.95 else 8)
    beam = min(int(fs_kernel.KMAX), max(32, base * query.k))
    if beam < query.k:
        return None
    hops = 8 if rt <= 0.95 else 10
    return r_deg, beam, hops


def _choose_dispatch(catalog: Catalog, plan: Plan,
                     query: q.HybridQuery) -> Plan:
    """Physical dispatch choice for scan-shaped NN plans: fused packed
    kernel (one launch, (nq, k) back to host) vs staged per-segment
    kernels (one launch per segment, full distance rows back).  Both
    costs are charged ON TOP of the already-chosen logical plan so the
    kind selection above is undisturbed; EXPLAIN surfaces the choice."""
    if plan.kind not in ("full_scan_nn", "prefilter_nn", "union_nn"):
        return plan
    if plan.subplans:
        passing = min(float(catalog.total_rows),
                      sum(cost_lib.conjunct_passing(
                          catalog, list(sp.indexed) + list(sp.residual))
                          for sp in plan.subplans))
    else:
        passing = cost_lib.conjunct_passing(
            catalog, list(plan.indexed) + list(plan.residual))
    staged = cost_lib.staged_dispatch_cost(catalog, passing)
    if not _fusable(catalog, query):
        plan.cost += staged
        return plan
    fused = cost_lib.fused_dispatch_cost(catalog, passing, query.k)
    gp = _graph_params(catalog, query)
    qp = _quantized_params(catalog, query)
    quant = None
    if qp is not None:
        pq_m, refine = qp
        d = query.ranks[0].q.shape[0]
        quant = cost_lib.quantized_dispatch_cost(
            catalog, passing, query.k, refine,
            code_ratio=pq_m / (4.0 * d))
    if gp is not None:
        r_deg, beam, hops = gp
        graph = cost_lib.graph_dispatch_cost(
            catalog, passing, query.k, beam, hops, r_deg)
        if graph <= fused and graph < staged and \
                (quant is None or graph <= quant):
            plan.graph = True
            plan.graph_r = r_deg
            plan.graph_beam = beam
            plan.graph_hops = hops
            plan.cost += graph
            return plan
    if quant is not None and quant <= fused and quant < staged:
        plan.quantized = True
        plan.pq_m = pq_m
        plan.refine = refine
        plan.cost += quant
        return plan
    if fused < staged:
        plan.fused = True
        plan.cost += fused
    else:
        plan.cost += staged
    return plan


def plan_shared_scan(catalog: Catalog, query: q.HybridQuery) -> Plan:
    """Batch-aware physical choice: when many structurally-identical exact
    NN queries execute together, one shared segment sweep with batched
    distance kernels beats N independent sorted-access (NRA) walks — the
    per-segment scan and the ``l2_distances(Q, X)`` call are paid once for
    the whole batch.  Returns the scan-shaped plan for one member."""
    conjuncts = q.to_dnf(query.where)
    if not conjuncts:
        return _empty_plan(query)
    if len(conjuncts) > 1:
        return _choose_dispatch(catalog,
                                plan_union(catalog, query, conjuncts),
                                query)
    filters = list(conjuncts[0])
    if filters:
        fplan = _plan_conjunct(catalog, filters)
        c = cost_lib.prefilter_nn_cost(
            catalog, filters, list(query.ranks),
            cost_lib.PlanCost(blocks=fplan.cost, candidates=0))
        chosen = Plan(kind="prefilter_nn", indexed=fplan.indexed,
                      residual=fplan.residual, ranks=list(query.ranks),
                      k=query.k, cost=c.total, note="batched shared scan")
    else:
        c = cost_lib.full_scan_cost(catalog, list(query.ranks))
        chosen = Plan(kind="full_scan_nn", ranks=list(query.ranks),
                      k=query.k, cost=c.total, note="batched shared scan")
    return maybe_validate(_choose_dispatch(catalog, chosen, query))


def plan(catalog: Catalog, query: q.HybridQuery) -> Plan:
    if query.is_nn:
        chosen = _choose_dispatch(catalog, plan_hybrid_nn(catalog, query),
                                  query)
        if not (chosen.quantized or chosen.graph) and \
                getattr(query, "recall_target", None) is not None:
            # the logical-kind choice above compares exact-scan costs, so
            # an index walk (nra/postfilter) can shadow the quantized or
            # graph scan even though those dispatches touch a fraction
            # of the bytes; re-price the scan shape with its recall-
            # bounded dispatch and switch when that wins
            alt = plan_shared_scan(catalog, query)
            if (alt.quantized or alt.graph) and alt.cost < chosen.cost:
                chosen = alt
    else:
        chosen = plan_hybrid_search(catalog, query)
    chosen.operator_tree(catalog)      # attach EXPLAIN tree with estimates
    return maybe_validate(chosen)
