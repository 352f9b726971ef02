"""Scatter-gather query execution across hash-partitioned shards.

``ShardedExecutor`` is the read-path half of the sharded serving
subsystem: a ``HybridQuery`` (or an ``execute_many`` batch) is planned
ONCE against merged shard statistics (a ``Catalog`` over a store view
that concatenates per-shard segments and sums row counts), then every
shard executes the same logical plan through its complete single-store
pipeline — index probes, ``BitmapUnion``, the fused packed scan->top-k
kernel, visibility resolution and the memtable overlay all run per shard
unchanged.  Combination is shape-aware:

  NN      per-shard top-k candidate lists merge ON DEVICE via the
          generalized batched top-k merge kernel (kernels/topk_merge.py)
          in (score, pk) order — shards partition pks, so the merge of
          per-shard top-ks is the exact global top-k and the host never
          handles more than shards * k rows per query;
  filter  shard-wise concatenation re-sorted by the single-store result
          comparator (pk-disjoint, so concat IS the union).

Per-shard ``kops.stats_snapshot()`` dispatch deltas are aggregated into
one ``ExecStats`` per query (plus ``shards`` / ``merge_rows`` /
``shard_rows_max`` fan-out accounting), and EXPLAIN grows a
``ShardFanout(n=N)`` node whose children are the per-shard operator
subtrees costed against each shard's own catalog.  The merge runs on the
router's device.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import operators as ops
from repro_torch.core import query as q
from repro_torch.core.executor import MIN_SHARED_SCAN_BATCH, Executor
from repro_torch.core.operators import ExecStats, ResultRow
from repro_torch.core.optimizer import planner as planner_lib
from repro_torch.core.optimizer.stats import Catalog
from repro_torch.kernels import ops as kops
from repro_torch.obs import REGISTRY, SLOW_LOG
from repro_torch.obs import analyze as obs_analyze
from repro_torch.obs import trace as obs_trace


class _MergedGlobalIndex:
    """Segment pruning over the union of the shards' global indexes —
    serves the merged catalog's cost estimates only; execution prunes
    per shard through each shard's own ``GlobalIndexSet``."""

    def __init__(self, shards):
        self.shards = shards

    def prune(self, segments, predicate) -> List:
        allowed = set()
        for sh in self.shards:
            allowed.update(id(s) for s in
                           sh.global_index.prune(sh.segments, predicate))
        return [s for s in segments if id(s) in allowed]


class _MergedStoreView:
    """Store-shaped facade over all shards for the planner's ``Catalog``:
    concatenated segment list, summed row counts, and the conjunction of
    per-shard ``unique_pks`` flags (routing keeps shard pk sets disjoint,
    so every-shard-unique implies globally unique — the fused dispatch
    gate stays sound)."""

    def __init__(self, router):
        self._router = router
        self.global_index = _MergedGlobalIndex(router.shards)

    @property
    def schema(self):
        return self._router.schema

    @property
    def segments(self) -> List:
        return self._router.all_segments()

    @property
    def n_rows(self) -> int:
        return self._router.n_rows

    @property
    def memtable_rows(self) -> int:
        return self._router.memtable_rows

    @property
    def unique_pks(self) -> bool:
        return self._router.unique_pks


class _ShardSubplan(ops.PhysicalOp):
    """EXPLAIN wrapper for one shard's operator subtree."""
    name = "Shard"


def _tree_cost(node: ops.PhysicalOp) -> float:
    return node.est_cost + sum(_tree_cost(c) for c in node.children)


class ShardedPlan:
    """One logical ``Plan`` chosen on merged shard statistics, plus the
    fan-out EXPLAIN structure.  Duck-types the parts of ``Plan`` the
    facade and benchmarks read (``kind``/``fused``/``cost``/``k``)."""

    def __init__(self, logical: planner_lib.Plan,
                 executor: "ShardedExecutor"):
        self.logical = logical
        self._executor = executor

    @property
    def kind(self) -> str:
        return self.logical.kind

    @property
    def fused(self) -> bool:
        return self.logical.fused

    @property
    def quantized(self) -> bool:
        return self.logical.quantized

    @property
    def pq_m(self) -> int:
        return self.logical.pq_m

    @property
    def refine(self) -> int:
        return self.logical.refine

    @property
    def graph(self) -> bool:
        return self.logical.graph

    @property
    def graph_r(self) -> int:
        return self.logical.graph_r

    @property
    def graph_beam(self) -> int:
        return self.logical.graph_beam

    @property
    def graph_hops(self) -> int:
        return self.logical.graph_hops

    @property
    def cost(self) -> float:
        return self.logical.cost

    @property
    def k(self) -> int:
        return self.logical.k

    @property
    def ranks(self) -> List:
        return self.logical.ranks

    def describe(self) -> str:
        return self._executor.describe(self.logical)


class ShardedExecutor:
    """Executor-shaped driver over N shard ``Executor``s (see module
    docstring for the dataflow)."""

    def __init__(self, store):
        self.store = store                       # ShardRouter
        self.executors = [Executor(sh) for sh in store.shards]
        self.catalog = Catalog(_MergedStoreView(store))
        # facade-visible read-path counters (Database.metrics())
        self.metrics = {"queries": 0, "batches": 0, "merges": 0,
                        "merge_rows": 0, "exec_time_s": 0.0}

    @property
    def n_shards(self) -> int:
        return self.store.n_shards

    # ----------------------------------------------------------- planning
    def plan(self, query: q.HybridQuery) -> ShardedPlan:
        return ShardedPlan(self._plan_logical(query), self)

    def _plan_logical(self, query: q.HybridQuery) -> planner_lib.Plan:
        plan = planner_lib.plan(self.catalog, query)
        if plan.kind == "postfilter_nn":
            # the IVF probe is approximate AND shard-layout-sensitive
            # (per-segment centroid sets differ between shardings), so a
            # post-filter probe would break sharded==single parity;
            # demote to the exact shared-scan shape
            plan = planner_lib.plan_shared_scan(self.catalog, query)
            plan.note = (plan.note + "; " if plan.note else "") + \
                "postfilter demoted under sharding"
            plan.operator_tree(self.catalog)
        return plan

    def _fanout_tree(self, plan: planner_lib.Plan) -> ops.PhysicalOp:
        """The sharded EXPLAIN structure: the combine operator (device
        top-k merge / pk-disjoint concat) over a ``ShardFanout(n=N)``
        node holding per-shard operator subtrees costed against each
        shard's own catalog.  Shared by ``describe`` and EXPLAIN
        ANALYZE's annotated rendering."""
        kids = []
        for i, (sh, ex) in enumerate(zip(self.store.shards,
                                         self.executors)):
            clone = dataclasses.replace(plan, root=None)
            tree = clone.operator_tree(ex.catalog)
            kids.append(_ShardSubplan(
                [tree],
                detail=(f"{i}: {sh.n_rows} rows, "
                        f"{len(sh.segments)} segments"),
                est_cost=_tree_cost(tree)))
        n = self.n_shards
        fan = ops.ShardFanout(kids, detail=f"n={n} hash(pk)",
                              est_cost=max(c.est_cost for c in kids)
                              if kids else 0.0)
        if plan.kind == "empty":
            root: ops.PhysicalOp = plan.operator_tree()
        elif plan.ranks:
            root = ops.CrossShardTopKMerge(
                [fan], detail=(f"k={plan.k} device merge, "
                               f"<={n}*{plan.k} rows to host"),
                est_cost=float(n * max(1, plan.k)),
                est_rows=float(n * max(1, plan.k)))
        else:
            root = ops.ShardConcat([fan], detail="pk-disjoint concat")
        return root

    def describe(self, plan: planner_lib.Plan) -> str:
        """EXPLAIN with the sharded dataflow (see ``_fanout_tree``).
        Rendered once per plan object (plans are immutable after
        planning), so executing a query doesn't rebuild N subtrees on
        every call."""
        cached = getattr(plan, "_sharded_describe", None)
        if cached is not None:
            return cached
        n = self.n_shards
        root = self._fanout_tree(plan)
        if plan.graph:
            disp = (f" dispatch=graph(R={plan.graph_r}, "
                    f"beam={plan.graph_beam}, hops={plan.graph_hops})")
        elif plan.quantized:
            disp = (f" dispatch=quantized(pq m={plan.pq_m}, "
                    f"refine={plan.refine})")
        elif plan.fused:
            disp = " dispatch=fused"
        else:
            disp = ""
        head = (f"sharded:{plan.kind}(shards={n} "
                f"ranks={len(plan.ranks)} cost={plan.cost:.1f}{disp})")
        plan._sharded_describe = head + "\n" + root.explain(1)
        return plan._sharded_describe

    # ---------------------------------------------------------- execution
    def execute(self, query: q.HybridQuery, plan=None
                ) -> Tuple[List[ResultRow], ExecStats]:
        return self.execute_many([query], plans=[plan])[0]

    def explain_analyze(self, query: q.HybridQuery, plan=None
                        ) -> obs_analyze.Analyzed:
        """EXPLAIN ANALYZE across the fan-out: executes under forced
        tracing, then annotates the combine/fanout tree — each ``Shard``
        subtree reads the actuals captured under that shard's ``shard``
        span, so per-shard drift is visible node by node."""
        if isinstance(plan, ShardedPlan):
            logical = plan.logical
        elif plan is not None:
            logical = plan
        else:
            logical = self._plan_logical(query)
        with obs_trace.force_tracing():
            with obs_trace.span("analyze") as root:
                ((results, stats),) = self.execute_many([query],
                                                        plans=[logical])
        actuals = obs_analyze.actuals_from(root)
        per_shard = obs_analyze.shard_actuals(root)
        head = self.describe(logical).splitlines()[0]
        tree = self._fanout_tree(logical)
        text = head + " (analyzed)\n" + tree.explain(
            1, annotate=obs_analyze.make_annotator(actuals, per_shard))
        return obs_analyze.Analyzed(text=text, results=results,
                                    stats=stats, span=root,
                                    actuals=actuals, per_shard=per_shard)

    def execute_many(self, queries: Sequence[q.HybridQuery],
                     plans: Optional[Sequence] = None
                     ) -> List[Tuple[List[ResultRow], ExecStats]]:
        t0 = time.perf_counter()
        with obs_trace.span("query", n=len(queries),
                            shards=self.n_shards) as sp:
            out = self._execute_many(queries, plans)
        elapsed = time.perf_counter() - t0
        self.metrics["queries"] += len(queries)
        self.metrics["batches"] += 1
        self.metrics["exec_time_s"] += elapsed
        REGISTRY.observe("query.latency_s", elapsed)
        REGISTRY.inc("query.count", len(queries))
        if SLOW_LOG.threshold_s is not None and out:
            SLOW_LOG.maybe_record(
                elapsed, out[0][1].plan,
                span=sp if getattr(sp, "live", False) else None,
                n_queries=len(queries), shards=self.n_shards)
        return out

    def _execute_many(self, queries: Sequence[q.HybridQuery],
                      plans: Optional[Sequence] = None
                      ) -> List[Tuple[List[ResultRow], ExecStats]]:
        queries = list(queries)
        given = list(plans) if plans is not None else [None] * len(queries)
        logical: List[planner_lib.Plan] = []
        for qq, p in zip(queries, given):
            if isinstance(p, ShardedPlan):
                p = p.logical
            logical.append(p if p is not None else self._plan_logical(qq))

        # batch-aware re-planning, mirroring Executor.execute_many:
        # enough structurally-identical exact-NN queries make one shared
        # scan per shard cheaper than per-query NRA walks — and unlock
        # the fused packed dispatch the cross-shard merge feeds on
        nra_groups: Dict[tuple, List[int]] = {}
        for i, (qq, p, g) in enumerate(zip(queries, logical, given)):
            if g is None and p.kind == "nra":
                nra_groups.setdefault(
                    ops.rank_signature(qq.ranks), []).append(i)
        for idxs in nra_groups.values():
            if len(idxs) >= MIN_SHARED_SCAN_BATCH:
                for i in idxs:
                    logical[i] = planner_lib.plan_shared_scan(
                        self.catalog, queries[i])
                    logical[i].operator_tree(self.catalog)

        # scatter: every shard executes the whole batch under the SAME
        # logical plans (per-shard executors share this thread, so each
        # shard's kernel-dispatch delta lands in its own ExecStats).
        # Calling the shard executors' inner entry point keeps shard
        # sub-batches out of the facade's query-latency histogram; the
        # per-shard spans scope EXPLAIN ANALYZE's per-shard actuals.
        with obs_trace.span("operator:ShardFanout",
                            n=len(self.executors)):
            per_shard = []
            for i, ex in enumerate(self.executors):
                with obs_trace.span("shard", shard=i):
                    per_shard.append(
                        ex._execute_many(queries, plans=list(logical)))

        # gather: aggregate per-shard ExecStats into one per query
        n = self.n_shards
        described: Dict[int, str] = {}
        stats_all: List[ExecStats] = []
        for i, plan in enumerate(logical):
            if id(plan) not in described:
                described[id(plan)] = self.describe(plan)
            agg = ExecStats(plan=described[id(plan)], shards=n)
            for s in range(n):
                st = per_shard[s][i][1]
                agg.blocks_read += st.blocks_read
                agg.rows_scanned += st.rows_scanned
                agg.kernel_launches += st.kernel_launches
                agg.bytes_to_host += st.bytes_to_host
                agg.bytes_scanned += st.bytes_scanned
                agg.rerank_rows += st.rerank_rows
                agg.jit_shape_misses += st.jit_shape_misses
                agg.shard_rows_max = max(agg.shard_rows_max,
                                         st.rows_scanned)
            stats_all.append(agg)

        # combine: NN queries through the device merge (grouped by k so
        # one batched kernel call serves each group), filter queries by
        # pk-disjoint concatenation
        results: List[Optional[List[ResultRow]]] = [None] * len(queries)
        nn_groups: Dict[int, List[int]] = {}
        for i, (qq, plan) in enumerate(zip(queries, logical)):
            if qq.is_nn and plan.kind != "empty":
                nn_groups.setdefault(qq.k, []).append(i)
            else:
                with obs_trace.span("operator:ShardConcat") as csp:
                    results[i] = self._concat_filter(
                        [per_shard[s][i][0] for s in range(n)])
                    if csp.live:
                        csp.set(out_rows=len(results[i]))
        for k, idxs in nn_groups.items():
            before = kops.stats_snapshot()
            with obs_trace.span("operator:CrossShardTopKMerge",
                                k=k) as msp:
                merged = self._merge_topk(
                    [[per_shard[s][i][0] for s in range(n)]
                     for i in idxs], k)
                if msp.live:
                    msp.set(out_rows=sum(len(m) for m in merged))
            launches, byts, misses = kops.stats_snapshot()
            self.metrics["merges"] += 1
            for i, rows in zip(idxs, merged):
                results[i] = rows
                st = stats_all[i]
                st.kernel_launches += launches - before[0]
                st.bytes_to_host += byts - before[1]
                st.jit_shape_misses += misses - before[2]
                st.merge_rows = sum(len(per_shard[s][i][0])
                                    for s in range(n))
                self.metrics["merge_rows"] += st.merge_rows
        return list(zip(results, stats_all))

    # ------------------------------------------------------------ combine
    @staticmethod
    def _concat_filter(shard_lists: List[List[ResultRow]]
                       ) -> List[ResultRow]:
        rows = [r for rows in shard_lists for r in rows]
        rows.sort(key=lambda r: (r.score, r.pk))
        return rows

    def _merge_topk(self, groups: List[List[List[ResultRow]]], k: int
                    ) -> List[List[ResultRow]]:
        """Merge each query's per-shard top-k lists (already cut to <= k
        and (score, pk)-sorted by the per-shard pipeline) into the global
        top-k via ONE batched device merge; winning pks map back to their
        per-shard ``ResultRow``s, so scores and materialized values are
        byte-identical to the shard pipeline's output."""
        nq, n = len(groups), self.n_shards
        if nq == 0:
            return []
        d = np.full((nq, n, max(1, k)), np.inf, np.float32)
        ids = np.zeros((nq, n, max(1, k)), np.int64)
        lookups: List[Dict[int, ResultRow]] = []
        for qi, shard_lists in enumerate(groups):
            lookup: Dict[int, ResultRow] = {}
            for s, rows in enumerate(shard_lists):
                for j, r in enumerate(rows):
                    d[qi, s, j] = np.float32(r.score)
                    ids[qi, s, j] = r.pk
                    lookup[int(r.pk)] = r
            lookups.append(lookup)
        _, mi = kops.merge_topk_batch(d, ids, k, device=self.store.device)
        return [[lookups[qi][int(pk)] for pk in mi[qi] if pk >= 0]
                for qi in range(nq)]
