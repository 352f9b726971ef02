"""Physical plan execution over the LSM store (paper §5).

The executor is a thin driver over the composable operator pipeline in
``core.operators``: plans become operator trees, operators pass columnar
batches, and visibility is resolved by the shared lexsort winner set in
``core.visibility``.

``execute_many`` is the primary entry point: a batch of concurrent
queries shares per-segment scans (each predicate bitmap computed once per
batch) and stacks its query vectors into single batched
``l2_distances(Q, X)`` kernel calls.  ``execute`` is the batch-of-one
special case.  Counters (blocks_read, rows_scanned) validate the cost
model in benchmarks.  Kernel work runs on the store's device.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core import operators as ops
from repro_torch.core import query as q
from repro_torch.core.operators import (Candidates, ExecStats,  # noqa: F401
                                  PipelineContext, ResultRow,
                                  combined_scores, eval_expr_rows,
                                  eval_predicate_rows, eval_predicate_seg,
                                  rank_distances)
from repro_torch.core.optimizer import planner as planner_lib
from repro_torch.core.optimizer.stats import Catalog
from repro_torch.kernels import ops as kops
from repro_torch.obs import REGISTRY, SLOW_LOG
from repro_torch.obs import analyze as obs_analyze
from repro_torch.obs import trace as obs_trace


def _charge_kernel_stats(stats_list, before) -> None:
    """Attribute the kernel-dispatch delta since ``before`` (a
    ``kops.stats_snapshot()``) to every query in the executed unit —
    the same full-delta sharing policy blocks_read uses for cached
    bitmaps, so per-query stats stay comparable across batch sizes."""
    launches, byts, misses = kops.stats_snapshot()
    for st in stats_list:
        st.kernel_launches += launches - before[0]
        st.bytes_to_host += byts - before[1]
        st.jit_shape_misses += misses - before[2]


# a group of this many structurally-identical exact NN queries is executed
# as one shared segment sweep even when the per-query optimum is NRA
MIN_SHARED_SCAN_BATCH = 4


class Executor:
    def __init__(self, store):
        self.store = store
        self.catalog = Catalog(store)

    # ------------------------------------------------------------- public
    def plan(self, query: q.HybridQuery) -> planner_lib.Plan:
        """Plan one query against this executor's catalog (the facade's
        EXPLAIN entry point; ShardedExecutor overrides it with the
        fan-out plan)."""
        return planner_lib.plan(self.catalog, query)

    def execute(self, query: q.HybridQuery,
                plan: Optional[planner_lib.Plan] = None
                ) -> Tuple[List[ResultRow], ExecStats]:
        return self.execute_many([query], plans=[plan])[0]

    def explain_analyze(self, query: q.HybridQuery,
                        plan: Optional[planner_lib.Plan] = None
                        ) -> obs_analyze.Analyzed:
        """EXPLAIN ANALYZE: execute the query under forced tracing and
        annotate the plan's operator tree with actual rows / bytes /
        time per node plus estimated-vs-actual row drift.  Results are
        bitwise-identical to a plain ``execute`` — tracing observes the
        pipeline, it never changes dispatch or arithmetic."""
        plan = plan if plan is not None else self.plan(query)
        with obs_trace.force_tracing():
            with obs_trace.span("analyze") as root:
                ((results, stats),) = self.execute_many([query],
                                                        plans=[plan])
        actuals = obs_analyze.actuals_from(root)
        head = plan.describe().splitlines()[0]
        # fresh tree against the live catalog (never the plan's cached
        # root, which may have been built without cost estimates)
        tree = ops.build_tree(plan, self.catalog)
        text = head + " (analyzed)\n" + tree.explain(
            1, annotate=obs_analyze.make_annotator(actuals))
        return obs_analyze.Analyzed(text=text, results=results,
                                    stats=stats, span=root,
                                    actuals=actuals)

    def _observe_query(self, n_queries: int, elapsed_s: float,
                       out, sp) -> None:
        """Facade-level telemetry for one ``execute_many`` call: the
        query-latency histogram, throughput counters, and the slow-query
        log (plan + span tree when tracing was on)."""
        REGISTRY.observe("query.latency_s", elapsed_s)
        REGISTRY.inc("query.count", n_queries)
        kops.flush_registry_counters()
        if SLOW_LOG.threshold_s is not None and out:
            SLOW_LOG.maybe_record(
                elapsed_s, out[0][1].plan,
                span=sp if getattr(sp, "live", False) else None,
                n_queries=n_queries)

    def execute_many(self, queries: List[q.HybridQuery],
                     plans: Optional[List[Optional[planner_lib.Plan]]] = None
                     ) -> List[Tuple[List[ResultRow], ExecStats]]:
        t0 = time.perf_counter()
        with obs_trace.span("query", n=len(queries)) as sp:
            out = self._execute_many(queries, plans)
        self._observe_query(len(queries), time.perf_counter() - t0,
                            out, sp)
        return out

    def _execute_many(self, queries: List[q.HybridQuery],
                      plans: Optional[
                          List[Optional[planner_lib.Plan]]] = None
                      ) -> List[Tuple[List[ResultRow], ExecStats]]:
        """Execute a batch of queries with shared per-segment scans.

        Queries whose plans are scan-based (full_scan, index_intersect,
        full_scan_nn, prefilter_nn, and the DNF union / union_nn kinds)
        and — for NN queries — share a rank signature are grouped into one
        pipeline pass; the rest (nra, postfilter_nn) run individually but
        still share the batch-level predicate-bitmap cache.
        """
        given = list(plans) if plans is not None else [None] * len(queries)

        # subclasses customizing dispatch (the benchmark baseline
        # strategies) measure THEIR design point: run them query by query,
        # with no cross-query sharing.  An execute() override owns its own
        # planning, so it gets only the caller-given plan (and must not
        # delegate back to execute_many).
        if type(self).execute is not Executor.execute:
            return [self.execute(qq, p) for qq, p in zip(queries, given)]

        plans = [p or planner_lib.plan(self.catalog, qq)
                 for p, qq in zip(given, queries)]

        if (type(self)._exec_nn is not Executor._exec_nn
                or type(self)._exec_filter is not Executor._exec_filter):
            out = []
            for qq, plan in zip(queries, plans):
                st = ExecStats(plan=plan.describe())
                before = kops.stats_snapshot()
                res = self._exec_nn(qq, plan, st) if qq.is_nn \
                    else self._exec_filter(qq, plan, st)
                _charge_kernel_stats([st], before)
                out.append((res, st))
            return out

        results: List[Optional[List[ResultRow]]] = [None] * len(queries)

        groups: Dict[tuple, List[int]] = {}
        solo: List[int] = []
        empty: List[int] = []
        for i, (qq, plan) in enumerate(zip(queries, plans)):
            if plan.kind == "empty":
                empty.append(i)
            elif plan.kind in ("full_scan", "index_intersect",
                               "full_scan_nn", "prefilter_nn",
                               "union", "union_nn"):
                # a group must share rank structure (NN members stack
                # their query vectors into one kernel call) AND dispatch
                # mode (fused vs staged take different operators)
                key = ("nn", ops.rank_signature(qq.ranks), plan.fused,
                       getattr(plan, "quantized", False),
                       getattr(plan, "graph", False)) \
                    if qq.ranks else ("filter",)
                groups.setdefault(key, []).append(i)
            elif plan.kind == "nra" and given[i] is None:
                # planner-chosen NRA may be re-planned batch-aware below
                groups.setdefault(
                    ("nra", ops.rank_signature(qq.ranks)), []).append(i)
            else:
                solo.append(i)

        # batch-aware re-planning: enough structurally-identical exact NN
        # queries make one shared scan cheaper than N sorted-access walks
        for key in [k for k in groups if k[0] == "nra"]:
            idxs = groups.pop(key)
            if len(idxs) >= MIN_SHARED_SCAN_BATCH:
                for i in idxs:
                    plans[i] = planner_lib.plan_shared_scan(
                        self.catalog, queries[i])
                    groups.setdefault(
                        ("nn", key[1], plans[i].fused,
                         getattr(plans[i], "quantized", False),
                         getattr(plans[i], "graph", False)),
                        []).append(i)
            else:
                solo.extend(idxs)

        stats = [ExecStats(plan=p.describe()) for p in plans]
        pred_cache: Dict = {}
        for i in empty:
            results[i] = []
        for i in solo:
            before = kops.stats_snapshot()
            results[i] = self._exec_nn(queries[i], plans[i], stats[i],
                                       pred_cache)
            _charge_kernel_stats([stats[i]], before)
        for idxs in groups.values():
            before = kops.stats_snapshot()
            group_res = ops.run_scan_group(
                self.store, self.catalog,
                [queries[i] for i in idxs], [plans[i] for i in idxs],
                [stats[i] for i in idxs], pred_cache)
            _charge_kernel_stats([stats[i] for i in idxs], before)
            for i, res in zip(idxs, group_res):
                results[i] = res
        return list(zip(results, stats))

    # ----------------------------------------------------- plan dispatch
    def _exec_filter(self, query, plan, stats,
                     pred_cache: Optional[Dict] = None) -> List[ResultRow]:
        if plan.kind == "empty":
            return []
        return ops.run_scan_group(self.store, self.catalog, [query], [plan],
                                  [stats], pred_cache)[0]

    def _exec_nn(self, query, plan, stats,
                 pred_cache: Optional[Dict] = None) -> List[ResultRow]:
        if plan.kind == "empty":
            return []
        if plan.kind in ("full_scan", "index_intersect", "union"):
            return self._exec_filter(query, plan, stats, pred_cache)
        if plan.kind == "nra":
            from repro_torch.core.nra import nra_topk
            with obs_trace.span("operator:NRAMerge"):
                return nra_topk(self.store, self.catalog, query, stats)
        if plan.kind == "postfilter_nn":
            return self._postfilter_nn(query, plan, stats, pred_cache)
        # prefilter / full-scan: filter then exact-rank survivors
        return self._prefilter_nn(query, plan, stats, pred_cache)

    def _prefilter_nn(self, query, plan, stats,
                      pred_cache: Optional[Dict] = None) -> List[ResultRow]:
        return ops.run_scan_group(self.store, self.catalog, [query], [plan],
                                  [stats], pred_cache)[0]

    def _postfilter_nn(self, query, plan, stats,
                       pred_cache: Optional[Dict] = None) -> List[ResultRow]:
        """Vector-index top-k probe, filters applied after; the probe depth
        inflates until k survivors remain (or the probe saturates)."""
        rank = query.ranks[0]
        k = query.k
        inflate = 4
        cand = Candidates.empty()
        with obs_trace.span("operator:IndexProbe", probe=rank.col) as sp:
            while True:
                parts: List[Candidates] = []
                n_survivors = 0
                for seg in self.store.segments:
                    idx = seg.indexes.get(rank.col)
                    if idx is None:
                        continue
                    d, rows, br = idx.search(
                        np.asarray(rank.q, np.float32), k * inflate)
                    stats.blocks_read += br
                    if sp.live:
                        sp.add("blocks", br)
                    if not len(rows):
                        continue
                    vals = {c: seg.columns[c][rows] for c in seg.columns}
                    keep = eval_expr_rows(vals, query.where,
                                          self.store.device)
                    stats.rows_scanned += len(rows)
                    if sp.live:
                        sp.add("rows", len(rows))
                    n_survivors += int(keep.sum())
                    parts.append(Candidates(
                        np.full(int(keep.sum()), seg.seg_id, np.int64),
                        rows[keep].astype(np.int64),
                        (d[keep] * rank.weight).astype(np.float32)))
                cand = Candidates.concat(parts)
                if n_survivors >= k or inflate >= 64:
                    break
                inflate *= 4
            if sp.live:
                sp.set(out_rows=len(cand.scores))
        ctx = PipelineContext(self.store, self.catalog, [query], [plan],
                              [stats], pred_cache)
        return ops.finish_candidates(ctx, [cand])[0]
