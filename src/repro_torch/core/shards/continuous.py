"""Continuous queries over a sharded table (paper Types 3/4, scaled out).

Aggregates per-shard write deltas into one scheduling state: every
shard's ``on_delta`` hook feeds the same engine, so an ASYNC subscription
goes dirty when ANY shard ingests, and due queries re-execute through the
scatter-gather ``ShardedExecutor`` in a single ``execute_many`` batch
(amortizing each shard's segment sweep across all due queries, exactly
like the single-store engine).

Semantics match ``ContinuousEngine(mode="none")``: full re-execution per
due tick.  Incremental materialized views do not span shards yet —
per-shard view maintenance with cross-shard rewrite is a future PR; the
registration/advance surface is identical so the facade's
``Subscription`` handles work unchanged.
"""
from __future__ import annotations

import time as _time
from typing import Dict, List, Tuple

from repro_torch.core import query as q
from repro_torch.core.continuous import Registered
from repro_torch.obs import REGISTRY
from repro_torch.obs import trace as obs_trace


class ShardedContinuousEngine:
    mode = "none"

    def __init__(self, store, executor=None):
        from repro_torch.core.shards.executor import ShardedExecutor
        self.store = store                       # ShardRouter
        self.executor = executor if executor is not None \
            else ShardedExecutor(store)
        self.registered: Dict[int, Registered] = {}
        self._next_id = 0
        self.metrics = {"executions": 0, "exec_time_s": 0.0,
                        "delta_batches": 0}
        store.on_delta(self._on_delta)           # hooked on EVERY shard

    # --------------------------------------------------------- registration
    def register(self, decl) -> int:
        rid = self._next_id
        self._next_id += 1
        reg = Registered(decl=decl)
        if isinstance(reg.decl, q.SyncQuery):
            reg.next_due = 0.0
        self.registered[rid] = reg
        return rid

    # --------------------------------------------------------------- deltas
    def _on_delta(self, pks, batch, deleted) -> None:
        """One call per shard sub-batch; any shard's write dirties every
        ASYNC subscription (the query may match rows on that shard)."""
        self.metrics["delta_batches"] += 1
        for reg in self.registered.values():
            if isinstance(reg.decl, q.AsyncQuery):
                reg.dirty = True

    # ------------------------------------------------------------ execution
    def advance(self, now: float) -> Dict[int, List]:
        """Run everything due at virtual time ``now``: SYNC queries by
        interval, ASYNC queries when any shard changed since their last
        run.  All due queries share one scatter-gather batch."""
        due: List[Tuple[int, Registered]] = []
        for rid, reg in self.registered.items():
            if isinstance(reg.decl, q.SyncQuery):
                if now >= reg.next_due:
                    due.append((rid, reg))
                    reg.next_due = now + reg.decl.interval_s
            else:
                if reg.dirty:
                    due.append((rid, reg))
                    reg.dirty = False
        out: Dict[int, List] = {}
        if not due:
            return out
        adv0 = _time.perf_counter()
        with obs_trace.span("advance", due=len(due)):
            t0 = _time.perf_counter()
            many = self.executor.execute_many(
                [reg.decl.query for _, reg in due])
            for (rid, reg), (res, _) in zip(due, many):
                out[rid] = res
                reg.runs += 1
                reg.last_result = res
                self.metrics["executions"] += 1
                self.metrics["exec_time_s"] += _time.perf_counter() - t0
                t0 = _time.perf_counter()
        REGISTRY.observe("continuous.advance_s",
                         _time.perf_counter() - adv0)
        REGISTRY.inc("continuous.advances")
        return out

    def snapshot_query(self, query: q.HybridQuery) -> Tuple[List, bool]:
        """One-shot scatter-gather execution (no view rewriting)."""
        res, _ = self.executor.execute(query)
        return res, False
