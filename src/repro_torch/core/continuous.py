"""Continuous query processing: SYNC (fixed interval) and ASYNC
(data-change-triggered) execution over the incremental-view framework
(paper §2.2 Types 3-4, §6).

The scheduler runs on a virtual clock (test-friendly; the serving driver
maps it to wall time). Three engines, matching the paper's §7.5 setups:

  * "none"   — ARCADE   : re-execute from base tables every time;
  * "fcache" — ARCADE+F : full-result cache, invalidated when a delta
                hits the query's predicate region (prior-work baseline);
  * "views"  — ARCADE+S : incremental materialized views + rewriting
                (the paper's contribution).

Every engine runs its device work on the store's device.
"""
from __future__ import annotations

import dataclasses
import time as _time
from typing import Dict, List, Optional, Tuple

from repro_torch.core import query as q
from repro_torch.core.executor import Executor, eval_predicate_rows
from repro_torch.core.views import rewrite as rw_lib
from repro_torch.core.views.maintenance import ViewMaintainer
from repro_torch.core.views.selection import (build_candidates,
                                              knapsack_select)
from repro_torch.obs import REGISTRY
from repro_torch.obs import trace as obs_trace


@dataclasses.dataclass
class Registered:
    decl: object                   # SyncQuery | AsyncQuery
    next_due: float = 0.0
    dirty: bool = True
    rewrite: Optional[rw_lib.Rewrite] = None
    runs: int = 0
    view_hits: int = 0
    last_result: Optional[List] = None


class _FullResultCache:
    """ARCADE+F baseline: cache complete results per query; a delta that
    may affect the query invalidates its entry.  Predicates are tested
    on ``device``."""

    def __init__(self, device):
        self.device = device
        self.entries: Dict[int, List] = {}

    def invalidate_on_delta(self, registered, batch, deleted) -> None:
        for rid, res in list(self.entries.items()):
            reg = registered.get(rid)
            if reg is None:
                continue
            query = reg.decl.query
            if deleted or batch is None:
                self.entries.pop(rid, None)
                continue
            # conservative: a delta row touching ANY leaf predicate's
            # region may move rows in OR out of the result (an update that
            # fails the full expression can still evict its old version),
            # so leaves are tested individually, never the combined tree
            leaves = q.leaf_predicates(query.where)
            affected = not leaves
            for pred in leaves:
                try:
                    if eval_predicate_rows(batch, pred,
                                           self.device).any():
                        affected = True
                        break
                except Exception:
                    affected = True
                    break
            if affected or query.is_nn:
                self.entries.pop(rid, None)


class ContinuousEngine:
    def __init__(self, store, mode: str = "views",
                 view_budget_bytes: float = 64 * 2**20):
        assert mode in ("none", "fcache", "views")
        self.store = store
        self.mode = mode
        self.executor = Executor(store)
        self.registered: Dict[int, Registered] = {}
        self._next_id = 0
        self.view_budget = view_budget_bytes
        self.maintainer = ViewMaintainer(store) if mode == "views" else None
        self.fcache = _FullResultCache(store.device) \
            if mode == "fcache" else None
        self.metrics = {"executions": 0, "view_hits": 0, "cache_hits": 0,
                        "exec_time_s": 0.0}
        if mode == "fcache":
            store.on_delta(self._fcache_delta)
        store.on_delta(self._mark_async_dirty)

    # --------------------------------------------------------- registration
    def register(self, decl) -> int:
        rid = self._next_id
        self._next_id += 1
        reg = Registered(decl=decl)
        if isinstance(decl, q.SyncQuery):
            reg.next_due = 0.0
        self.registered[rid] = reg
        if self.mode == "views":
            self._reselect_views()
            # static rewrite at registration time (paper §6)
            reg.rewrite = rw_lib.match(self.maintainer.views, decl.query)
        return rid

    def _reselect_views(self) -> None:
        queries = [r.decl.query for r in self.registered.values()]
        cands = build_candidates(self.store, queries)
        chosen = knapsack_select(cands, self.view_budget)
        self.maintainer.install([c.view for c in chosen])
        # re-bind static rewrites for all registered queries
        for reg in self.registered.values():
            reg.rewrite = rw_lib.match(self.maintainer.views,
                                       reg.decl.query)

    # --------------------------------------------------------------- deltas
    def _fcache_delta(self, pks, batch, deleted) -> None:
        if self.fcache is not None:
            self.fcache.invalidate_on_delta(self.registered, batch, deleted)

    def _mark_async_dirty(self, pks, batch, deleted) -> None:
        for reg in self.registered.values():
            if isinstance(reg.decl, q.AsyncQuery):
                reg.dirty = True

    # ------------------------------------------------------------ execution
    def _run_one(self, rid: int, reg: Registered) -> List:
        t0 = _time.perf_counter()
        query = reg.decl.query
        if self.mode == "fcache" and rid in self.fcache.entries:
            self.metrics["cache_hits"] += 1
            res = self.fcache.entries[rid]
        elif self.mode == "views" and reg.rewrite is not None \
                and reg.rewrite.any:
            res, st, used = rw_lib.execute_with_views(
                self.executor, query, reg.rewrite)
            if used:
                reg.view_hits += 1
                self.metrics["view_hits"] += 1
        else:
            res, _ = self.executor.execute(query)
        self._finish_run(rid, reg, res, t0)
        return res

    def _finish_run(self, rid: int, reg: Registered, res: List,
                    t0: float) -> None:
        if self.mode == "fcache":
            self.fcache.entries[rid] = res
        reg.runs += 1
        reg.last_result = res
        self.metrics["executions"] += 1
        self.metrics["exec_time_s"] += _time.perf_counter() - t0

    def _can_batch(self, rid: int, reg: Registered) -> bool:
        """Due queries with no cache/view shortcut go through the shared
        batched scan in ``execute_many``."""
        if self.mode == "fcache" and rid in self.fcache.entries:
            return False
        if self.mode == "views" and reg.rewrite is not None \
                and reg.rewrite.any:
            return False
        return True

    def advance(self, now: float) -> Dict[int, List]:
        """Run everything due at virtual time ``now``; returns results.

        All due queries without a cache/view shortcut execute in ONE
        ``execute_many`` batch, amortizing per-segment scans and stacking
        their query vectors into batched kernel calls.
        """
        adv0 = _time.perf_counter()
        due = []
        for rid, reg in self.registered.items():
            if isinstance(reg.decl, q.SyncQuery):
                if now >= reg.next_due:
                    due.append((rid, reg))
                    reg.next_due = now + reg.decl.interval_s
            else:   # ASYNC: only when data changed
                if reg.dirty:
                    due.append((rid, reg))
                    reg.dirty = False
        out: Dict[int, List] = {}
        with obs_trace.span("advance", due=len(due)):
            batched = [(rid, reg) for rid, reg in due
                       if self._can_batch(rid, reg)]
            for rid, reg in due:
                if not self._can_batch(rid, reg):
                    out[rid] = self._run_one(rid, reg)
            if batched:
                t0 = _time.perf_counter()
                many = self.executor.execute_many(
                    [reg.decl.query for _, reg in batched])
                for (rid, reg), (res, _) in zip(batched, many):
                    out[rid] = res
                    self._finish_run(rid, reg, res, t0)
                    t0 = _time.perf_counter()
        REGISTRY.observe("continuous.advance_s",
                         _time.perf_counter() - adv0)
        REGISTRY.inc("continuous.advances")
        return out

    def snapshot_query(self, query: q.HybridQuery) -> Tuple[List, bool]:
        """One-shot query; in views mode, dynamic runtime matching."""
        if self.mode == "views":
            rw = rw_lib.match(self.maintainer.views, query)
            res, st, used = rw_lib.execute_with_views(self.executor, query,
                                                      rw)
            if used:
                self.metrics["view_hits"] += 1
            return res, used
        res, _ = self.executor.execute(query)
        return res, False
