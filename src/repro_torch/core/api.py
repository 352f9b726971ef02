"""Unified public API facade (paper §2.2: one declarative surface for all
four query types).

ARCADE exposes its engine through a single SQL layer; this module is the
repro's equivalent — a session object that owns the store, executor, and
continuous engine, so callers never hand-wire the three:

    from repro_torch.core.api import (Database, Or, Not, Range,
                                      TextContains, VectorRank)

    db = Database(schema)                  # device="cpu" to run on the host
    t = db.table()
    t.put(pks, batch)

    rows = (t.query()
             .where(Or(Range("time", 0, 5),
                       Not(TextContains("body", "spam"))))
             .rank(VectorRank("emb", qvec))
             .limit(10)
             .all())

    print(t.query().where(...).explain())        # BitmapUnion cost tree
    results = db.execute_many([builder1, builder2, ...])
    sub = t.query().where(...).subscribe(interval_s=60.0)   # Type 3
    sub2 = t.query().where(...).subscribe(on_change=True)   # Type 4
    db.advance(now=60.0)                          # virtual-clock tick
    sub.latest

Filter expressions are arbitrary And/Or/Not trees over the leaf
predicates; the planner normalizes them to DNF and OR-merges per-conjunct
bitmaps with ``BitmapUnion`` (see core/optimizer/planner.py).

Tables run their device work on the card unless built with
``device="cpu"``.  Durability (``path=``, ``snapshot``, ``restore``) is
not ported yet and raises.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

from repro_torch.core import query as q
from repro_torch.core.continuous import ContinuousEngine
from repro_torch.core.executor import Executor
from repro_torch.core.lsm import NO_DURABILITY, LSMConfig, LSMStore
from repro_torch.core.operators import ExecStats, ResultRow
from repro_torch.core.optimizer import planner as planner_lib  # noqa: F401
from repro_torch.core.shards import (ShardedContinuousEngine,
                                     ShardedExecutor, ShardRouter)
# re-exported so `from repro_torch.core.api import ...` is a one-stop import
from repro_torch.core.query import (And, AsyncQuery, GeoWithin,  # noqa: F401
                                    HybridQuery, Not, Or, Range,
                                    SpatialRank, SyncQuery, TextContains,
                                    TextRank, VectorRange, VectorRank)
from repro_torch.core.types import (Column, ColumnType,  # noqa: F401
                                    IndexKind, Schema)
from repro_torch.kernels.ops import Device
from repro_torch.obs import REGISTRY, SLOW_LOG
from repro_torch.obs import analyze as obs_analyze

__all__ = [
    "Database", "Table", "QueryBuilder", "Subscription",
    "And", "Or", "Not", "Range", "GeoWithin", "TextContains", "VectorRange",
    "VectorRank", "SpatialRank", "TextRank", "HybridQuery",
    "Column", "ColumnType", "IndexKind", "Schema", "LSMConfig",
    "ShardRouter", "ShardedExecutor", "ShardedContinuousEngine",
]

DEFAULT_TABLE = "default"


class Subscription:
    """Stream handle for a registered continuous query (Type 3/4).

    ``poll(now)`` advances the table's virtual clock and returns this
    subscription's fresh result if it ran at that tick (else None);
    ``latest`` is the most recent result."""

    def __init__(self, table: "Table", rid: int, decl):
        self.table = table
        self.rid = rid
        self.decl = decl
        self.active = True

    @property
    def latest(self) -> Optional[List[ResultRow]]:
        reg = self.table._engine.registered.get(self.rid) \
            if self.table._engine else None
        return reg.last_result if reg else None

    def poll(self, now: float) -> Optional[List[ResultRow]]:
        return self.table.advance(now).get(self.rid)

    def cancel(self) -> None:
        if self.active and self.table._engine:
            self.table._engine.registered.pop(self.rid, None)
        self.active = False


class QueryBuilder:
    """Fluent builder for one hybrid query against a table.

    ``where`` calls AND-combine; pass ``Or``/``Not`` trees for anything
    richer.  Terminal methods: ``all()``, ``execute()``, ``explain()``,
    ``subscribe()``, ``build()``."""

    def __init__(self, table: "Table"):
        self._table = table
        self._where: Optional[q.BoolExpr] = None
        self._ranks: List[q.RankTerm] = []
        self._k = 10
        self._select: Optional[Sequence[str]] = None
        self._recall_target: Optional[float] = None

    # ------------------------------------------------------------ clauses
    def where(self, *exprs: q.BoolExpr) -> "QueryBuilder":
        for e in exprs:
            self._where = e if self._where is None else \
                q.And((self._where, e))
        return self

    def rank(self, *terms: q.RankTerm,
             recall_target: Optional[float] = None) -> "QueryBuilder":
        """Add rank terms.  ``recall_target`` (in (0, 1]) opts the query
        into approximate dispatch: the planner prices the candidate
        generators it has built for the rank column — the quantized ADC
        stream over PQ codes, or a beam search over the per-segment
        proximity graphs — against the exact scan, and exact-re-ranks
        whichever candidate set wins, so scores stay full-precision
        either way.  Leaving it unset (or 1.0) keeps the exact read
        path."""
        self._ranks.extend(terms)
        if recall_target is not None:
            self._recall_target = float(recall_target)
        return self

    def limit(self, k: int) -> "QueryBuilder":
        self._k = int(k)
        return self

    def select(self, *cols: str) -> "QueryBuilder":
        self._select = list(cols)
        return self

    # ---------------------------------------------------------- terminals
    def build(self) -> q.HybridQuery:
        return q.HybridQuery(where=self._where, ranks=list(self._ranks),
                             k=self._k, select=self._select,
                             recall_target=self._recall_target)

    def plan(self):
        """The table's plan for this query: a ``Plan`` on single-store
        tables, a ``ShardedPlan`` (fan-out + merge) on sharded ones."""
        return self._table.executor.plan(self.build())

    def explain(self, analyze: bool = False
                ) -> Union[str, obs_analyze.Analyzed]:
        """EXPLAIN text: plan summary + operator tree with cost
        estimates (``BitmapUnion`` with per-conjunct costs for OR;
        ``ShardFanout(n=N)`` with per-shard subtrees when sharded).

        ``analyze=True`` is EXPLAIN ANALYZE: the query executes under
        forced tracing and every operator node is annotated with actual
        time / rows / bytes plus estimated-vs-actual row drift.  Returns
        an ``Analyzed`` (prints as the annotated tree; carries the
        results, stats, and span tree)."""
        if analyze:
            return self._table.executor.explain_analyze(self.build())
        return self.plan().describe()

    def execute(self) -> Tuple[List[ResultRow], ExecStats]:
        return self._table.executor.execute(self.build())

    def all(self) -> List[ResultRow]:
        return self.execute()[0]

    def subscribe(self, interval_s: Optional[float] = None,
                  on_change: bool = False, name: str = "") -> Subscription:
        return self._table.subscribe(self.build(), interval_s=interval_s,
                                     on_change=on_change, name=name)


class Table:
    """One table: writes, queries, and continuous subscriptions, with the
    executor and continuous engine owned internally.  Backed by a single
    ``LSMStore`` by default; ``shards=N`` (N > 1) swaps in the sharded
    serving subsystem — a hash-partitioned ``ShardRouter`` store and the
    scatter-gather ``ShardedExecutor`` — behind the same surface.  A new
    store runs on ``device``; an adopted one keeps its own."""

    def __init__(self, name: str, schema: Optional[Schema] = None,
                 cfg: Optional[LSMConfig] = None, *,
                 store: Optional[Union[LSMStore, ShardRouter]] = None,
                 shards: int = 1,
                 continuous_mode: str = "views",
                 view_budget_bytes: float = 64 * 2**20,
                 device: Device = "cuda"):
        if (schema is None) == (store is None):
            raise ValueError("pass exactly one of schema= or store=")
        if store is not None and shards > 1:
            raise ValueError("pass shards= only with schema= (adopted "
                             "stores keep their own partitioning)")
        self.name = name
        if store is not None:
            self.store = store
        elif shards > 1:
            self.store = ShardRouter(schema, cfg, n_shards=shards,
                                     device=device)
        else:
            self.store = LSMStore(schema, cfg, device=device)
        self.executor = ShardedExecutor(self.store) \
            if isinstance(self.store, ShardRouter) else Executor(self.store)
        self.continuous_mode = continuous_mode
        self.view_budget_bytes = view_budget_bytes
        self._engine: Optional[Union[ContinuousEngine,
                                     ShardedContinuousEngine]] = None

    # -------------------------------------------------------------- write
    def put(self, pks: Sequence[int], batch: Dict[str, Any]) -> None:
        """Ingest one columnar batch: dict of numpy arrays, forwarded to
        the store whole — the write path never materializes rows."""
        self.store.put(pks, batch)

    # ``insert`` is the SQL-flavored alias; both forward batches as-is
    insert = put

    def delete(self, pks: Sequence[int]) -> None:
        self.store.delete(pks)

    def flush(self) -> None:
        self.store.flush()

    def drain(self) -> None:
        """Deterministically finish queued flush/compaction work (only
        meaningful with ``LSMConfig(pipeline=True)``)."""
        self.store.drain()

    def close(self) -> None:
        """Stop background flush workers; idempotent (every table of the
        port is process-resident)."""
        self.store.close()

    # --------------------------------------------------------------- read
    def get(self, pk: int) -> Optional[Dict[str, Any]]:
        return self.store.get(pk)

    def query(self) -> QueryBuilder:
        return QueryBuilder(self)

    def execute(self, query: q.HybridQuery
                ) -> Tuple[List[ResultRow], ExecStats]:
        return self.executor.execute(query)

    def execute_many(self, queries: Sequence[Union[q.HybridQuery,
                                                   QueryBuilder]]
                     ) -> List[Tuple[List[ResultRow], ExecStats]]:
        built = [qq.build() if isinstance(qq, QueryBuilder) else qq
                 for qq in queries]
        return self.executor.execute_many(built)

    def explain(self, query: q.HybridQuery, analyze: bool = False
                ) -> Union[str, obs_analyze.Analyzed]:
        if analyze:
            return self.executor.explain_analyze(query)
        return self.executor.plan(query).describe()

    def metrics(self) -> Dict[str, Any]:
        """This table's engine-level metrics: the store's counter dict
        (per-shard dicts keyed by shard id when sharded), plus the
        sharded executor's and continuous engine's counters when they
        exist."""
        out: Dict[str, Any] = {"store": dict(self.store.metrics)}
        if isinstance(self.store, ShardRouter):
            out["shards"] = {i: dict(sh.metrics)
                             for i, sh in enumerate(self.store.shards)}
        if isinstance(self.executor, ShardedExecutor):
            out["executor"] = dict(self.executor.metrics)
        if self._engine is not None:
            out["continuous"] = dict(self._engine.metrics)
        return out

    # --------------------------------------------------------- continuous
    @property
    def engine(self) -> Union[ContinuousEngine, ShardedContinuousEngine]:
        if self._engine is None:
            if isinstance(self.store, ShardRouter):
                # per-shard deltas aggregate into one scheduling state;
                # due queries re-execute via scatter-gather (views do not
                # span shards yet)
                self._engine = ShardedContinuousEngine(
                    self.store, executor=self.executor)
            else:
                self._engine = ContinuousEngine(
                    self.store, mode=self.continuous_mode,
                    view_budget_bytes=self.view_budget_bytes)
        return self._engine

    @property
    def n_shards(self) -> int:
        return self.store.n_shards \
            if isinstance(self.store, ShardRouter) else 1

    def subscribe(self, query: q.HybridQuery,
                  interval_s: Optional[float] = None,
                  on_change: bool = False, name: str = "") -> Subscription:
        """Register a continuous query: ``interval_s`` => SYNC (Type 3),
        ``on_change=True`` => ASYNC (Type 4)."""
        if interval_s is not None and on_change:
            raise ValueError("pass interval_s= OR on_change=True, not both")
        if interval_s is not None:
            decl: Union[q.SyncQuery, q.AsyncQuery] = \
                q.SyncQuery(query, interval_s=float(interval_s), name=name)
        elif on_change:
            decl = q.AsyncQuery(query, name=name)
        else:
            raise ValueError("subscribe() needs interval_s= (SYNC) or "
                             "on_change=True (ASYNC)")
        rid = self.engine.register(decl)
        return Subscription(self, rid, decl)

    def advance(self, now: float) -> Dict[int, List[ResultRow]]:
        """Run everything due at virtual time ``now`` (no-op when nothing
        is subscribed)."""
        if self._engine is None:
            return {}
        return self._engine.advance(now)

    @property
    def n_rows(self) -> int:
        return self.store.n_rows

    @property
    def schema(self) -> Schema:
        return self.store.schema


class Database:
    """Session facade: tables + batched cross-query execution + the
    continuous virtual clock.  ``Database(schema)`` creates a default
    table; ``create_table`` adds named ones.  ``Database(schema,
    shards=N)`` makes the default table a hash-partitioned N-shard LSM
    with transparent scatter-gather execution (core/shards).  Every
    table it creates runs on ``device`` (the card unless ``"cpu"``).

    Durability is not ported yet (ROADMAP queue 1, item 6):
    ``Database(path=...)``, ``snapshot`` and ``restore`` raise
    ``NotImplementedError``."""

    def __init__(self, schema: Optional[Schema] = None,
                 cfg: Optional[LSMConfig] = None, *,
                 path: Optional[str] = None,
                 shards: int = 1,
                 continuous_mode: str = "views",
                 view_budget_bytes: float = 64 * 2**20,
                 device: Device = "cuda"):
        if path is not None:
            raise NotImplementedError(f"Database(path=...): "
                                      f"{NO_DURABILITY}")
        self.continuous_mode = continuous_mode
        self.view_budget_bytes = view_budget_bytes
        self.default_shards = int(shards)
        self.device = device
        self._closed = False
        self._tables: Dict[str, Table] = {}
        if schema is not None:
            self.create_table(DEFAULT_TABLE, schema, cfg)

    # -------------------------------------------------------------- tables
    def create_table(self, name: str, schema: Schema,
                     cfg: Optional[LSMConfig] = None,
                     shards: Optional[int] = None) -> Table:
        if name in self._tables:
            raise ValueError(f"table {name!r} already exists")
        self._tables[name] = Table(
            name, schema, cfg,
            shards=self.default_shards if shards is None else int(shards),
            continuous_mode=self.continuous_mode,
            view_budget_bytes=self.view_budget_bytes, device=self.device)
        return self._tables[name]

    def adopt_store(self, name: str,
                    store: Union[LSMStore, ShardRouter]) -> Table:
        """Wrap an already-built ``LSMStore`` (or ``ShardRouter``) —
        workload builders, benchmarks — as a table of this database; it
        keeps the store's own device."""
        if name in self._tables:
            raise ValueError(f"table {name!r} already exists")
        self._tables[name] = Table(
            name, store=store, continuous_mode=self.continuous_mode,
            view_budget_bytes=self.view_budget_bytes)
        return self._tables[name]

    def table(self, name: str = DEFAULT_TABLE) -> Table:
        if name not in self._tables:
            raise KeyError(f"no table {name!r}; create_table() first "
                           f"(have: {sorted(self._tables)})")
        return self._tables[name]

    @property
    def tables(self) -> Dict[str, Table]:
        return dict(self._tables)

    # ----------------------------------------------------------- execution
    def execute_many(self, queries: Sequence[Union[q.HybridQuery,
                                                   QueryBuilder]]
                     ) -> List[Tuple[List[ResultRow], ExecStats]]:
        """Execute a batch in one shared-scan pass per table.  Builders
        carry their table; bare ``HybridQuery`` objects run against the
        default table.  Results come back in input order."""
        resolved: List[Tuple[Table, q.HybridQuery]] = []
        for item in queries:
            if isinstance(item, QueryBuilder):
                resolved.append((item._table, item.build()))
            else:
                name = DEFAULT_TABLE if DEFAULT_TABLE in self._tables or \
                    len(self._tables) != 1 else next(iter(self._tables))
                resolved.append((self.table(name), item))
        by_table: Dict[str, List[int]] = {}
        for i, (t, _) in enumerate(resolved):
            by_table.setdefault(t.name, []).append(i)
        out: List = [None] * len(resolved)
        for name, idxs in by_table.items():
            t = resolved[idxs[0]][0]
            res = t.executor.execute_many([resolved[i][1] for i in idxs])
            for i, r in zip(idxs, res):
                out[i] = r
        return out

    # ----------------------------------------------------------- continuous
    def advance(self, now: float) -> Dict[str, Dict[int, List[ResultRow]]]:
        """Tick every table's continuous engine at virtual time ``now``."""
        return {name: t.advance(now) for name, t in self._tables.items()
                if t._engine is not None}

    # -------------------------------------------------------- observability
    def metrics(self) -> Dict[str, Any]:
        """Merged observability view: the process-wide registry snapshot
        (counters / gauges / histograms with p50-p99) under
        ``"registry"`` plus each table's engine-level dicts under
        ``"tables"`` (per-shard dicts keyed by shard id when
        sharded)."""
        return {"registry": REGISTRY.snapshot(),
                "tables": {name: t.metrics()
                           for name, t in self._tables.items()}}

    def metrics_text(self) -> str:
        """The registry in Prometheus text exposition format (histogram
        ``_bucket``/``_sum``/``_count`` series plus ``_p50``/``_p95``/
        ``_p99`` gauges) — paste into a scrape endpoint as-is."""
        return REGISTRY.prometheus_text()

    def slow_queries(self) -> List[Dict[str, Any]]:
        """Entries captured by the slow-query log (enable with
        ``obs.SLOW_LOG.configure(threshold_s)``), newest last."""
        return SLOW_LOG.snapshot()

    # ----------------------------------------------------------- lifecycle
    def close(self) -> None:
        """Close every table: stop background flush workers.
        Idempotent; the database object stays readable."""
        if self._closed:
            return
        self._closed = True
        for t in self._tables.values():
            t.close()

    def __enter__(self) -> "Database":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()

    def snapshot(self, path: str) -> None:
        """Not ported yet: raises ``NotImplementedError``."""
        raise NotImplementedError(f"snapshot: {NO_DURABILITY}")

    @classmethod
    def restore(cls, path: str, **kwargs: Any) -> "Database":
        """Not ported yet: raises ``NotImplementedError``."""
        raise NotImplementedError(f"restore: {NO_DURABILITY}")
