"""Continuous queries in the port: ``ContinuousEngine`` in its three modes
(none, fcache, views), the incremental views and their selection,
``ShardedContinuousEngine`` and ``Database.subscribe``/``advance``, on the
CPU, against the JAX package's (default backend).

Both packages get the same put stream, the same updates and deletes and
the same registrations.  At every tick the results must be equal in pk
and score, the same subscriptions must have run, and every installed
view must hold the same contents (spatial pks and points; vector pks,
distances and vectors).  The result checks of
``tests/test_views_continuous.py`` are mirrored on both packages, save the
wall-clock ordering of ``test_engine_modes_speed_ordering``: a CPU timing
says nothing of the port.
"""
import numpy as np
import pytest

from benchmarks import tracy
from repro.core import query as rq
from repro.core.api import Database as RDatabase
from repro.core.continuous import ContinuousEngine as RContinuousEngine
from repro.core.executor import Executor as RExecutor
from repro.core.lsm import LSMConfig as RConfig
from repro.core.lsm import LSMStore as RStore
from repro.core.views import selection as r_sel
from repro_torch.core import query as pq
from repro_torch.core.api import Database as PDatabase
from repro_torch.core.continuous import ContinuousEngine as PContinuousEngine
from repro_torch.core.executor import Executor as PExecutor
from repro_torch.core.lsm import LSMConfig as PConfig
from repro_torch.core.lsm import LSMStore as PStore
from repro_torch.core.shards import ShardedContinuousEngine
from repro_torch.core.views import selection as p_sel
from repro_torch.core.views.view import SpatialRangeView, VectorNNView
from tests.conftest import make_batch, tweet_schema
from tests.test_torch_query import port_config, port_schema, to_port
from tests.test_torch_shards import port_tweet_schema

MODES = ["none", "fcache", "views"]


def _stores(seed, n=2000, flush_rows=512):
    """(reference store, port store on the CPU) fed the put stream of
    ``tests/test_views_continuous.py``'s ``_store``."""
    out = []
    for make in (lambda: RStore(tweet_schema(),
                                RConfig(flush_rows=flush_rows)),
                 lambda: PStore(port_tweet_schema(16),
                                PConfig(flush_rows=flush_rows),
                                device="cpu")):
        rng = np.random.default_rng(seed)
        store = make()
        for i in range(0, n, 500):
            store.put(*make_batch(rng, 500, pk_start=i))
        store.flush()
        out.append(store)
    return out


def _both(stores, fn):
    """Apply one write to each store of the pair."""
    for s in stores:
        fn(s)


def _rows(res):
    return [(r.pk, r.score) for r in res]


def _same_out(r_out, p_out):
    assert sorted(p_out) == sorted(r_out)
    for rid in r_out:
        assert _rows(p_out[rid]) == _rows(r_out[rid])


def _same_views(r_views, p_views):
    """Every installed view holds the same contents in both packages."""
    assert [v.kind for v in p_views] == [v.kind for v in r_views]
    for r, p in zip(r_views, p_views):
        assert (p.col, p.hits) == (r.col, r.hits)
        if isinstance(p, SpatialRangeView):
            assert p.rect == r.rect
            assert p.rows == r.rows
        else:
            assert (p.xk, p.sim_radius) == (r.xk, r.sim_radius)
            np.testing.assert_array_equal(p.center, r.center)
            assert [(d, pk) for d, pk, _ in p.cand] == \
                [(d, pk) for d, pk, _ in r.cand]
            for (_, _, a), (_, _, b) in zip(p.cand, r.cand):
                np.testing.assert_array_equal(a, b)


def _engines(stores, mode, budget=2**22):
    r, p = stores
    return (RContinuousEngine(r, mode=mode, view_budget_bytes=budget),
            PContinuousEngine(p, mode=mode, view_budget_bytes=budget))


def _register(engines, decl):
    r_eng, p_eng = engines
    rid = r_eng.register(decl)
    assert p_eng.register(_port_decl(decl)) == rid
    return rid


def _port_decl(decl):
    if isinstance(decl, rq.SyncQuery):
        return pq.SyncQuery(to_port(decl.query), interval_s=decl.interval_s,
                            name=decl.name)
    return pq.AsyncQuery(to_port(decl.query), name=decl.name)


def _advance(engines, now):
    r_eng, p_eng = engines
    r_out, p_out = r_eng.advance(now), p_eng.advance(now)
    _same_out(r_out, p_out)
    if r_eng.maintainer is not None:
        _same_views(r_eng.maintainer.views, p_eng.maintainer.views)
    return p_out


# ---------------------------------------------------------------------------
# the three modes over a TRACY store under puts, updates and deletes
# ---------------------------------------------------------------------------

def _mix(data):
    """The subscriptions of ``benchmarks/continuous_bench.py`` (vector NN
    and ``GeoWithin`` alternating, SYNC at interval 1), then an ASYNC
    NN + time range and an ASYNC time range + geo."""
    out = []
    for i in range(12):
        if i % 2 == 0:
            out.append(rq.SyncQuery(rq.HybridQuery(
                ranks=[rq.VectorRank("embedding", data.query_vec(), 1.0)],
                k=10), interval_s=1.0))
        else:
            out.append(rq.SyncQuery(rq.HybridQuery(
                where=rq.GeoWithin("coordinate", data.rect(12))),
                interval_s=1.0))
    lo = float(data.rng.uniform(0, 800))
    out.append(rq.AsyncQuery(rq.HybridQuery(
        where=rq.Range("time", lo, lo + 200),
        ranks=[rq.VectorRank("embedding", data.query_vec(), 1.0)], k=10)))
    lo = float(data.rng.uniform(0, 900))
    out.append(rq.AsyncQuery(rq.HybridQuery(
        where=rq.And(rq.Range("time", lo, lo + 50),
                     rq.GeoWithin("coordinate", data.rect(15))))))
    return out


TRACY_CFG = tracy.TracyConfig(n_rows=2048, dim=16, seed=4, flush_rows=512)


def _tracy_pair(cfg=TRACY_CFG):
    ref, data = tracy.build_store(cfg)
    port = PStore(port_schema(cfg.dim), port_config(cfg), device="cpu")
    replay = tracy.TracyData(cfg)
    done = 0
    while done < cfg.n_rows:
        n = min(cfg.flush_rows, 2048, cfg.n_rows - done)
        port.put(*replay.batch(n))
        done += n
    port.flush()
    return (ref, port), data


def _writes(stores, data, next_pk, rng):
    """One round of writes: 256 new rows, updates of 32 live pks and
    deletes of 8, each batch the same on both stores."""
    pks, batch = data.batch(256)
    pks = list(range(next_pk, next_pk + 256))
    _both(stores, lambda s: s.put(pks, batch))
    upd = rng.choice(next_pk, 32, replace=False)
    _, ubatch = data.batch(32)
    _both(stores, lambda s: s.put(upd, ubatch))
    gone = rng.choice(next_pk, 8, replace=False)
    _both(stores, lambda s: s.delete(gone))
    return next_pk + 256


@pytest.mark.parametrize("mode", MODES)
def test_modes_answer_as_the_reference_under_writes(mode):
    stores, data = _tracy_pair()
    engines = _engines(stores, mode, budget=64 * 2**20)
    rids = [_register(engines, d) for d in _mix(data)]
    if mode == "views":
        _same_views(engines[0].maintainer.views, engines[1].maintainer.views)
        assert any(isinstance(v, VectorNNView)
                   for v in engines[1].maintainer.views)
    rng = np.random.default_rng(5)
    next_pk = TRACY_CFG.n_rows
    for tick in range(5):
        if tick:
            next_pk = _writes(stores, data, next_pk, rng)
        out = _advance(engines, float(tick))
        assert set(out) == set(rids)     # every tick follows a write
    r_eng, p_eng = engines
    assert {k: v for k, v in p_eng.metrics.items() if k != "exec_time_s"} \
        == {k: v for k, v in r_eng.metrics.items() if k != "exec_time_s"}
    for rid in rids:
        r, p = r_eng.registered[rid], p_eng.registered[rid]
        assert (p.runs, p.view_hits, p.next_due, p.dirty) == \
            (r.runs, r.view_hits, r.next_due, r.dirty)
    if mode == "views":
        assert p_eng.metrics["view_hits"] > 0


def test_snapshot_query_matches_the_reference():
    stores, data = _tracy_pair()
    for mode in ("none", "views"):
        engines = _engines(stores, mode, budget=64 * 2**20)
        for d in _mix(data)[:4]:
            _register(engines, d)
        for d in _mix(data)[:4]:
            (r_res, r_used), (p_res, p_used) = (
                engines[0].snapshot_query(d.query),
                engines[1].snapshot_query(to_port(d.query)))
            assert _rows(p_res) == _rows(r_res) and p_used == r_used


# ---------------------------------------------------------------------------
# tests/test_views_continuous.py, on both packages
# ---------------------------------------------------------------------------

def test_spatial_view_incremental_equals_rebuild():
    stores = _stores(0)
    engines = _engines(stores, "views")
    rect_q = rq.SyncQuery(rq.HybridQuery(
        where=[rq.GeoWithin("coordinate", (2, 2, 5, 5))]), 1.0)
    _register(engines, rect_q)
    r_eng, p_eng = engines
    views = [v for v in p_eng.maintainer.views
             if isinstance(v, SpatialRangeView)]
    assert views
    v = views[0]
    before = set(v.rows)
    rng = np.random.default_rng(50)
    pks, batch = make_batch(rng, 2, pk_start=50_000)
    batch["coordinate"] = np.asarray([[3.0, 3.0], [9.9, 9.9]], np.float32)
    _both(stores, lambda s: s.put(pks, batch))
    assert 50_000 in v.rows and 50_001 not in v.rows
    _same_views(r_eng.maintainer.views, p_eng.maintainer.views)
    _both(stores, lambda s: s.delete([50_000]))
    assert 50_000 not in v.rows
    assert set(v.rows) == before
    _same_views(r_eng.maintainer.views, p_eng.maintainer.views)
    # the incrementally maintained view equals one rebuilt from the store
    # on every live pk; the rebuild also takes the deleted 50_000 (backfill
    # tests each source's rows alone, and the put sits under its
    # tombstone), which the read path drops
    rebuilt = []
    for Engine, store, decl in (
            (RContinuousEngine, stores[0], rect_q),
            (PContinuousEngine, stores[1], _port_decl(rect_q))):
        eng = Engine(store, mode="views", view_budget_bytes=2**22)
        eng.register(decl)
        rebuilt.append([w for w in eng.maintainer.views
                        if w.kind == "spatial_range"][0])
    assert rebuilt[1].rect == rebuilt[0].rect == v.rect
    assert rebuilt[1].rows == rebuilt[0].rows
    assert {pk: pt for pk, pt in rebuilt[1].rows.items()
            if pk != 50_000} == v.rows


def test_vector_view_contains_true_topxk():
    stores = _stores(1)
    qv = np.random.default_rng(51).normal(size=16).astype(np.float32)
    engines = _engines(stores, "views")
    _register(engines, rq.SyncQuery(rq.HybridQuery(
        ranks=[rq.VectorRank("embedding", qv, 1.0)], k=10), 1.0))
    _same_views(engines[0].maintainer.views, engines[1].maintainer.views)
    store = stores[1]
    v = [v for v in engines[1].maintainer.views
         if isinstance(v, VectorNNView)][0]
    vecs = np.concatenate([s.columns["embedding"] for s in store.segments])
    pks = np.concatenate([s.pk for s in store.segments])
    d = np.sqrt(((vecs - v.center) ** 2).sum(1))
    want = set(pks[np.argsort(d)[:v.xk]].tolist())
    got = set(pk for _, pk, _ in v.cand)
    assert len(got & want) == v.xk


def test_view_results_match_exact_executor():
    stores = _stores(2)
    qv = np.random.default_rng(52).normal(size=16).astype(np.float32)
    decl = rq.SyncQuery(rq.HybridQuery(
        ranks=[rq.VectorRank("embedding", qv, 1.0)], k=10), 1.0)
    engines = _engines(stores, "views")
    rid = _register(engines, decl)
    res = _advance(engines, 0.0)[rid]
    assert engines[1].registered[rid].view_hits == 1
    exact, _ = PExecutor(stores[1]).execute(to_port(decl.query))
    r_exact, _ = RExecutor(stores[0]).execute(decl.query)
    assert [r.pk for r in res] == [r.pk for r in exact] == \
        [r.pk for r in r_exact]


def test_view_freshness_after_writes():
    """New data shows in the next tick (the paper's freshness claim)."""
    stores = _stores(3)
    qv = np.random.default_rng(53).normal(size=16).astype(np.float32)
    engines = _engines(stores, "views")
    rid = _register(engines, rq.SyncQuery(rq.HybridQuery(
        ranks=[rq.VectorRank("embedding", qv, 1.0)], k=5), 1.0))
    _advance(engines, 0.0)
    pks, batch = make_batch(np.random.default_rng(54), 1, pk_start=77_777)
    batch["embedding"] = qv[None, :].copy()
    _both(stores, lambda s: s.put(pks, batch))
    res = _advance(engines, 1.0)[rid]
    assert res[0].pk == 77_777 and res[0].score < 1e-3


@pytest.mark.parametrize("mode", MODES)
def test_async_query_triggers_on_write_only(mode):
    stores = _stores(4)
    engines = _engines(stores, mode)
    rid = _register(engines, rq.AsyncQuery(rq.HybridQuery(
        where=[rq.Range("time", 0, 100)])))
    assert rid in _advance(engines, 0.0)      # dirty at registration
    assert rid not in _advance(engines, 1.0)  # no write: no run
    pks, batch = make_batch(np.random.default_rng(55), 1, pk_start=88_888)
    _both(stores, lambda s: s.put(pks, batch))
    assert rid in _advance(engines, 2.0)      # a write: it runs
    _both(stores, lambda s: s.delete([88_888]))
    out = _advance(engines, 3.0)
    assert rid in out and 88_888 not in {r.pk for r in out[rid]}


@pytest.mark.parametrize("mode", MODES)
def test_sync_interval_schedule(mode):
    stores = _stores(5, n=500)
    engines = _engines(stores, mode)
    rid = _register(engines, rq.SyncQuery(rq.HybridQuery(
        where=[rq.Range("time", 0, 10)]), interval_s=10.0))
    runs = sum(rid in _advance(engines, float(t)) for t in range(0, 35, 5))
    assert runs == 4   # t = 0, 10, 20, 30


def test_knapsack_respects_budget():
    r_store, p_store = _stores(6)
    queries = [rq.HybridQuery(where=[rq.GeoWithin(
        "coordinate", (3 * i, 3 * i, 3 * i + 2, 3 * i + 2))])
        for i in range(3)]
    r_cands = r_sel.build_candidates(r_store, queries)
    cands = p_sel.build_candidates(p_store, [to_port(x) for x in queries])
    assert len(cands) >= 2
    assert [(c.benefit, c.bytes_est, c.members, c.view.rect)
            for c in cands] == [(c.benefit, c.bytes_est, c.members,
                                 c.view.rect) for c in r_cands]
    budget = sum(c.bytes_est for c in cands) / 2
    chosen = p_sel.knapsack_select(cands, budget)
    assert sum(c.bytes_est for c in chosen) <= budget
    assert chosen
    assert [c.view.rect for c in chosen] == \
        [c.view.rect for c in r_sel.knapsack_select(r_cands, budget)]


def test_cluster_spatial_unions_overlaps():
    rects = [(0, 0, 2, 2), (1, 1, 3, 3), (8, 8, 9, 9)]
    clusters = p_sel.cluster_spatial(rects)
    assert clusters == r_sel.cluster_spatial(rects)
    assert len(clusters) == 2
    big = max(clusters, key=lambda c: c[1])
    assert big[0] == (0, 0, 3, 3) and big[1] == 2


# cluster_vectors' centroids: means of the same members in fp32; below
# HOST_FLOP_CUTOFF both packages assign on the host (numpy, bitwise equal),
# above it each its own device path (XLA on the CPU, the plain torch
# version), whose fp32 sums may round apart
CENTROID_RTOL, CENTROID_ATOL = 1e-5, 1e-6


@pytest.mark.parametrize("n,d", [(14, 128), (5000, 128)])
def test_cluster_vectors_centroids_agree(n, d):
    rng = np.random.default_rng(56)
    centres = rng.normal(size=(10, d)).astype(np.float32)
    qvecs = (centres[rng.integers(0, 10, n)]
             + 0.2 * rng.normal(size=(n, d))).astype(np.float32)
    r_out = r_sel.cluster_vectors(qvecs)
    p_out = p_sel.cluster_vectors(qvecs, device="cpu")
    assert [m for _, _, m in p_out] == [m for _, _, m in r_out]
    np.testing.assert_allclose(np.stack([c for c, _, _ in p_out]),
                               np.stack([c for c, _, _ in r_out]),
                               rtol=CENTROID_RTOL, atol=CENTROID_ATOL)
    np.testing.assert_allclose([r for _, r, _ in p_out],
                               [r for _, r, _ in r_out],
                               rtol=CENTROID_RTOL, atol=CENTROID_ATOL)


# ---------------------------------------------------------------------------
# views mode against a fresh execute: what the reference itself does
# ---------------------------------------------------------------------------

def test_spatial_view_keeps_a_row_updated_out_of_its_rect():
    """A spatial view takes a row when a version of it lies inside its
    rectangle (at backfill, from every source's rows; on a put, from the
    delta) and drops it only when the pk is deleted, so a row updated from
    inside the rectangle to outside, before the view is built or after,
    stays in the view with its old point.  The rewrite answers from the
    view's points and keeps that row after a fresh execute has dropped
    it: in the reference as in the port (ROADMAP.md §3)."""
    stores = _stores(7)
    rect = (2.0, 2.0, 5.0, 5.0)
    query = rq.HybridQuery(where=[rq.GeoWithin("coordinate", rect)])
    inside = [r.pk for r in RExecutor(stores[0]).execute(query)[0]]
    rng = np.random.default_rng(57)

    def move_out(pk):
        _, batch = make_batch(rng, 1)
        batch["coordinate"] = np.asarray([[9.5, 9.5]], np.float32)
        _both(stores, lambda s: s.put([pk], batch))

    move_out(inside[0])                 # before the view is built
    engines = _engines(stores, "views")
    rid = _register(engines, rq.SyncQuery(query, 1.0))
    first = {r.pk for r in _advance(engines, 0.0)[rid]}
    move_out(inside[1])                 # after: through the delta hook
    res = {r.pk for r in _advance(engines, 1.0)[rid]}
    assert engines[1].registered[rid].view_hits == 2
    fresh = {r.pk for r in PExecutor(stores[1]).execute(
        to_port(query))[0]}
    r_fresh = {r.pk for r in RExecutor(stores[0]).execute(query)[0]}
    assert fresh == r_fresh == set(inside[2:])
    assert inside[0] in first and res == fresh | set(inside[:2])
    v = [v for v in engines[1].maintainer.views
         if isinstance(v, SpatialRangeView)][0]
    for pk in inside[:2]:
        assert v.covers_point(v.rows[pk])      # the old point


# ---------------------------------------------------------------------------
# subscriptions through both packages' Database
# ---------------------------------------------------------------------------

def _port_tracy_store(cfg):
    store = PStore(port_schema(cfg.dim), port_config(cfg), device="cpu")
    data = tracy.TracyData(cfg)
    done = 0
    while done < cfg.n_rows:
        n = min(cfg.flush_rows, 2048, cfg.n_rows - done)
        store.put(*data.batch(n))
        done += n
    store.flush()
    return store, data


def test_subscribe_matches_continuous_engine():
    """``tests/test_boolean_api.py::test_subscribe_matches_continuous_engine``
    on both packages: the hand-wired engine and the facade's subscriptions
    agree, and the port agrees with the reference."""
    cfg = tracy.TracyConfig(n_rows=2000, dim=32, seed=5, flush_rows=512)
    sides = {}
    for name, build, Engine, Database, qm in (
            ("ref", tracy.build_store, RContinuousEngine, RDatabase, rq),
            ("port", _port_tracy_store, PContinuousEngine,
             lambda **kw: PDatabase(device="cpu", **kw), pq)):
        store_a, data_a = build(cfg)
        eng = Engine(store_a, mode="views", view_budget_bytes=8 * 2**20)
        qv = data_a.query_vec()
        sync_id = eng.register(qm.SyncQuery(qm.HybridQuery(
            ranks=[qm.VectorRank("embedding", qv, 1.0)], k=10),
            interval_s=60.0))
        async_id = eng.register(qm.AsyncQuery(qm.HybridQuery(
            where=qm.Range("time", 900, 1000))))
        store_b, data_b = build(cfg)
        db = Database(view_budget_bytes=8 * 2**20)
        t = db.adopt_store("tweets", store_b)
        sync_sub = (t.query().rank(qm.VectorRank("embedding", qv, 1.0))
                    .limit(10).subscribe(interval_s=60.0))
        async_sub = (t.query().where(qm.Range("time", 900, 1000))
                     .subscribe(on_change=True))
        ticks = []
        clock = 0.0
        for tick in range(3):
            out_a = eng.advance(clock)
            out_b = t.advance(clock)
            assert (sync_id in out_a) == (sync_sub.rid in out_b)
            if sync_id in out_a:
                assert [r.pk for r in out_a[sync_id]] == \
                    [r.pk for r in out_b[sync_sub.rid]]
            ticks.append({rid: _rows(res) for rid, res in out_b.items()})
            if tick == 0:
                pks, batch = data_a.batch(64)
                batch["time"] = np.full(64, 950.0)
                store_a.put(pks, batch)
                pks_b, batch_b = data_b.batch(64)
                batch_b["time"] = batch["time"]
                batch_b["embedding"] = batch["embedding"]
                t.put(pks_b, batch_b)
            clock += 60.0
        fin_a = eng.registered[async_id].last_result
        fin_b = async_sub.latest
        assert sorted(r.pk for r in fin_a) == sorted(r.pk for r in fin_b)
        sync_sub.cancel()
        assert sync_sub.rid not in t.engine.registered
        sides[name] = (ticks, _rows(fin_b), eng.metrics["view_hits"])
    assert sides["port"] == sides["ref"]


def test_fcache_invalidates_when_update_leaves_result():
    """``tests/test_boolean_api.py``'s test on both packages: an update
    that moves a row out of a cached two-predicate result invalidates
    the entry."""
    got = {}
    for name, Store, Config, Engine, qm, kw in (
            ("ref", RStore, RConfig, RContinuousEngine, rq, {}),
            ("port", lambda s, c, **kw: PStore(port_tweet_schema(16), c,
                                              **kw),
             PConfig, PContinuousEngine, pq, {"device": "cpu"})):
        rng = np.random.default_rng(0)
        store = Store(tweet_schema(), Config(flush_rows=10_000), **kw)
        pks, batch = make_batch(rng, 50)
        batch["time"] = np.linspace(0, 100, 50)
        batch["content"] = np.asarray(["apple pie"] * 50, object)
        store.put(pks, batch)
        eng = Engine(store, mode="fcache")
        rid = eng.register(qm.SyncQuery(qm.HybridQuery(
            where=qm.And(qm.Range("time", 0, 10),
                         qm.TextContains("content", "apple"))),
            interval_s=1.0))
        first = eng.advance(0.0)[rid]
        assert first
        victim = first[0].pk
        update = {c: np.asarray([batch[c][victim]]) for c in batch}
        update["time"] = np.asarray([50.0])
        store.put([victim], update)
        second = eng.advance(1.0)[rid]
        assert victim not in {r.pk for r in second}
        got[name] = (_rows(first), _rows(second), eng.metrics["cache_hits"])
    assert got["port"] == got["ref"]


def _db_pair(n_shards, seed, n=450, chunk=150, dim=16, **kw):
    """``tests/test_sharded.py``'s ``_pair`` half: one table per package."""
    out = []
    for make in (lambda: RDatabase(tweet_schema(dim), RConfig(
                     flush_rows=chunk), shards=n_shards, **kw),
                 lambda: PDatabase(port_tweet_schema(dim), PConfig(
                     flush_rows=chunk), shards=n_shards, device="cpu",
                     **kw)):
        rng = np.random.default_rng(seed)
        t = make().table()
        for start in range(0, n, chunk):
            t.put(*make_batch(rng, chunk, dim=dim, pk_start=start))
        out.append(t)
    return out


def test_subscribe_equivalence_vs_single_store():
    """``tests/test_sharded.py``'s test on both packages: a 4-shard table's
    subscriptions (``ShardedContinuousEngine``) answer as a single store's
    in "none" mode, and the port's as the reference's."""
    single = _db_pair(1, 10, continuous_mode="none")
    sharded = _db_pair(4, 10, continuous_mode="none")
    assert isinstance(sharded[1].engine, ShardedContinuousEngine)
    rng = np.random.default_rng(11)
    qv = rng.normal(size=16).astype(np.float32)
    sync_q = rq.HybridQuery(where=rq.Range("time", 0, 50),
                            ranks=[rq.VectorRank("embedding", qv, 1.0)], k=8)
    async_q = rq.HybridQuery(where=rq.TextContains("content", "delta"))
    tables = single + sharded       # ref 1, port 1, ref 4, port 4
    subs = []
    for i, t in enumerate(tables):
        port = i % 2 == 1
        subs.append((t.subscribe(to_port(sync_q) if port else sync_q,
                                 interval_s=60.0),
                     t.subscribe(to_port(async_q) if port else async_q,
                                 on_change=True)))

    def agree():
        want = [_rows(s.latest) for s in subs[0]]
        for pair in subs[1:]:
            assert [_rows(s.latest) for s in pair] == want

    for t in tables:
        t.advance(0.0)
    agree()
    for t in tables:
        t.put(*make_batch(np.random.default_rng(12), 40, dim=16,
                          pk_start=450))
    for t, pair in zip(tables, subs):
        assert set(t.advance(30.0)) == {pair[1].rid}
    for t in tables:
        t.advance(60.0)
    agree()
    assert subs[0][0].latest
    r_eng, p_eng = tables[2].engine, tables[3].engine
    assert p_eng.metrics["executions"] == r_eng.metrics["executions"]
    assert p_eng.metrics["delta_batches"] == r_eng.metrics["delta_batches"]


@pytest.mark.parametrize("with_views", [False, True])
def test_database_advance_ticks_every_subscribed_table(with_views):
    """``Database.advance`` ticks every table that has subscriptions and
    skips the others, in both packages alike."""
    got = []
    for Database, qm, kw in ((RDatabase, rq, {}),
                             (PDatabase, pq, {"device": "cpu"})):
        rng = np.random.default_rng(13)
        db = Database(continuous_mode="views" if with_views else "none",
                      **kw)
        schema = tweet_schema() if qm is rq else port_tweet_schema(16)
        for name in ("a", "b", "c"):
            db.create_table(name, schema).put(*make_batch(rng, 300))
        db.table("a").query().where(qm.GeoWithin(
            "coordinate", (1, 1, 4, 4))).subscribe(interval_s=5.0)
        db.table("b").query().rank(qm.VectorRank(
            "embedding", np.ones(16, np.float32), 1.0)).limit(5) \
            .subscribe(on_change=True)
        ticks = []
        for now in (0.0, 2.0, 5.0):
            out = db.advance(now)
            ticks.append({name: {rid: _rows(res) for rid, res in o.items()}
                          for name, o in out.items()})
        assert set(ticks[0]) == {"a", "b"}
        got.append((ticks, sorted(db.metrics()["tables"]["a"])))
    assert got[0] == got[1]
