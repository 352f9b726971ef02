"""The port's ``Database`` facade (``repro_torch.core.api``) against the JAX
package's, on the CPU: the north star's gate.

Both facades get the same seeded TRACY put stream at
``tests/test_torch_query.py``'s size (8,000 rows, dim 16), at 1, 2 and 4
shards, and the port runs with ``device="cpu"``; the reference runs its
default backend.  Every TRACY template (``tracy.make_templates``), and the
recall-targeted graph templates (``tracy.make_graph_templates``) on a GRAPH
table, go through ``Database.execute_many`` as ``QueryBuilder``s.  At this
size every distance is below ``HOST_FLOP_CUTOFF``, so pk, score,
``ExecStats``, plan kind, dispatch and plain EXPLAIN must match exactly.

The non-subscribe checks of ``tests/test_boolean_api.py`` and
``tests/test_sharded.py`` run through both facades (several tables,
``adopt_store``, builders of several tables in one ``execute_many``,
metrics, error messages), and so do the manifest's schema codec and the
durability calls, which the port does not have yet and which raise.
"""
import dataclasses
import json

import numpy as np
import pytest

from benchmarks import tracy
from repro.core import api as rapi
from repro.core import manifest as r_manifest
from repro.core import query as rq
from repro.core.lsm import LSMConfig as RConfig
from repro.core.lsm import LSMStore as RStore
from repro.core.types import IndexKind as RIndexKind
from repro.kernels import ops as r_ops
from repro.obs import SLOW_LOG as R_SLOW_LOG
from repro_torch.core import api as papi
from repro_torch.core import manifest as p_manifest
from repro_torch.core import query as pq
from repro_torch.core.lsm import LSMConfig as PConfig
from repro_torch.core.lsm import LSMStore as PStore
from repro_torch.core.shards import ShardRouter as PShardRouter
from repro_torch.core.types import IndexKind, Schema
from repro_torch.kernels import ops as p_ops
from repro_torch.obs import SLOW_LOG as P_SLOW_LOG
from tests.conftest import make_batch, tweet_schema
from tests.test_boolean_api import EXPRS
from tests.test_sharded import _queries as sharded_queries
from tests.test_torch_query import (TEMPLATES, assert_same, port_config,
                                    port_schema, to_port)
from tests.test_torch_shards import port_tweet_schema

CFG = tracy.TracyConfig(n_rows=8000, dim=16)
SHARDS = [1, 2, 4]
# the GRAPH table: two segments; batches of 8 take the graph dispatch
GRAPH_CFG = tracy.TracyConfig(n_rows=1024, dim=16, seed=7, flush_rows=512,
                              fanout=64)
GRAPH_SHARDS = [1]


def port_graph_schema(dim):
    cols = port_schema(dim).columns
    return Schema([dataclasses.replace(cols[0], index=IndexKind.GRAPH)]
                  + list(cols[1:]))


def _feed(table, cfg):
    """``tracy.build_store``'s put stream, through the facade."""
    data = tracy.TracyData(cfg)
    done = 0
    while done < cfg.n_rows:
        n = min(cfg.flush_rows, 2048, cfg.n_rows - done)
        table.put(*data.batch(n))
        done += n
    table.flush()
    return data


def _pair(shards):
    """(reference Database, port Database) with the TRACY table as the
    default table and, for ``GRAPH_SHARDS``, a GRAPH table "graph"."""
    ref = rapi.Database(tracy.tweet_schema(CFG.dim), RConfig(
        flush_rows=CFG.flush_rows, fanout=CFG.fanout, pq_m=CFG.pq_m),
        shards=shards)
    port = papi.Database(port_schema(CFG.dim), port_config(CFG),
                         shards=shards, device="cpu")
    for db in (ref, port):
        data = _feed(db.table(), CFG)
    if shards in GRAPH_SHARDS:
        g = GRAPH_CFG
        _feed(ref.create_table("graph", tracy.tweet_schema(
            g.dim, RIndexKind.GRAPH), RConfig(
            flush_rows=g.flush_rows, fanout=g.fanout, pq_m=g.pq_m,
            quantize_vectors=False)), g)
        _feed(port.create_table("graph", port_graph_schema(g.dim), PConfig(
            flush_rows=g.flush_rows, fanout=g.fanout, pq_m=g.pq_m,
            quantize_vectors=False)), g)
    return ref, port, data


@pytest.fixture(scope="module")
def dbs():
    out = {}
    for shards in SHARDS:
        ref, port, data = _pair(shards)
        search, nn = tracy.make_templates(data)
        fns = {f.__name__: f for f in search + nn}
        queries = {name: [fns[name]() for _ in range(8)]
                   for name in TEMPLATES}
        for name, fn in tracy.make_graph_templates(data):
            queries[name] = [fn() for _ in range(8)]
        out[shards] = (ref, port, queries)
    return out


def as_builder(table, query):
    """A ``HybridQuery`` as a ``QueryBuilder`` on ``table``."""
    b = table.query()
    if query.where is not None:
        b.where(query.where)
    return b.rank(*query.ranks, recall_target=query.recall_target) \
        .limit(query.k)


def _fresh_shapes():
    r_ops._seen_shapes.clear()
    p_ops._seen_shapes.clear()


def _plan_key(plan):
    return (plan.kind, plan.fused, getattr(plan, "quantized", False),
            getattr(plan, "graph", False))


def _check(ref_table, port_table, ref_db, port_db, queries):
    """The queries through both facades: ``Database.execute_many`` of the
    whole batch, one ``QueryBuilder.execute``, and the plans and plain
    EXPLAIN of two."""
    rb = [as_builder(ref_table, x) for x in queries]
    pb = [as_builder(port_table, to_port(x)) for x in queries]
    _fresh_shapes()
    r_out = ref_db.execute_many(rb)
    batch = port_db.execute_many(pb)
    assert_same(r_out, batch)
    _fresh_shapes()
    assert_same([rb[0].execute()], [pb[0].execute()])
    for r, p in zip(rb[:2], pb[:2]):
        assert _plan_key(p.plan()) == _plan_key(r.plan())
        assert p.explain() == r.explain()                 # plain EXPLAIN
    return batch


@pytest.mark.parametrize("shards", SHARDS)
@pytest.mark.parametrize("name", TEMPLATES)
def test_template_parity_through_the_facade(dbs, shards, name):
    ref, port, queries = dbs[shards]
    batch = _check(ref.table(), port.table(), ref, port, queries[name])
    if shards > 1:
        assert all(st.shards == shards for _, st in batch)
    if name in ("t6", "t8", "t13"):
        assert "dispatch=fused" in batch[0][1].plan.splitlines()[0]


@pytest.mark.parametrize("shards", GRAPH_SHARDS)
@pytest.mark.parametrize("name", ["g6", "g8", "g13"])
def test_graph_template_parity_through_the_facade(dbs, shards, name):
    ref, port, queries = dbs[shards]
    batch = _check(ref.table("graph"), port.table("graph"), ref, port,
                   queries[name])
    if name == "g6":
        assert "dispatch=graph" in batch[0][1].plan.splitlines()[0]


@pytest.mark.parametrize("shards", [1, 4])
def test_explain_analyze_through_the_facade(dbs, shards):
    ref, port, queries = dbs[shards]
    q = queries["t8"][0]
    _fresh_shapes()
    r = as_builder(ref.table(), q).explain(analyze=True)
    p = as_builder(port.table(), to_port(q)).explain(analyze=True)
    assert_same([(r.results, r.stats)], [(p.results, p.stats)])
    assert p.text.splitlines()[0] == r.text.splitlines()[0]
    assert [ln.split("[")[0] for ln in p.text.splitlines()] == \
        [ln.split("[")[0] for ln in r.text.splitlines()]
    _fresh_shapes()
    p2 = port.table().explain(to_port(q), analyze=True)
    assert [(x.pk, x.score) for x in p2.results] == \
        [(x.pk, x.score) for x in p.results]
    assert port.table().explain(to_port(q)) == \
        ref.table().explain(q)


def test_execute_many_across_tables_keeps_input_order(dbs):
    """Builders of the TRACY and the GRAPH table and bare queries (which
    run on the default table), interleaved, come back in input order."""
    ref, port, queries = dbs[1]
    mixed = [queries["t6"][0], queries["g6"][0], queries["t2"][0],
             queries["g8"][1], queries["t4"][2]]
    on = ["default", "graph", None, "graph", "default"]
    rb = [as_builder(ref.table(t), x) if t else x
          for t, x in zip(on, mixed)]
    pb = [as_builder(port.table(t), to_port(x)) if t else to_port(x)
          for t, x in zip(on, mixed)]
    _fresh_shapes()
    r_out = ref.execute_many(rb)
    p_out = port.execute_many(pb)
    assert [(r.pk, r.score) for r in p_out[1][0]] == \
        [(r.pk, r.score) for r in r_out[1][0]]
    for (r_rows, _), (p_rows, _) in zip(r_out, p_out):
        assert [(r.pk, r.score) for r in p_rows] == \
            [(r.pk, r.score) for r in r_rows]
    alone = port.table("graph").execute_many([pb[1]])
    assert [r.pk for r in alone[0][0]] == [r.pk for r in p_out[1][0]]


# ---------------------------------------------------------------------------
# tests/test_boolean_api.py and tests/test_sharded.py through both facades
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tweet_dbs():
    """``tests/test_boolean_api.py``'s ``db_ref`` table in both facades."""
    out = []
    for db in (rapi.Database(tweet_schema(), RConfig(flush_rows=512)),
               papi.Database(port_tweet_schema(16), PConfig(flush_rows=512),
                             device="cpu")):
        rng = np.random.default_rng(21)
        for i in range(0, 3000, 500):
            db.table().put(*make_batch(rng, 500, pk_start=i))
        db.table().flush()
        out.append(db)
    return out


@pytest.mark.parametrize("ranked", [False, True])
@pytest.mark.parametrize("i", range(len(EXPRS)))
def test_boolean_expressions_through_the_facade(tweet_dbs, i, ranked):
    ref, port = tweet_dbs
    expr = EXPRS[i]
    qv = np.random.default_rng(3).normal(size=16).astype(np.float32)
    rb = ref.table().query().where(expr)
    pb = port.table().query().where(to_port(expr))
    if ranked:
        rb.rank(rq.VectorRank("embedding", qv, 1.0)).limit(12)
        pb.rank(pq.VectorRank("embedding", qv, 1.0)).limit(12)
    _fresh_shapes()
    assert_same([rb.execute()], [pb.execute()])
    assert pb.explain() == rb.explain()


def test_database_multiple_tables_and_adopt_store():
    got = []
    for api, schema, kw, store in (
            (rapi, tweet_schema(), {}, lambda s: RStore(s)),
            (papi, port_tweet_schema(16), {"device": "cpu"},
             lambda s: PStore(s, device="cpu"))):
        db = api.Database(schema, **kw)
        t2 = db.create_table("other", schema)
        rng = np.random.default_rng(1)
        pks, batch = make_batch(rng, 100)
        db.table().put(pks, batch)
        t2.put(pks, batch)
        out = db.execute_many([
            db.table().query().where(api.Range("time", 0, 50)),
            t2.query().where(api.Range("time", 0, 50)),
        ])
        assert {r.pk for r in out[0][0]} == {r.pk for r in out[1][0]}
        with pytest.raises(KeyError) as e:
            db.table("missing")
        adopted = db.adopt_store("adopted", store(schema))
        adopted.put(pks, batch)
        res = adopted.query().where(api.Range("time", 0, 50)).all()
        assert {r.pk for r in res} == {r.pk for r in out[0][0]}
        assert sorted(db.tables) == ["adopted", "default", "other"]
        got.append((str(e.value), sorted(r.pk for r in res),
                    adopted.n_rows, adopted.n_shards))
    assert got[0] == got[1]


def test_facade_errors_match_the_reference():
    msgs = []
    for api, schema, kw in ((rapi, tweet_schema(), {}),
                            (papi, port_tweet_schema(16),
                             {"device": "cpu"})):
        db = api.Database(schema, **kw)
        t = db.table()
        calls = [
            lambda: api.Table("x", **kw),
            lambda: api.Table("x", schema, store=t.store, **kw),
            lambda: api.Table("x", store=t.store, shards=2),
            lambda: db.create_table("default", schema),
            lambda: db.adopt_store("default", t.store),
            lambda: db.table("nope"),
            lambda: t.query().subscribe(interval_s=1.0, on_change=True),
            lambda: t.query().subscribe(),
        ]
        got = []
        for call in calls:
            with pytest.raises((ValueError, KeyError)) as e:
                call()
            got.append((type(e.value).__name__, str(e.value)))
        assert t.advance(5.0) == {} and db.advance(5.0) == {}
        msgs.append(got)
    assert msgs[0] == msgs[1]


def test_table_builds_its_store_on_the_device_and_adopt_keeps_its_own():
    db = papi.Database(port_tweet_schema(16), device="cpu")
    assert db.table().store.device.type == "cpu"
    t2 = db.create_table("sharded", port_tweet_schema(16), shards=3)
    assert isinstance(t2.store, PShardRouter) and t2.n_shards == 3
    assert {sh.device.type for sh in t2.store.shards} == {"cpu"}
    store = PStore(port_tweet_schema(16), device="cpu")
    assert db.adopt_store("a", store).store is store


def test_metrics_have_the_reference_keys():
    got = []
    for api, schema, kw in ((rapi, tweet_schema(), {}),
                            (papi, port_tweet_schema(16),
                             {"device": "cpu"})):
        db = api.Database(schema, **kw)
        ts = db.create_table("sharded", schema, shards=2)
        rng = np.random.default_rng(2)
        for t in (db.table(), ts):
            t.put(*make_batch(rng, 200))
            t.query().where(api.Range("time", 0, 30)).all()
        db.table().query().where(api.Range("time", 0, 10)) \
            .subscribe(interval_s=1.0)
        ts.query().where(api.Range("time", 0, 10)).subscribe(on_change=True)
        db.advance(0.0)
        m = db.metrics()
        tables = {name: {part: sorted(v) if part != "shards" else
                         {i: sorted(s) for i, s in v.items()}
                         for part, v in tm.items()}
                  for name, tm in m["tables"].items()}
        # the registry is process-wide: other tests add names to it
        names = {"query.latency_s", "query.count", "lsm.puts",
                 "continuous.advance_s", "continuous.advances"}
        text = db.metrics_text()
        got.append((tables, names <= set(m["registry"]),
                    all(n.replace(".", "_") in text for n in names)))
    assert got[0] == got[1]
    assert got[1][1:] == (True, True)


def test_slow_queries_and_close():
    got = []
    for api, schema, kw, log in ((rapi, tweet_schema(), {}, R_SLOW_LOG),
                                 (papi, port_tweet_schema(16),
                                  {"device": "cpu"}, P_SLOW_LOG)):
        log.clear()
        log.configure(0.0)
        try:
            with api.Database(schema, **kw) as db:
                db.table().put(*make_batch(np.random.default_rng(3), 50))
                db.table().query().where(api.Range("time", 0, 50)).all()
                entries = db.slow_queries()
        finally:
            log.configure(None)
            log.clear()
        assert db._closed
        db.close()                                  # idempotent
        got.append((len(entries), sorted(entries[0])))
    assert got[0] == got[1]


@pytest.mark.parametrize("shards", [1, 4])
def test_sharded_facade_queries_match_the_reference(shards):
    """``tests/test_sharded.py``'s ``_pair`` table and queries through both
    facades: results, ``ExecStats`` and EXPLAIN (``ShardFanout``)."""
    tables = []
    for api, schema, kw in ((rapi, tweet_schema(16), {}),
                            (papi, port_tweet_schema(16),
                             {"device": "cpu"})):
        rng = np.random.default_rng(0)
        t = api.Database(schema, (RConfig if api is rapi else PConfig)(
            flush_rows=150), shards=shards, **kw).table()
        for start in range(0, 900, 150):
            t.put(*make_batch(rng, 150, dim=16, pk_start=start))
        t.flush()
        tables.append(t)
    ref, port = tables
    queries = sharded_queries(np.random.default_rng(1))
    _fresh_shapes()
    r_out = ref.execute_many(queries)
    p_out = port.execute_many([to_port(x) for x in queries])
    assert_same(r_out, p_out)
    for x in queries:
        assert port.explain(to_port(x)) == ref.explain(x)
    assert port.n_shards == ref.n_shards == shards


def test_empty_tables_answer_as_the_reference():
    got = []
    for api, schema, kw in ((rapi, tweet_schema(16), {}),
                            (papi, port_tweet_schema(16),
                             {"device": "cpu"})):
        t = api.Database(schema, shards=3, **kw).table()
        res = t.execute_many([
            t.query().where(api.Range("time", 0, 100)),
            t.query().rank(api.VectorRank("embedding",
                                          np.zeros(16, np.float32), 1.0))])
        got.append([rows for rows, _ in res])
    assert got[0] == got[1] == [[], []]


# ---------------------------------------------------------------------------
# durability: not ported; the manifest's schema codec is the reference's
# ---------------------------------------------------------------------------

def test_durability_calls_raise_naming_the_roadmap_item(tmp_path):
    schema = port_tweet_schema(16)
    with pytest.raises(NotImplementedError, match="item 6"):
        papi.Database(schema, path=str(tmp_path), device="cpu")
    with pytest.raises(NotImplementedError, match="item 6"):
        papi.Database(path=str(tmp_path))
    with pytest.raises(NotImplementedError, match="item 6"):
        papi.Database.restore(str(tmp_path))
    db = papi.Database(schema, device="cpu")
    with pytest.raises(NotImplementedError, match="item 6"):
        db.snapshot(str(tmp_path))
    with pytest.raises(NotImplementedError, match="item 6"):
        db.create_table("durable", schema, PConfig(path=str(tmp_path)))
    assert list(tmp_path.iterdir()) == []


SCHEMAS = [(kind, dim) for kind in ("IVF", "PQIVF", "GRAPH", "NONE")
           for dim in (16, 128)]


@pytest.mark.parametrize("kind,dim", SCHEMAS)
def test_manifest_schema_json_is_the_references(tmp_path, kind, dim):
    r_schema = tracy.tweet_schema(dim, RIndexKind[kind])
    cols = port_schema(dim).columns
    p_schema = Schema([dataclasses.replace(cols[0], index=IndexKind[kind])]
                      + list(cols[1:]))
    r_json = r_manifest.schema_to_json(r_schema)
    p_json = p_manifest.schema_to_json(p_schema)
    assert json.dumps(p_json, sort_keys=True) == \
        json.dumps(r_json, sort_keys=True)
    back = p_manifest.schema_from_json(r_json)
    assert p_manifest.schema_to_json(back) == r_json
    assert back.columns == p_schema.columns
    r_manifest.atomic_write_json(str(tmp_path / "r.json"), r_json)
    p_manifest.atomic_write_json(str(tmp_path / "p.json"), p_json)
    assert (tmp_path / "p.json").read_bytes() == \
        (tmp_path / "r.json").read_bytes()
    assert sorted(p.name for p in tmp_path.iterdir()) == ["p.json", "r.json"]


def test_the_facade_exports_the_references_names():
    assert sorted(papi.__all__) == sorted(rapi.__all__)
    for name in papi.__all__:
        assert getattr(papi, name).__name__ == getattr(rapi, name).__name__
