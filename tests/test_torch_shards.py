"""Sharded scatter-gather in the port: ``ShardRouter`` + ``ShardedExecutor``
(on the CPU) against the JAX package's (default backend), and the two merge
kernels' plain versions against the Pallas kernels in interpret mode.

Both routers are fed the same put stream (updates and deletes included)
and asked the same queries at 1, 2, 4 and 8 shards; every distance is below
``HOST_FLOP_CUTOFF``, so pk, score, ``ExecStats`` (plan text, ``shards``,
``merge_rows``, ``shard_rows_max`` included), plan kind, dispatch and plain
EXPLAIN must match exactly.  The merges are held bitwise: the plain
versions to the Pallas kernels and to ``repro.kernels.ref``, the port's
``ops`` on the CPU to the reference's default backend, stats deltas
included.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import query as rq
from repro.core.lsm import LSMConfig as RConfig
from repro.core.optimizer import cost as r_cost
from repro.core.optimizer import planner as r_planner
from repro.core.shards import ShardedExecutor as RShardedExecutor
from repro.core.shards import ShardRouter as RShardRouter
from repro.core.shards import hash_pks as r_hash_pks
from repro.kernels import ops as r_ops
from repro.kernels import ref as r_ref
from repro.kernels import topk_merge as r_tk
from repro_torch import convert
from repro_torch.core.lsm import LSMConfig as PConfig
from repro_torch.core.optimizer import cost as p_cost
from repro_torch.core.optimizer import planner as p_planner
from repro_torch.core.shards import ShardedExecutor as PShardedExecutor
from repro_torch.core.shards import ShardRouter as PShardRouter
from repro_torch.core.shards import hash_pks as p_hash_pks
from repro_torch.core.types import Column, ColumnType, IndexKind, Schema
from repro_torch.kernels import ops as p_ops
from repro_torch.kernels import ref as p_ref
from repro_torch.kernels import topk_merge as p_tk
from tests.conftest import make_batch, tweet_schema
from tests.test_sharded import _queries
from tests.test_torch_query import export, to_port

DIM = 16
SENT = 2 ** 31 - 1


def port_tweet_schema(dim):
    """``tests.conftest.tweet_schema`` in the port's types."""
    return Schema([
        Column("embedding", ColumnType.VECTOR, dim=dim, index=IndexKind.IVF),
        Column("coordinate", ColumnType.SPATIAL, index=IndexKind.ZORDER),
        Column("content", ColumnType.TEXT, index=IndexKind.INVERTED),
        Column("time", ColumnType.SCALAR, index=IndexKind.BTREE)])


def _feed(router, n=900, chunk=150):
    """The put stream of ``tests/test_sharded.py``, then updates, deletes
    and fresh rows (left in the memtables: the live overlay)."""
    rng = np.random.default_rng(0)
    for start in range(0, n, chunk):
        router.put(*make_batch(rng, chunk, dim=DIM, pk_start=start))
    router.flush()
    rng = np.random.default_rng(99)
    router.put(*make_batch(rng, 80, dim=DIM, pk_start=100))
    router.delete(list(range(300, 340)))
    router.put(*make_batch(rng, 50, dim=DIM, pk_start=n))


@pytest.fixture(scope="module")
def routers():
    out = {}
    for shards in (1, 2, 4, 8):
        ref = RShardRouter(tweet_schema(DIM), RConfig(flush_rows=150),
                           n_shards=shards)
        port = PShardRouter(port_tweet_schema(DIM), PConfig(flush_rows=150),
                            n_shards=shards, device="cpu")
        for r in (ref, port):
            _feed(r)
        out[shards] = (ref, port)
    return out


def _fresh_shapes():
    r_ops._seen_shapes.clear()
    p_ops._seen_shapes.clear()


def _same(r_out, p_out):
    assert len(r_out) == len(p_out)
    for (r_rows, r_st), (p_rows, p_st) in zip(r_out, p_out):
        assert [(r.pk, r.score) for r in p_rows] == \
            [(r.pk, r.score) for r in r_rows]
        assert dataclasses.asdict(p_st) == dataclasses.asdict(r_st)


def _check_queries(ref, port, queries):
    r_ex, p_ex = RShardedExecutor(ref), PShardedExecutor(port)
    pqs = [to_port(x) for x in queries]
    for r_q, p_q in zip(queries, pqs):
        _fresh_shapes()
        _same([r_ex.execute(r_q)], [p_ex.execute(p_q)])
        r_plan, p_plan = r_ex.plan(r_q), p_ex.plan(p_q)
        assert (p_plan.kind, p_plan.fused, p_plan.logical.note) == \
            (r_plan.kind, r_plan.fused, r_plan.logical.note)
        assert p_plan.describe() == r_plan.describe()
    _fresh_shapes()
    _same(r_ex.execute_many(queries), p_ex.execute_many(pqs))
    return p_ex


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------

def test_hash_and_routing_match_the_reference(routers):
    pks = np.arange(-50, 5000)
    np.testing.assert_array_equal(p_hash_pks(pks), r_hash_pks(pks))
    for shards, (ref, port) in routers.items():
        np.testing.assert_array_equal(port.shard_of(pks), ref.shard_of(pks))
        assert port.shard_rows() == ref.shard_rows()
        assert port.memtable_rows == ref.memtable_rows
        assert port.unique_pks == ref.unique_pks
        pm, rm = port.metrics, ref.metrics
        assert set(pm) == set(rm)
        assert {k: v for k, v in pm.items() if not k.endswith("_s")} == \
            {k: v for k, v in rm.items() if not k.endswith("_s")}
        for pk in (0, 120, 310, 899, 920):
            a, b = port.get(pk), ref.get(pk)
            assert (a is None) == (b is None)
            if a is not None:
                assert a["time"] == b["time"]


# ---------------------------------------------------------------------------
# the engine: results, ExecStats, plans, EXPLAIN
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shards", [1, 2, 4, 8])
def test_sharded_parity(routers, shards):
    ref, port = routers[shards]
    p_ex = _check_queries(ref, port, _queries(np.random.default_rng(1)))
    qv = np.zeros(DIM, np.float32)
    text = p_ex.plan(to_port(rq.HybridQuery(ranks=[rq.VectorRank(
        "embedding", qv, 1.0)], k=7))).describe()
    assert text.startswith("sharded:")
    assert f"ShardFanout [n={shards} hash(pk)]" in text
    assert "CrossShardTopKMerge" in text and "k=7" in text
    assert text.count("-> Shard [") == shards


@pytest.mark.parametrize("shards", [2, 8])
def test_sharded_parity_after_drain(shards):
    """The same stream with the memtables drained into segments."""
    ref = RShardRouter(tweet_schema(DIM), RConfig(flush_rows=150),
                       n_shards=shards)
    port = PShardRouter(port_tweet_schema(DIM), PConfig(flush_rows=150),
                        n_shards=shards, device="cpu")
    for r in (ref, port):
        _feed(r)
        r.drain()
        r.flush()
        assert r.memtable_rows == 0
    _check_queries(ref, port, _queries(np.random.default_rng(9)))


@pytest.mark.parametrize("shards", [1, 4])
def test_sharded_fused_batches(routers, shards):
    """Batches of six structurally identical NN queries take the shared
    scan and the fused dispatch on both sides; the merge is charged once
    per k-group to every query of the group."""
    ref, port = routers[shards]
    r_ex, p_ex = RShardedExecutor(ref), PShardedExecutor(port)
    for qq in [x for x in _queries(np.random.default_rng(2)) if x.is_nn]:
        _fresh_shapes()
        r_out = r_ex.execute_many([qq] * 6)
        p_out = p_ex.execute_many([to_port(qq)] * 6)
        _same(r_out, p_out)
        for _, st in p_out:
            assert st.shards == shards
            assert 0 < st.merge_rows <= shards * qq.k
            assert 0 < st.shard_rows_max <= st.rows_scanned


def test_postfilter_demotion_note(routers, monkeypatch):
    """A plan the planner would give the IVF post-filter probe is demoted
    to the exact shared-scan shape under sharding, with the note, on both
    sides (the probe is made the cheapest candidate in both)."""
    free = lambda *a, **k: r_cost.PlanCost(blocks=0.0,  # noqa: E731
                                           candidates=0.0)
    monkeypatch.setattr(r_cost, "postfilter_nn_cost", free)
    monkeypatch.setattr(p_cost, "postfilter_nn_cost",
                        lambda *a, **k: p_cost.PlanCost(blocks=0.0,
                                                        candidates=0.0))
    ref, port = routers[4]
    rng = np.random.default_rng(5)
    qs = [rq.HybridQuery(where=rq.Range("time", 10, 70),
                         ranks=[rq.VectorRank("embedding", rng.normal(
                             size=DIM).astype(np.float32), 1.0)], k=10)
          for _ in range(2)]
    assert r_planner.plan(RShardedExecutor(ref).catalog,
                          qs[0]).kind == "postfilter_nn"
    assert p_planner.plan(PShardedExecutor(port).catalog,
                          to_port(qs[0])).kind == "postfilter_nn"
    p_ex = _check_queries(ref, port, qs)
    note = p_ex.plan(to_port(qs[0])).logical.note
    assert "postfilter demoted under sharding" in note


def test_explain_analyze_fans_out(routers):
    ref, port = routers[4]
    p_ex = PShardedExecutor(port)
    qv = np.random.default_rng(3).normal(size=DIM).astype(np.float32)
    qq = to_port(rq.HybridQuery(ranks=[rq.VectorRank("embedding", qv, 1.0)],
                                k=10))
    an = p_ex.explain_analyze(qq)
    assert "(analyzed)" in an.text and "ShardFanout" in an.text
    assert an.text.count("-> Shard [") == 4 and len(an.per_shard) == 4
    rows, _ = p_ex.execute(qq)
    assert [(r.pk, r.score) for r in an.results] == \
        [(r.pk, r.score) for r in rows]
    r_rows, _ = RShardedExecutor(ref).execute(
        rq.HybridQuery(ranks=[rq.VectorRank("embedding", qv, 1.0)], k=10))
    assert [(r.pk, r.score) for r in rows] == \
        [(r.pk, r.score) for r in r_rows]


def test_empty_and_unsatisfiable():
    port = PShardRouter(port_tweet_schema(DIM), n_shards=3, device="cpu")
    ref = RShardRouter(tweet_schema(DIM), n_shards=3)
    p = rq.Range("time", 0, 50)
    queries = [rq.HybridQuery(ranks=[rq.VectorRank(
        "embedding", np.zeros(DIM, np.float32), 1.0)], k=5),
        rq.HybridQuery(where=rq.And(p, rq.Not(p)))]
    _check_queries(ref, port, queries)


def test_converted_router_answers_as_the_reference(routers):
    ref, _ = routers[4]
    ref_flushed = RShardRouter(tweet_schema(DIM), RConfig(flush_rows=150),
                               n_shards=4)
    _feed(ref_flushed)
    ref_flushed.flush()
    port = convert.router_from_arrays(
        port_tweet_schema(DIM),
        [[export(s) for s in sh.segments] for sh in ref_flushed.shards],
        PConfig(flush_rows=150), device="cpu",
        unique_pks=[sh.unique_pks for sh in ref_flushed.shards])
    assert port.n_shards == 4
    assert port.shard_rows() == ref_flushed.shard_rows()
    _check_queries(ref_flushed, port, _queries(np.random.default_rng(4)))


# ---------------------------------------------------------------------------
# the merge kernels' plain versions and the merge ops
# ---------------------------------------------------------------------------

def _merge_case(nq, s, kk, kind, seed=14):
    rng = np.random.default_rng(seed)
    d = rng.uniform(0, 10, (nq, s, kk)).astype(np.float32)
    if kind == "ties":
        d = np.floor(d / 3).astype(np.float32)
    ids = rng.permutation(nq * s * kk).reshape(nq, s, kk).astype(np.int32)
    if kind == "pads":
        pad = rng.random((nq, s, kk)) < 0.4
        d[pad] = np.inf
        ids[pad] = SENT
    return d, ids


MERGE_CASES = [(4, 3, 6, 5, "ties"), (4, 3, 6, 5, "pads"),
               (3, 4, 10, 1, "plain"), (3, 4, 10, 40, "ties"),
               (2, 2, 100, 150, "ties"), (3, 1, 9, 9, "pads"),
               (2, 1, 5, 3, "plain")]


@pytest.mark.parametrize("nq,s,kk,k,kind", MERGE_CASES)
def test_batched_merge_plain_matches_pallas(nq, s, kk, k, kind):
    d, ids = _merge_case(nq, s, kk, kind)
    od, oi = r_tk.batched_topk_merge(jnp.asarray(d), jnp.asarray(ids), k,
                                     interpret=True)
    wd, wi = r_ref.batched_topk_merge_ref(jnp.asarray(d), jnp.asarray(ids),
                                          k)
    gd, gi = p_tk.batched_topk_merge(torch.from_numpy(d),
                                     torch.from_numpy(ids), k)
    for want_d, want_i in ((od, oi), (wd, wi)):
        np.testing.assert_array_equal(gd.numpy().view(np.uint32),
                                      np.asarray(want_d).view(np.uint32))
        np.testing.assert_array_equal(gi.numpy(), np.asarray(want_i))


@pytest.mark.parametrize("nq,s,kk,k,kind", MERGE_CASES)
def test_single_merge_plain_matches_pallas(nq, s, kk, k, kind):
    """The single-list merge: scores bitwise equal to the Pallas kernel and
    the oracle, ids equal to the oracle's everywhere and to the Pallas
    kernel's in every finite slot (see the next test for +inf slots)."""
    d, ids = _merge_case(nq, s, kk, kind)
    d, ids = d[0], ids[0].astype(np.int64)
    k = min(k, d.size)
    od, oi = r_tk.topk_merge(jnp.asarray(d), jnp.asarray(ids), k,
                             interpret=True)
    wd, wi = r_ref.topk_merge_ref(jnp.asarray(d), jnp.asarray(ids), k)
    gd, gi = p_tk.topk_merge(torch.from_numpy(d), torch.from_numpy(ids), k)
    assert gi.dtype == torch.int64
    gd, gi = gd.numpy(), gi.numpy()
    for want in (od, wd):
        np.testing.assert_array_equal(gd.view(np.uint32),
                                      np.asarray(want).view(np.uint32))
    np.testing.assert_array_equal(gi, np.asarray(wi))
    fin = np.isfinite(gd)
    np.testing.assert_array_equal(gi[fin], np.asarray(oi)[fin])


def test_single_merge_inf_slots_follow_the_oracle():
    """Where k exceeds the finite candidates, the JAX package's Pallas
    ``topk_merge`` repeats an already emitted id in its +inf slots (a
    consumed slot is set to +inf and argmin finds it again) while its
    oracle emits every position once.  The port keeps the oracle's
    semantics in its plain version and its kernel."""
    d = np.asarray([[1.0, np.inf, 3.0], [np.inf, 2.0, 1.0]], np.float32)
    ids = (np.arange(6, dtype=np.int32) + 10).reshape(2, 3)
    _, oi = r_tk.topk_merge(jnp.asarray(d), jnp.asarray(ids), 6,
                            interpret=True)
    _, wi = r_ref.topk_merge_ref(jnp.asarray(d), jnp.asarray(ids), 6)
    _, gi = p_tk.topk_merge(torch.from_numpy(d), torch.from_numpy(ids), 6)
    assert np.asarray(oi).tolist() == [10, 15, 14, 12, 10, 10]
    assert np.asarray(wi).tolist() == [10, 15, 14, 12, 11, 13]
    assert gi.tolist() == [10, 15, 14, 12, 11, 13]


def _stats_delta(snap, fn):
    before = snap()
    out = fn()
    return out, tuple(a - b for a, b in zip(snap(), before))


@pytest.mark.parametrize("nq,s,kk,k,kind", MERGE_CASES)
def test_merge_topk_batch_cpu_matches_the_reference(nq, s, kk, k, kind):
    """Host merge on the CPU, bitwise, stats included; the card route's
    host logic (``_merge_kernel`` over the plain version) against the
    reference's Pallas branch."""
    d, ids = _merge_case(nq, s, kk, kind)
    ids64 = ids.astype(np.int64)
    _fresh_shapes()
    (rd, ri), r_delta = _stats_delta(
        r_ops.stats_snapshot,
        lambda: r_ops.merge_topk_batch(d, ids64, k, use_pallas=False))
    (gd, gi), p_delta = _stats_delta(
        p_ops.stats_snapshot,
        lambda: p_ops.merge_topk_batch(d, ids64, k, device="cpu"))
    np.testing.assert_array_equal(gd.view(np.uint32), rd.view(np.uint32))
    np.testing.assert_array_equal(gi, ri)
    assert p_delta == r_delta
    kc = min(k, s * kk)
    (rd, ri), r_delta = _stats_delta(
        r_ops.stats_snapshot,
        lambda: r_ops.merge_topk_batch(d, ids64, k, use_pallas=True))
    (gd, gi), p_delta = _stats_delta(
        p_ops.stats_snapshot,
        lambda: p_ops._merge_kernel(d, ids64, kc, torch.device("cpu")))
    np.testing.assert_array_equal(gd.view(np.uint32), rd.view(np.uint32))
    np.testing.assert_array_equal(gi, ri)
    assert p_delta == r_delta


def test_merge_topk_batch_large_pks_take_the_host_merge():
    d = np.asarray([[[1.0, 2.0, np.inf]]], np.float32)
    ids = np.asarray([[[2 ** 31, 7, 0]]], np.int64)
    rd, ri = r_ops.merge_topk_batch(d, ids, 2, use_pallas=True)
    gd, gi = p_ops.merge_topk_batch(d, ids, 2, device="cpu")
    assert gi[0].tolist() == ri[0].tolist() == [2 ** 31, 7]
    assert gd[0].tolist() == rd[0].tolist() == [1.0, 2.0]
    neg = np.asarray([[[1.0, 1.0, 0.5]]], np.float32)
    nid = np.asarray([[[-3, 4, -1]]], np.int64)
    rd, ri = r_ops.merge_topk_batch(neg, nid, 3, use_pallas=True)
    gd, gi = p_ops.merge_topk_batch(neg, nid, 3, device="cpu")
    assert gi.tolist() == ri.tolist() == [[-1, -3, 4]]


@pytest.mark.parametrize("s,kk,k", [(3, 6, 5), (1, 9, 9), (4, 10, 40)])
def test_merge_topk_cpu_matches_the_reference(s, kk, k):
    d, ids = _merge_case(1, s, kk, "ties")
    d, ids = d[0], ids[0].astype(np.int64)
    _fresh_shapes()
    (rd, ri), r_delta = _stats_delta(
        r_ops.stats_snapshot,
        lambda: r_ops.merge_topk(d, ids, k, use_pallas=False))
    (gd, gi), p_delta = _stats_delta(
        p_ops.stats_snapshot, lambda: p_ops.merge_topk(d, ids, k,
                                                      device="cpu"))
    np.testing.assert_array_equal(gd.view(np.uint32),
                                  np.asarray(rd).view(np.uint32))
    np.testing.assert_array_equal(gi, np.asarray(ri))
    assert p_delta == r_delta


def test_merge_wrappers_reject_bad_inputs():
    d = torch.zeros((2, 3, 4))
    with pytest.raises(TypeError):
        p_tk.batched_topk_merge(d, torch.zeros((2, 3, 4)), 2)
    with pytest.raises(ValueError):
        p_tk.batched_topk_merge(d, torch.zeros((2, 3, 5),
                                               dtype=torch.int32), 2)
    with pytest.raises(ValueError):
        p_tk.topk_merge(d[0], torch.zeros((3, 4), dtype=torch.int64), 13)
    with pytest.raises(TypeError):
        p_tk.topk_merge(d[0], torch.zeros((3, 4), dtype=torch.int16), 2)
    out = p_ref.batched_topk_merge_ref(d, torch.zeros((2, 3, 4),
                                                      dtype=torch.int32), 15)
    assert out[0].shape == (2, 15) and bool(torch.isinf(out[0][:, 12:]).all())
    assert bool((out[1][:, 12:] == SENT).all())
