"""The graph dispatch in the port: ``GraphIndex``, the beam-search kernel's
plain version, ``ops.graph_search_topk`` and ``GraphSearchTopK`` (on the
CPU) against the JAX package (its Pallas kernel in interpret mode, its
jitted oracle and its default backend).

Tolerances: on small-integer vectors every sum is exact in any order, so
the plain version equals the Pallas kernel and the oracle bitwise in all
four outputs; on random floats it sums each d2 over the features in order
(the CUDA kernel's order) while XLA picks its own, so d2 agree within
``2 d u d2`` (u = 2^-24) and the result rows agree away from ties.  The
host path below ``HOST_FLOP_CUTOFF`` is the same numpy in both packages
and is held bitwise, ``gathered`` and stats included; so is the engine on
a TRACY GRAPH store (results, ``ExecStats`` with ``rows_scanned`` the
gathered count, plan, EXPLAIN), single-store and over two shards.
"""
import dataclasses
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import tracy
from repro.core import query as rq
from repro.core.executor import Executor as RExecutor
from repro.core.index.graph import GraphIndex as RGraphIndex
from repro.core.optimizer import planner as r_planner
from repro.core.shards import ShardedExecutor as RShardedExecutor
from repro.core.shards import ShardRouter as RShardRouter
from repro.core.types import IndexKind as RIndexKind
from repro.kernels import graph_search as r_gs
from repro.kernels import ops as r_ops
from repro_torch import convert
from repro_torch.core.executor import Executor as PExecutor
from repro_torch.core.index.graph import GraphIndex as PGraphIndex
from repro_torch.core.index.graph import pack_graphs
from repro_torch.core.lsm import LSMConfig, LSMStore
from repro_torch.core.optimizer import planner as p_planner
from repro_torch.core.shards import ShardedExecutor as PShardedExecutor
from repro_torch.core.shards import ShardRouter as PShardRouter
from repro_torch.core.types import Column, ColumnType, IndexKind, Schema
from repro_torch.kernels import graph_search as p_gs
from repro_torch.kernels import ops as p_ops
from tests.test_torch_query import export, to_port

SENT = 2 ** 31 - 1
U = 2.0 ** -24
KMAX = 128


def _csr(n, r_deg, rng):
    nbr = rng.integers(0, n, (n, r_deg)).astype(np.int32)
    nbr[rng.random((n, r_deg)) < 0.25] = -1
    return nbr


def _case(seed, nq, n, d, r_deg, n_ent, kind, mask_kind="partial"):
    """Kernel inputs: ``ints`` small-integer vectors (exact sums) with
    duplicate pks ((d2, pk) ties that break by position), ``floats``
    normal vectors with distinct pks."""
    rng = np.random.default_rng(seed)
    if kind == "ints":
        q = rng.integers(-3, 4, (nq, d)).astype(np.float32)
        x = rng.integers(-3, 4, (n, d)).astype(np.float32)
        pks = (np.arange(n, dtype=np.int32) // 3)[None, :]
    else:
        q = rng.normal(size=(nq, d)).astype(np.float32)
        x = rng.normal(size=(n, d)).astype(np.float32)
        pks = (np.arange(n, dtype=np.int32) * 7 + 3)[None, :]
    nbr = _csr(n, r_deg, rng)
    if mask_kind == "full":
        mask = np.ones((nq, n), np.uint8)
    else:
        mask = (rng.random((nq, n)) < 0.3).astype(np.uint8)
    if mask_kind == "one_empty":
        mask[0] = 0
    ent = np.full((1, max(8, n_ent + 3)), SENT, np.int32)
    ent[0, :n_ent] = rng.choice(n, n_ent, replace=False)
    return q, x, nbr, ent, mask, pks


def _reference(args, beam, hops):
    j = [jnp.asarray(a) for a in args]
    pallas = r_gs.graph_search_topk(*j, beam=beam, hops=hops,
                                    interpret=True)
    oracle = r_ops._jit_graph_ref(beam, hops)(*j)
    return ([np.asarray(t) for t in pallas], [np.asarray(t) for t in oracle])


def _plain(args, beam, hops):
    out = p_gs.graph_search_topk(*(torch.from_numpy(a) for a in args),
                                 beam, hops)
    return [t.numpy() for t in out]


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


KERNEL_CASES = [(8, 512, 16, 8, 32, 4, 5), (8, 1024, 16, 16, 64, 4, 5),
                (16, 512, 12, 4, 40, 4, 5)]


@pytest.mark.parametrize("nq,n,d,r_deg,beam,hops,n_ent", KERNEL_CASES)
@pytest.mark.parametrize("mask_kind", ["full", "partial", "one_empty"])
def test_plain_matches_pallas_bitwise_on_exact_sums(nq, n, d, r_deg, beam,
                                                   hops, n_ent, mask_kind):
    args = _case(0, nq, n, d, r_deg, n_ent, "ints", mask_kind)
    got = _plain(args, beam, hops)
    for want in _reference(args, beam, hops):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(_bits(g), _bits(w))
    if mask_kind == "one_empty":
        assert (got[2][0] == SENT).all()


@pytest.mark.parametrize("kind", ["ints", "floats"])
def test_entries_exceed_beam_and_hops_zero(kind):
    """E > beam: every entry is folded in and visited, the best beam kept;
    hops = 0 returns the seeds alone."""
    args = _case(1, 8, 512, 12, 8, 20, kind, "full")
    for hops in (3, 0):
        got = _plain(args, 8, hops)
        pallas, oracle = _reference(args, 8, hops)
        if kind == "ints":
            for want in (pallas, oracle):
                for g, w in zip(got, want):
                    np.testing.assert_array_equal(_bits(g), _bits(w))
        else:
            _close(args, got, oracle)
        assert (got[0] < np.inf).all()
    vis = np.unpackbits(got[3].view(np.uint8), axis=1).sum(axis=1)
    assert (vis == 20).all()                 # hops = 0: the seeds alone


def _close(args, got, want):
    """Random floats: d2 within 2 d u d2 of the reference's, the result
    rows equal away from ties (a row in one answer only lies within the
    tolerance of the other answer's last d2)."""
    d = args[0].shape[1]
    gd, gr, wd, wr = got[0], got[2], np.asarray(want[0]), np.asarray(want[2])
    np.testing.assert_array_equal(np.isfinite(gd), np.isfinite(wd))
    fin = np.isfinite(wd)
    tol = 2 * d * U * np.abs(wd[fin]) + 1e-30
    assert (np.abs(gd[fin] - wd[fin]) <= tol).all()
    for qi in range(len(gd)):
        f = np.isfinite(gd[qi])
        only = set(gr[qi][f].tolist()) ^ set(wr[qi][f].tolist())
        if only:
            last = float(wd[qi][f][-1])
            x, q = args[1], args[0][qi]
            for r in only:
                dr = float(((x[r].astype(np.float64) - q) ** 2).sum())
                assert abs(dr - last) <= 4 * d * U * last


@pytest.mark.parametrize("nq,n,d,r_deg,beam,hops,n_ent", KERNEL_CASES)
def test_plain_matches_pallas_within_tolerance_on_floats(nq, n, d, r_deg,
                                                        beam, hops, n_ent):
    args = _case(2, nq, n, d, r_deg, n_ent, "floats", "one_empty")
    got = _plain(args, beam, hops)
    pallas, oracle = _reference(args, beam, hops)
    _close(args, got, pallas)
    _close(args, got, oracle)
    assert (got[2][0] == SENT).all()


def test_wrapper_refuses_what_the_kernel_does_not_take():
    args = [torch.from_numpy(a) for a in _case(3, 8, 512, 8, 4, 5, "ints")]
    with pytest.raises(ValueError):             # rows not a multiple of 32
        p_gs.graph_search_topk(args[0], args[1][:500], args[2][:500],
                               args[3], args[4][:, :500], args[5][:, :500],
                               8, 2)
    with pytest.raises(TypeError):
        p_gs.graph_search_topk(args[0].double(), *args[1:], 8, 2)
    with pytest.raises(ValueError, match="shared memory"):
        big = torch.full((512, 4096), -1, dtype=torch.int32)
        p_gs.graph_search_topk(args[0], args[1], big, *args[3:], 128, 1)


# ---------------------------------------------------------------------------
# ops.graph_search_topk on the CPU against the reference's default backend
# ---------------------------------------------------------------------------

def _delta(snap, fn):
    before = snap()
    out = fn()
    return out, tuple(a - b for a, b in zip(snap(), before))


def _ops_pair(args_np, beam, hops, ref_kw, port_fn):
    r_ops._seen_shapes.clear()
    p_ops._seen_shapes.clear()
    r_out, r_d = _delta(r_ops.stats_snapshot, lambda: r_ops.graph_search_topk(
        *args_np, beam, hops, **ref_kw))
    p_out, p_d = _delta(p_ops.stats_snapshot, port_fn)
    for a, b in zip(p_out, r_out):
        np.testing.assert_array_equal(_bits(a), _bits(b))
    assert p_d == r_d
    return p_out


def _ops_case(seed, nq, n, d, kind):
    rng = np.random.default_rng(seed)
    if kind == "ints":
        q = rng.integers(-3, 4, (nq, d)).astype(np.float32)
        x = rng.integers(-3, 4, (n, d)).astype(np.float32)
    else:
        q = rng.normal(size=(nq, d)).astype(np.float32)
        x = rng.normal(size=(n, d)).astype(np.float32)
    nbr = _csr(n, 8, rng)
    ent = rng.choice(n, 6, replace=False).astype(np.int64)
    mask = rng.random((nq, n)) < 0.5
    mask[0, :] = True
    pks = np.arange(n, dtype=np.int64) * 3 + 11
    return q, x, nbr, ent, mask, pks


@pytest.mark.parametrize("kind", ["ints", "floats"])
def test_ops_host_path_is_bitwise_the_reference(kind):
    args = _ops_case(4, 3, 400, 8, kind)
    out = _ops_pair(args, 16, 4, {"use_pallas": False},
                    lambda: p_ops.graph_search_topk(*args, 16, 4,
                                                    device="cpu"))
    assert (out[2] >= (out[1] >= 0).sum(axis=1)).all()


@pytest.mark.parametrize("beam,hops", [(24, 6), (128, 12)])
def test_ops_plain_path_on_exact_sums(beam, hops, monkeypatch):
    """Above the cutoff (n = 700: rows padded to a bucketed BLOCK_N
    multiple, not a multiple of 32 before it) the CPU takes the plain
    version, the reference its jitted oracle; the card's host logic
    (``_graph_kernel`` over the plain version) against its Pallas
    branch."""
    monkeypatch.setattr(r_ops, "HOST_FLOP_CUTOFF", 0)
    monkeypatch.setattr(p_ops, "HOST_FLOP_CUTOFF", 0)
    args = _ops_case(5, 5, 700, 16, "ints")
    _ops_pair(args, beam, hops, {"use_pallas": False},
              lambda: p_ops.graph_search_topk(*args, beam, hops,
                                              device="cpu"))
    q, x, nbr, ent, mask, pks = args
    _ops_pair(args, beam, hops, {"use_pallas": True},
              lambda: p_ops._graph_kernel(q, x, nbr, ent, mask, pks, beam,
                                          hops, torch.device("cpu")))


def test_ops_degenerate_inputs():
    rng = np.random.default_rng(6)
    x = rng.normal(size=(100, 8)).astype(np.float32)
    q = np.zeros((2, 8), np.float32)
    nbr = _csr(100, 4, rng)
    pks = np.arange(100, dtype=np.int64)
    for args in ((q, x, nbr, np.array([0]), np.zeros((2, 100), bool), pks),
                 (q, x, nbr, np.array([-1, 500]), np.ones((2, 100), bool),
                  pks),
                 (q, np.zeros((0, 8), np.float32), np.zeros((0, 4), np.int32),
                  np.array([0]), np.ones((2, 0), bool),
                  np.zeros(0, np.int64))):
        out = _ops_pair(args, 8, 4, {"use_pallas": False},
                        lambda: p_ops.graph_search_topk(*args, 8, 4,
                                                        device="cpu"))
        assert (out[1] == -1).all() and np.isinf(out[0]).all()


# ---------------------------------------------------------------------------
# GraphIndex: build and donation merge, bit for bit
# ---------------------------------------------------------------------------

def _clustered(n, dim, n_clusters, rng, spread=0.3):
    centers = rng.normal(size=(n_clusters, dim)).astype(np.float32)
    labels = rng.integers(0, n_clusters, n)
    return (centers[labels]
            + spread * rng.normal(size=(n, dim))).astype(np.float32)


def _seg_col(vecs):
    seg = types.SimpleNamespace(columns={"embedding": vecs},
                                n_rows=len(vecs))
    return seg, types.SimpleNamespace(name="embedding")


def _same_index(a, b, counters=True):
    """Equal CSR, entries, medoid and degree; with ``counters``, equal
    build/merge accounting too (a loaded index counts every row as
    donated, in both packages)."""
    np.testing.assert_array_equal(a.neighbors, b.neighbors)
    np.testing.assert_array_equal(a.entries, b.entries)
    assert (a.medoid, a.R) == (b.medoid, b.R)
    if counters:
        assert (a.inserted_rows, a.donated_rows) == \
            (b.inserted_rows, b.donated_rows)


def test_graph_index_build_and_search_match():
    vecs = _clustered(300, 16, 5, np.random.default_rng(7))
    seg, col = _seg_col(vecs)
    r, p = RGraphIndex(seed=3), PGraphIndex(seed=3)
    r.build(seg, col)
    p.build(seg, col)
    _same_index(r, p)
    rng = np.random.default_rng(8)
    for _ in range(5):
        qv = vecs[rng.integers(0, 300)] + 0.1 * rng.normal(size=16).astype(
            np.float32)
        for a, b in zip(p.search(qv, 10, beam=32), r.search(qv, 10, beam=32)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    loaded = PGraphIndex()
    loaded.from_arrays(r.to_arrays(), seg, col)
    for key, val in p.to_arrays().items():
        np.testing.assert_array_equal(loaded.to_arrays()[key], val)


def test_graph_index_merge_by_donation_matches():
    parts = {"r": [], "p": []}
    part_vecs = []
    for si, sz in enumerate([200, 150, 80]):
        vecs = _clustered(sz, 16, 4, np.random.default_rng(40 + si))
        seg, col = _seg_col(vecs)
        for name, cls in (("r", RGraphIndex), ("p", PGraphIndex)):
            gi = cls(seed=si)
            gi.build(seg, col)
            parts[name].append(gi)
        part_vecs.append(vecs)
    rng = np.random.default_rng(9)
    row_maps, surv, off = [], [], 0
    for vecs in part_vecs:
        keep = rng.random(len(vecs)) >= 0.05
        rmap = np.full(len(vecs), -1, np.int64)
        rmap[keep] = off + np.arange(int(keep.sum()))
        off += int(keep.sum())
        row_maps.append(rmap)
        surv.append(vecs[keep])
    mseg, col = _seg_col(np.concatenate(surv, axis=0))
    r, p = RGraphIndex(), PGraphIndex()
    r.merge(parts["r"], mseg, col, row_maps)
    p.merge(parts["p"], mseg, col, row_maps)
    _same_index(r, p)
    assert p.donated_rows == max(int((m >= 0).sum()) for m in row_maps)
    assert p.inserted_rows == len(mseg.columns["embedding"]) - p.donated_rows


# ---------------------------------------------------------------------------
# the engine on a TRACY GRAPH store
# ---------------------------------------------------------------------------

CFG = tracy.TracyConfig(n_rows=2400, dim=128, seed=7, flush_rows=600,
                        fanout=64)


def port_schema(dim):
    return Schema([
        Column("embedding", ColumnType.VECTOR, dim=dim,
               index=IndexKind.GRAPH),
        Column("coordinate", ColumnType.SPATIAL, index=IndexKind.ZORDER),
        Column("content", ColumnType.TEXT, index=IndexKind.INVERTED),
        Column("time", ColumnType.SCALAR, index=IndexKind.BTREE),
        Column("likes", ColumnType.SCALAR, index=IndexKind.BTREE)])


def port_config():
    return LSMConfig(flush_rows=CFG.flush_rows, fanout=CFG.fanout,
                     pq_m=CFG.pq_m, quantize_vectors=False)


@pytest.fixture(scope="module")
def graph_stores():
    ref, data = tracy.build_store(CFG, vector_index=RIndexKind.GRAPH,
                                  quantize=False)
    port = LSMStore(port_schema(CFG.dim), port_config(), device="cpu")
    replay = tracy.TracyData(CFG)
    done = 0
    while done < CFG.n_rows:
        n = min(CFG.flush_rows, CFG.n_rows - done)
        port.put(*replay.batch(n))
        done += n
    port.flush()
    converted = convert.store_from_arrays(
        port_schema(CFG.dim), [export(s) for s in ref.segments],
        port_config(), device="cpu", unique_pks=ref.unique_pks)
    return ref, {"put_stream": port, "converted": converted}, data


def _same(r_out, p_out):
    assert len(r_out) == len(p_out)
    for (r_rows, r_st), (p_rows, p_st) in zip(r_out, p_out):
        assert [(r.pk, r.score) for r in p_rows] == \
            [(r.pk, r.score) for r in r_rows]
        assert dataclasses.asdict(p_st) == dataclasses.asdict(r_st)


def _run(r_ex, p_ex, queries, r_plans=None, p_plans=None):
    r_ops._seen_shapes.clear()
    p_ops._seen_shapes.clear()
    r_out = r_ex.execute_many(queries, plans=r_plans)
    p_out = p_ex.execute_many([to_port(x) for x in queries], plans=p_plans)
    _same(r_out, p_out)
    return p_out


def _draw(data, seed, n, recall_target, where=None):
    data.rng = np.random.default_rng(seed)
    return [rq.HybridQuery(where=where, ranks=[rq.VectorRank(
        "embedding", data.query_vec(), 1.0)], k=10,
        recall_target=recall_target) for _ in range(n)]


def test_graph_indexes_build_bit_for_bit(graph_stores):
    ref, ports, _ = graph_stores
    for source in ("put_stream", "converted"):
        segs = ports[source].segments
        assert len(segs) == len(ref.segments) == 4
        for a, b in zip(ref.segments, segs):
            _same_index(a.indexes["embedding"], b.indexes["embedding"],
                        counters=source == "put_stream")
    pg = pack_graphs(ports["put_stream"].segments, "embedding")
    assert pg is not None and pg.neighbors.shape == (CFG.n_rows, 16)


@pytest.mark.parametrize("source", ["put_stream", "converted"])
def test_planner_picks_graph_with_the_same_explain(graph_stores, source):
    ref, ports, data = graph_stores
    r_ex, p_ex = RExecutor(ref), PExecutor(ports[source])
    for qq in _draw(data, 20, 3, 0.95):
        r_plan, p_plan = r_ex.plan(qq), p_ex.plan(to_port(qq))
        assert p_plan.graph and p_plan.graph_r == 16
        assert (p_plan.kind, p_plan.graph_beam, p_plan.graph_hops) == \
            (r_plan.kind, r_plan.graph_beam, r_plan.graph_hops)
        assert p_plan.describe() == r_plan.describe()
        assert "GraphSearchTopK" in p_plan.describe()
    exact = _draw(data, 20, 1, None)[0]
    assert not p_ex.plan(to_port(exact)).graph


@pytest.mark.parametrize("source", ["put_stream", "converted"])
def test_graph_results_and_stats_match(graph_stores, source):
    """The planner's own graph plans, as a batch (the host path) and one
    query at a time: results and ExecStats (``rows_scanned`` the gathered
    count) equal the reference's."""
    ref, ports, data = graph_stores
    r_ex, p_ex = RExecutor(ref), PExecutor(ports[source])
    qs = _draw(data, 30, 4, 0.95)
    out = _run(r_ex, p_ex, qs)
    assert all("dispatch=graph" in st.plan for _, st in out)
    assert all(0 < st.rows_scanned < CFG.n_rows for _, st in out)
    _run(r_ex, p_ex, qs[:1])


def test_widened_beam_is_bitwise_the_exact_dispatch(graph_stores):
    ref, ports, data = graph_stores
    r_ex, p_ex = RExecutor(ref), PExecutor(ports["put_stream"])
    for ti in range(2):
        qa = _draw(data, 60 + ti, 4, 0.95)
        qb = _draw(data, 60 + ti, 4, None)
        r_plans = [r_planner.plan(r_ex.catalog, x) for x in qa]
        p_plans = [p_planner.plan(p_ex.catalog, to_port(x)) for x in qa]
        for p in r_plans + p_plans:
            assert p.graph
            p.graph_beam, p.graph_hops = KMAX, 12
        graph = _run(r_ex, p_ex, qa, r_plans, p_plans)
        exact = p_ex.execute_many([to_port(x) for x in qb])
        assert [[(r.pk, r.score) for r in rows] for rows, _ in graph] == \
            [[(r.pk, r.score) for r in rows] for rows, _ in exact]


def test_filtered_graph_parity(graph_stores):
    ref, ports, data = graph_stores
    r_ex, p_ex = RExecutor(ref), PExecutor(ports["put_stream"])
    where = rq.Range("time", 100, 600)
    qa = _draw(data, 123, 4, 0.95, where)
    qb = _draw(data, 123, 4, None, where)
    r_plans = [r_planner.plan_shared_scan(r_ex.catalog, x) for x in qa]
    p_plans = [p_planner.plan_shared_scan(p_ex.catalog, to_port(x))
               for x in qa]
    for p in r_plans + p_plans:
        assert p.graph
        p.graph_beam, p.graph_hops = KMAX, 12
    graph = _run(r_ex, p_ex, qa, r_plans, p_plans)
    exact = p_ex.execute_many([to_port(x) for x in qb])
    assert [[(r.pk, r.score) for r in rows] for rows, _ in graph] == \
        [[(r.pk, r.score) for r in rows] for rows, _ in exact]


def test_sharded_graph_parity():
    """Two shards of a TRACY GRAPH store: the graph choice threads through
    the fan-out; results, ExecStats and EXPLAIN equal the reference's and,
    at a widened beam, the sharded exact dispatch's."""
    cfg = tracy.TracyConfig(n_rows=2400, dim=128, seed=11, flush_rows=600,
                            fanout=64)
    ref = RShardRouter(tracy.tweet_schema(cfg.dim, RIndexKind.GRAPH),
                       tracy.LSMConfig(flush_rows=cfg.flush_rows,
                                       fanout=cfg.fanout,
                                       quantize_vectors=False), n_shards=2)
    port = PShardRouter(port_schema(cfg.dim),
                        LSMConfig(flush_rows=cfg.flush_rows,
                                  fanout=cfg.fanout, quantize_vectors=False),
                        n_shards=2, device="cpu")
    for router in (ref, port):
        data = tracy.TracyData(cfg)
        done = 0
        while done < cfg.n_rows:
            n = min(cfg.flush_rows, cfg.n_rows - done)
            router.put(*data.batch(n))
            done += n
        router.flush()
    r_ex, p_ex = RShardedExecutor(ref), PShardedExecutor(port)
    qa = _draw(data, 77, 4, 0.95)
    qb = _draw(data, 77, 4, None)
    r_plan, p_plan = r_ex.plan(qa[0]), p_ex.plan(to_port(qa[0]))
    assert p_plan.graph and "dispatch=graph(R=" in p_plan.describe()
    assert p_plan.describe() == r_plan.describe()
    _run(r_ex, p_ex, qa)
    r_log, p_log = r_plan.logical, p_plan.logical
    for p in (r_log, p_log):
        p.graph_beam, p.graph_hops = KMAX, 12
    graph = _run(r_ex, p_ex, qa, [r_log] * 4, [p_log] * 4)
    exact = p_ex.execute_many([to_port(x) for x in qb])
    assert [[(r.pk, r.score) for r in rows] for rows, _ in graph] == \
        [[(r.pk, r.score) for r in rows] for rows, _ in exact]
    for _, st in graph:
        assert st.shards == 2
