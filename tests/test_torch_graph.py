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


# ---------------------------------------------------------------------------
# the card kernel's dataflow, modelled in numpy
# ---------------------------------------------------------------------------

def _less(ad, ap, bd, bp):
    """(d2, pk) order, NaN after every number (the kernel's less_dp)."""
    an, bn = bool(np.isnan(ad)), bool(np.isnan(bd))
    if an != bn:
        return bn
    if not an and ad != bd:
        return bool(ad < bd)
    return int(ap) < int(bp)


def _order(s):
    """Sort key of a survivor (d2, pk, row, key, ...) by (d2, pk, key)."""
    nan = bool(np.isnan(s[0]))
    return (nan, 0.0 if nan else float(s[0]), int(s[1]), int(s[3]))


def _rank_merge(old, surv, beam):
    """A rank merge of the (d2, pk, key)-sorted survivors into the
    (d2, pk)-sorted beam ``old`` of (d2, pk, row): an old entry lands at
    its index plus the survivors strictly below it, a survivor at its rank
    plus the old entries at or below it.  Returns the new beam and the rows
    of the survivors that entered it."""
    new = [None] * beam
    for i, (od, op, orow) in enumerate(old):
        pos = i + sum(_less(s[0], s[1], od, op) for s in surv)
        if pos < beam:
            new[pos] = (od, op, orow)
    entered = []
    for j, s in enumerate(surv):
        pos = j + sum(not _less(s[0], s[1], od, op) for od, op, _ in old)
        if pos < beam:
            new[pos] = (s[0], s[1], s[2])
            entered.append(s[2])
    assert None not in new
    return new, entered


def _pruned_walk(args, beam, hops):
    """The CUDA kernel's dataflow (csrc/graph_search.cu): each round
    (the seed, then each hop) expands only the rows that entered the
    traversal beam in the round before, scores the fresh rows (d2 summed
    over the features in order, one fp32 rounding an operation), keeps
    only those that can enter the traversal beam (strictly below its last
    entry) or, admitted, the result beam (strictly below its last entry),
    and rank-merges them; the walk stops once a round adds no row to the
    traversal beam.  Returns the four outputs and what the walk met: the
    hops each query ran, and the fresh rows kept out of the traversal beam
    by a (d2, pk) tie with its last entry."""
    q, x, nbr, ent, mask, pks = args
    nq, d = q.shape
    n = x.shape[0]
    inf = np.float32(np.inf)
    out = (np.full((nq, beam), inf, np.float32),
           np.full((nq, beam), SENT, np.int32),
           np.full((nq, beam), SENT, np.int32))
    vis = np.zeros((nq, n), bool)
    ran, ties = [], 0
    for qi in range(nq):
        empty = [(inf, SENT, SENT)] * beam
        trav, res = list(empty), list(empty)
        fresh = []                              # (row, sort key)
        for t, e in enumerate(ent[0]):
            if e != SENT and 0 <= e < n:
                vis[qi, e] = True
                fresh.append((int(e), t))
        front, h = [], 0
        while beam > 0:
            if h > 0:
                if h > hops or not front:
                    break
                fresh = []
                for f in front:
                    for c in nbr[f]:
                        if c >= 0 and not vis[qi, c]:
                            vis[qi, c] = True
                            fresh.append((int(c), int(c)))
            rows = np.array([r for r, _ in fresh], np.int64)
            acc = np.zeros(len(rows), np.float32)
            for j in range(d):
                diff = x[rows, j] - q[qi, j]
                acc = acc + diff * diff
            surv = []
            for (r, key), d2 in zip(fresh, acc):
                pk = pks[0, r]
                ties += (d2, pk) == trav[-1][:2]      # kept out by a tie
                to_b = _less(d2, pk, trav[-1][0], trav[-1][1])
                to_r = bool(mask[qi, r]) and _less(d2, pk, res[-1][0],
                                                   res[-1][1])
                if to_b or to_r:
                    surv.append((d2, pk, r, key, to_r))
            surv.sort(key=_order)
            trav, front = _rank_merge(trav, surv, beam)
            res, _ = _rank_merge(res, [s for s in surv if s[4]], beam)
            h += 1
        ran.append(h - 1)
        for i, (rd, rp, rr) in enumerate(res):
            out[0][qi, i], out[1][qi, i], out[2][qi, i] = rd, rp, rr
    words = np.packbits(vis, axis=1, bitorder="little").view(np.int32)
    return (*out, words), {"hops run": ran, "ties at the cut": ties}


def _twins(args):
    """The rows of each pk (rows 3k, 3k + 1, 3k + 2 share pk k in the
    ``ints`` cases) given row 3k's vector: every fresh row ties a sibling
    in (d2, pk), and the row decides."""
    q, x, nbr, ent, mask, pks = args
    x = x.copy()
    x[1::3] = x[0::3][:len(x[1::3])]
    x[2::3] = x[0::3][:len(x[2::3])]
    return q, x, nbr, ent, mask, pks


# (seed, nq, n, d, R, entries, mask kind, beam, hops, twins): exact sums
# with tied pks and -1 padding, the all-masked query, entries > beam, hops
# 0, beam 128 over 12 hops (the walks end by hop 7), a walk that stops
# before its last hop, and (d2, pk) ties at the beams' last slots
PRUNED_CASES = [(0, 8, 512, 16, 8, 5, "one_empty", 32, 4, False),
                (0, 8, 1024, 16, 16, 5, "partial", 64, 4, False),
                (0, 16, 512, 12, 4, 5, "one_empty", 40, 4, False),
                (1, 8, 512, 12, 8, 20, "full", 8, 3, False),
                (1, 8, 512, 12, 8, 20, "one_empty", 8, 0, False),
                (4, 8, 512, 16, 8, 5, "one_empty", 128, 12, False),
                (5, 8, 96, 16, 8, 5, "one_empty", 128, 12, False),
                (0, 8, 512, 16, 8, 5, "one_empty", 32, 4, True),
                (7, 8, 512, 16, 8, 12, "partial", 24, 6, True)]


@pytest.mark.parametrize(
    "seed,nq,n,d,r_deg,n_ent,mask_kind,beam,hops,twins", PRUNED_CASES)
def test_pruned_walk_is_bitwise_the_plain_version_and_pallas(
        seed, nq, n, d, r_deg, n_ent, mask_kind, beam, hops, twins):
    """Expanding only the rows new to the beam, dropping fresh rows that
    can enter neither beam and stopping once a round adds nothing to the
    traversal beam change no output: all four bitwise equal to the plain
    version and to the Pallas kernel in interpret mode (and its oracle)."""
    args = _case(seed, nq, n, d, r_deg, n_ent, "ints", mask_kind)
    if twins:
        args = _twins(args)
    got, met = _pruned_walk(args, beam, hops)
    for want in [_plain(args, beam, hops), *_reference(args, beam, hops)]:
        for g, w in zip(got, want):
            np.testing.assert_array_equal(_bits(g), _bits(w))
    ran = met["hops run"]
    assert max(ran) <= hops
    if mask_kind == "one_empty":
        assert (got[2][0] == SENT).all()
    if n == 96:                 # 96 rows under a beam of 128: the walk
        assert max(ran) < hops  # runs out of fresh rows and stops
    if twins:                   # ties at the traversal beam's last slot
        assert met["ties at the cut"] > 0


def test_pruned_walk_with_nan_rows_is_bitwise_the_plain_version():
    """Rows whose d2 is NaN sort after every number, (+inf, SENTINEL)
    empty slots included, so they enter neither beam; the pruned walk
    drops them as it scores them and stays bitwise the plain version."""
    args = list(_case(6, 8, 512, 16, 8, 5, "ints", "one_empty"))
    x = args[1].copy()
    rng = np.random.default_rng(6)
    x[rng.random(len(x)) < 1 / 8, 3] = np.nan
    args[1] = x
    for beam, hops in ((32, 4), (128, 12)):
        got, _ = _pruned_walk(args, beam, hops)
        want = _plain(args, beam, hops)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(_bits(g), _bits(w))
        nan_rows = set(np.flatnonzero(np.isnan(x).any(axis=1)).tolist())
        vis = np.unpackbits(got[3].view(np.uint8), axis=1,
                            bitorder="little").astype(bool)
        assert any(vis[:, r].any() for r in nan_rows)     # NaN rows seen
        assert not nan_rows & set(got[2][got[2] != SENT].tolist())


def test_graph_wrapper_constants_are_the_sources():
    """The wrapper computes the kernel's shared memory (which the launcher
    refuses unless it is its own) and its visited-words path from
    constants of its own: they must be csrc/graph_search.cu's."""
    import re
    from pathlib import Path
    src = (Path(p_gs.__file__).parent / "csrc"
           / "graph_search.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+)", src).group(1))
    # a tile holds a row a thread at most, and the launcher takes the
    # wrapper's tile sizes and no other
    assert p_gs.TILE_ROWS[0] == const("kThreads") == 256
    assert ("(tile_rows != 256 && tile_rows != 128 && tile_rows != 64\n"
            "          && tile_rows != 32)" in src)
    assert p_gs.TILE_ROWS == (256, 128, 64, 32)
    assert "constexpr int kXs = kDc + 4;" in src
    assert p_gs.STAGE_STRIDE == const("kDc") + 4
    assert (p_gs.STAGE_STRIDE // 4) % 2 == 1          # odd in float4s
    assert p_gs.SLOTS == const("kSlots")
    assert p_gs.HEADER == const("kHeader")
    assert "cap < 32 ||" in src and p_gs.GROUP == 32   # whole warp groups
    assert ("kSlots * tile_rows * kXs + kHeader + ((d + 3) & ~3)\n"
            "         + 5LL * cap + 13LL * beam + (shared_vis ? n / 32 : 0)"
            in src)
    # the layout: 2 x 256 (or fewer) x 68 staged floats, the counts, the
    # query, 5 words a fresh row (its row and 16-byte survivor record), 13
    # a beam slot, the visited words
    assert p_gs.smem_bytes(128, 40, 1024) == 4 * (
        2 * 256 * 68 + 4 + 128 + 5 * 1024 + 13 * 40)
    assert p_gs.smem_bytes(7, 8, 32, 100) == 4 * (
        2 * 256 * 68 + 4 + 8 + 5 * 32 + 13 * 8 + 100)
    assert p_gs.smem_bytes(128, 128, 8192, 0, 64) == 4 * (
        2 * 64 * 68 + 4 + 128 + 5 * 8192 + 13 * 128)
    # cap: a power of two, a run of 32 at least, holding a round's fresh
    # rows and the entries
    assert p_gs.capacity(40, 16, 8) == 1024
    assert p_gs.capacity(8, 8, 20) == 64 and p_gs.capacity(8, 2, 20) == 32
    assert p_gs.capacity(128, 16, 136) == 2048
    assert p_gs.capacity(0, 16, 0) == 32


LIMIT = 232_448      # shared memory a block may opt in to on sm_90


def test_graph_visited_words_path_rule():
    """The visited words go to shared memory while the block's layout with
    them fits a block's shared memory (232,448 bytes on sm_90), else to
    the output tensor in global memory: TRACY's GRAPH store (8,192 rows)
    keeps them in shared memory, 2,097,152 rows in global memory."""
    rule = p_gs.visited_path
    assert rule(8192, 128, 40, 16, 8, LIMIT) == "shared"
    assert rule(8192, 128, 128, 16, 8, LIMIT) == "shared"
    assert rule(2_097_152, 128, 40, 16, 8, LIMIT) == "global"
    top = p_gs.max_shared_rows(128, 40, 16, 8, LIMIT)
    assert top == 560_768 and top % 32 == 0
    assert rule(top, 128, 40, 16, 8, LIMIT) == "shared"
    assert rule(top + 32, 128, 40, 16, 8, LIMIT) == "global"
    assert p_gs.smem_bytes(128, 40, 1024, top // 32) <= 232_448 \
        < p_gs.smem_bytes(128, 40, 1024, top // 32 + 1)
    # a wider layout leaves fewer rows room
    assert p_gs.max_shared_rows(128, 128, 16, 136, LIMIT) < top
    assert p_gs.max_shared_rows(128, 2048, 16, 8, LIMIT) == 0


def _earlier_smem(d, beam, cap):
    """Shared memory of the earlier, unstaged kernel (commit 75ad3ab's
    wrapper's smem_bytes)."""
    return 4 * (d + 9 * beam + 5 * cap + 1)


@pytest.mark.parametrize("d", [1, 13, 67, 128, 1000, 4096])
def test_graph_takes_every_shape_the_earlier_kernel_took(d):
    """The graph path's callers pass a beam of at most 128 (``ops`` clamps
    it to KMAX) and a d of at most 4096 (its exact re-rank's MAX_DIM).
    Every such (d, beam, capacity) whose layout the earlier kernel (commit
    75ad3ab) fitted in a block's 232,448 bytes also fits the staged
    layout, in tiles of fewer rows where the lists leave no room for 256.
    """
    limit = LIMIT
    took = 0
    for beam in range(1, 129):
        cap = 32
        while _earlier_smem(d, beam, cap) <= limit:
            rows = p_gs.tile_rows(d, beam, cap, LIMIT)
            assert p_gs.smem_bytes(d, beam, cap, 0, rows) <= limit, \
                (d, beam, cap, rows)
            took += 1
            cap *= 2
    assert took == 128 * 9                      # caps 32 .. 8192
    # the tile shrinks only for the largest lists
    assert p_gs.tile_rows(d, 128, 2048, LIMIT) == 256
    assert p_gs.tile_rows(d, 128, 4096, LIMIT) == (128 if d > 1000 else 256)
    assert p_gs.tile_rows(d, 128, 8192, LIMIT) == 64


def test_graph_tile_rows_follow_the_capacity():
    """A tile holds 256 rows while the layout has room, fewer (128, 64,
    32) when a large capacity leaves none, and the wrapper refuses a shape
    that does not fit even at 32; the launcher's arguments follow the
    choice (``build.SIGNATURES``: cap, tile rows, shared flag, bytes)."""
    from repro_torch.kernels import build
    assert build.smem_per_block("cpu") == LIMIT
    assert p_gs.tile_rows(128, 40, 1024, LIMIT) == 256
    assert p_gs.tile_rows(128, 128, 8192, LIMIT) == 64
    assert p_gs.tile_rows(4096, 128, 8192, LIMIT) == 64
    assert p_gs.tile_rows(8000, 128, 8192, LIMIT) == 32
    assert p_gs.smem_bytes(20_000, 128, 8192, 0, 32) > 232_448
    assert p_gs.tile_rows(20_000, 128, 8192, LIMIT) == 32
    sig = build.SIGNATURES["graph_search"]["graph_search_topk_launch"]
    assert len(sig) == 22
    args = [torch.from_numpy(a) for a in _case(3, 8, 512, 8, 4, 5, "ints")]
    with pytest.raises(ValueError, match="shared memory"):
        wide = torch.zeros((8, 20_000), dtype=torch.float32)
        p_gs.graph_search_topk(wide, torch.zeros((512, 20_000)),
                               torch.full((512, 64), -1, dtype=torch.int32),
                               args[3], *args[4:], 128, 1)
