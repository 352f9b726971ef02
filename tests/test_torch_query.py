"""Slice parity: exact hybrid NN and filter queries over one TRACY store,
run through ``Executor.execute_many`` in the port (on the CPU) and in the
JAX package (default backend).  At this size every distance is below
``HOST_FLOP_CUTOFF``, so pk, score, ``ExecStats`` (plan text included),
plan kind, dispatch and plain EXPLAIN must match exactly — for batches of
8 (the shared-scan groups) and for single queries, on a port store fed the
same put stream and on one converted from the reference's arrays."""
import dataclasses

import numpy as np
import pytest

from benchmarks import tracy
from repro.core import query as rq
from repro.core.executor import Executor as RExecutor
from repro.core.wal import pack_object_array
from repro.kernels import ops as r_ops
from repro_torch import convert
from repro_torch.core import query as pq
from repro_torch.core.executor import Executor as PExecutor
from repro_torch.core.lsm import LSMConfig, LSMStore
from repro_torch.core.types import Column, ColumnType, IndexKind, Schema
from repro_torch.kernels import ops as p_ops

CFG = tracy.TracyConfig(n_rows=8000, dim=16)
TEMPLATES = ["t1", "t2", "t3", "t4", "t5", "t12",          # filter
             "t6", "t7", "t8", "t9", "t10", "t11", "t13"]  # NN


def port_schema(dim):
    return Schema([
        Column("embedding", ColumnType.VECTOR, dim=dim, index=IndexKind.IVF),
        Column("coordinate", ColumnType.SPATIAL, index=IndexKind.ZORDER),
        Column("content", ColumnType.TEXT, index=IndexKind.INVERTED),
        Column("time", ColumnType.SCALAR, index=IndexKind.BTREE),
        Column("likes", ColumnType.SCALAR, index=IndexKind.BTREE)])


def port_config(cfg):
    return LSMConfig(flush_rows=cfg.flush_rows, fanout=cfg.fanout,
                     pq_m=cfg.pq_m)


def to_port(o):
    """A reference query object as the port's."""
    if o is None:
        return None
    if isinstance(o, rq.HybridQuery):
        return pq.HybridQuery(where=to_port(o.where),
                              ranks=[to_port(r) for r in o.ranks], k=o.k,
                              select=o.select,
                              recall_target=o.recall_target)
    if isinstance(o, (rq.And, rq.Or)):
        return getattr(pq, type(o).__name__)(*[to_port(c)
                                               for c in o.children])
    if isinstance(o, rq.Not):
        return pq.Not(to_port(o.child))
    return getattr(pq, type(o).__name__)(
        **{f.name: getattr(o, f.name) for f in dataclasses.fields(o)})


def export(seg):
    a = {"pk": seg.pk, "seqno": seg.seqno, "tombstone": seg.tombstone,
         "meta": np.asarray([seg.level, seg.seg_id], np.int64)}
    for c in seg.schema.columns:
        arr = seg.columns[c.name]
        if arr.dtype == object:
            a[f"col.{c.name}.offsets"], a[f"col.{c.name}.blob"] = \
                pack_object_array(arr)
        else:
            a[f"col.{c.name}"] = arr
    for name, qc in seg.quantized.items():
        a[f"pq.{name}.codes"] = qc.codes
        a[f"pq.{name}.codebooks"] = qc.codebooks
    for name, idx in seg.indexes.items():
        for key, val in idx.to_arrays().items():
            a[f"idx.{name}.{key}"] = val
    return a


@pytest.fixture(scope="module")
def slice_stores():
    ref, data = tracy.build_store(CFG)
    port = LSMStore(port_schema(CFG.dim), port_config(CFG), device="cpu")
    replay = tracy.TracyData(CFG)           # the same seeded put stream
    done = 0
    while done < CFG.n_rows:
        n = min(CFG.flush_rows, 2048, CFG.n_rows - done)
        port.put(*replay.batch(n))
        done += n
    port.flush()
    converted = convert.store_from_arrays(
        port_schema(CFG.dim), [export(s) for s in ref.segments],
        port_config(CFG), device="cpu", unique_pks=ref.unique_pks)
    search, nn = tracy.make_templates(data)
    fns = {f.__name__: f for f in search + nn}
    queries = {name: [fns[name]() for _ in range(8)] for name in TEMPLATES}
    return ref, {"put_stream": port, "converted": converted}, queries


def assert_same(r_out, p_out):
    assert len(r_out) == len(p_out)
    for (r_rows, r_st), (p_rows, p_st) in zip(r_out, p_out):
        assert [(r.pk, r.score) for r in p_rows] == \
            [(r.pk, r.score) for r in r_rows]
        for a, b in zip(p_rows, r_rows):
            assert sorted(a.values) == sorted(b.values)
        for key in (p_rows[0].values if p_rows else ()):
            # one comparison a column: the rows' values stacked
            np.testing.assert_array_equal(
                np.asarray([a.values[key] for a in p_rows]),
                np.asarray([b.values[key] for b in r_rows]))
        assert dataclasses.asdict(p_st) == dataclasses.asdict(r_st)


@pytest.mark.parametrize("source", ["put_stream", "converted"])
@pytest.mark.parametrize("name", TEMPLATES)
def test_template_parity(slice_stores, source, name):
    ref, ports, queries = slice_stores
    port = ports[source]
    r_ex, p_ex = RExecutor(ref), PExecutor(port)
    rqs = queries[name]
    pqs = [to_port(x) for x in rqs]
    assert all(x.recall_target is None for x in rqs)
    r_ops._seen_shapes.clear()
    p_ops._seen_shapes.clear()
    batch = p_ex.execute_many(pqs)
    assert_same(r_ex.execute_many(rqs), batch)
    r_ops._seen_shapes.clear()
    p_ops._seen_shapes.clear()
    assert_same([r_ex.execute(rqs[0])], [p_ex.execute(pqs[0])])
    for r_q, p_q in zip(rqs[:2], pqs[:2]):
        r_plan, p_plan = r_ex.plan(r_q), p_ex.plan(p_q)
        assert (p_plan.kind, p_plan.fused) == (r_plan.kind, r_plan.fused)
        assert p_plan.describe() == r_plan.describe()       # plain EXPLAIN
    if name in ("t6", "t8", "t13"):
        # the batch takes the fused dispatch on both sides
        assert "dispatch=fused" in batch[0][1].plan.splitlines()[0]


def test_slice_covers_fused_staged_and_filter_plans(slice_stores):
    ref, ports, queries = slice_stores
    p_ex = PExecutor(ports["put_stream"])
    kinds = set()
    for name in TEMPLATES:
        for _, st in p_ex.execute_many([to_port(x) for x in queries[name]]):
            kinds.add(st.plan.split("(")[0])
    assert {"full_scan_nn", "union_nn", "index_intersect"} <= kinds
