"""The Z-order index's range probe in one launch: the port's
``ZOrderIndex.bitmap`` (``ops.rect_filter_blocks`` over a device copy of
the segment's Z-ordered points, the ``bitmap_filter_blocks`` kernel and
its plain version ``ref.bitmap_filter_blocks_ref``) against the JAX
package's per-block ``ZOrderIndex.bitmap``.

Masks are exact comparisons of fp32 values, so every mask here equals the
reference's bit for bit, and ``stats_snapshot()`` deltas match exactly:
the CPU path against the reference's default backend, the card's host
logic (reached with a CPU device) against its Pallas branch.  The slice's
t2 template (time range + ``GeoWithin``) goes through ``execute_many`` on
a store of several segments and through the sharded executor at 2 and 4
shards, with pks, scores, ``ExecStats``, plan kind and plain EXPLAIN
equal."""
import dataclasses
import types

import numpy as np
import pytest
import torch

from benchmarks import tracy
from repro.core import query as rq
from repro.core.executor import Executor as RExecutor
from repro.core.index.spatial import ZOrderIndex as RZOrder
from repro.core.lsm import LSMConfig as RConfig
from repro.core.shards import ShardedExecutor as RShardedExecutor
from repro.core.shards import ShardRouter as RShardRouter
from repro.kernels import ops as r_ops
from repro_torch.core import query as pq
from repro_torch.core.executor import Executor as PExecutor
from repro_torch.core.index.spatial import ZOrderIndex as PZOrder
from repro_torch.core.lsm import LSMConfig as PConfig
from repro_torch.core.lsm import LSMStore as PStore
from repro_torch.core.shards import ShardedExecutor as PShardedExecutor
from repro_torch.core.shards import ShardRouter as PShardRouter
from repro_torch.core.types import BLOCK_ROWS
from repro_torch.kernels import bitmap_filter as p_bf
from repro_torch.kernels import ops as p_ops
from repro_torch.kernels import ref as p_ref
from test_torch_query import port_schema, to_port

HOST = torch.device("cpu")
COL = types.SimpleNamespace(name="coordinate")
SIZES = [1, 127, 128, 129, 5000]
RECTS = {"none": (200.0, 200.0, 210.0, 210.0),   # no zone map overlaps
         "some": (20.0, 30.0, 45.0, 60.0),
         "every": (-1.0, -1.0, 101.0, 101.0),
         "edges": None,                           # a point's own values
         "lo_above_hi": (60.0, 60.0, 40.0, 40.0)}


def _points(n, kind, seed=3):
    """n points in [0, 100]^2 from a numpy seed: ``uniform``, ``dup``
    (drawn from 5 distinct points) or ``nan`` (every 7th point NaN in
    one or both coordinates)."""
    rng = np.random.default_rng(seed + n)
    pts = rng.uniform(0, 100, (n, 2)).astype(np.float32)
    if kind == "dup":
        pts = pts[rng.integers(0, min(n, 5), n)]
    elif kind == "nan":
        pts[::7, 0] = np.nan
        pts[3::14, 1] = np.nan
    return pts


def _rect(name, pts):
    if RECTS[name] is not None:
        return RECTS[name]
    fin = pts[np.isfinite(pts).all(axis=1)]
    if not len(fin):
        return RECTS["some"]
    a, b = fin[0], fin[len(fin) // 2]            # their values, as fp32
    lo, hi = np.minimum(a, b), np.maximum(a, b)
    return (float(lo[0]), float(lo[1]), float(hi[0]), float(hi[1]))


def _indexes(pts):
    seg = types.SimpleNamespace(columns={"coordinate": pts}, n_rows=len(pts))
    r, p = RZOrder(), PZOrder()
    p.device = "cpu"
    with np.errstate(invalid="ignore"):       # NaN points' Morton codes
        r.build(seg, COL)
        p.build(seg, COL)
    return seg, r, p


def _probe(seg, r, p, rect):
    """Both packages' range probe; returns (masks, stats deltas)."""
    r_ops._seen_shapes.clear()
    p_ops._seen_shapes.clear()
    b0 = r_ops.stats_snapshot()
    want = r.bitmap(seg, rq.GeoWithin("coordinate", rect))
    rd = tuple(a - b for a, b in zip(r_ops.stats_snapshot(), b0))
    b1 = p_ops.stats_snapshot()
    got = p.bitmap(seg, pq.GeoWithin("coordinate", rect))
    pd = tuple(a - b for a, b in zip(p_ops.stats_snapshot(), b1))
    return (got, want), (pd, rd)


@pytest.mark.parametrize("kind", ["uniform", "dup", "nan"])
@pytest.mark.parametrize("rect_name", list(RECTS))
@pytest.mark.parametrize("n", SIZES)
def test_range_probe_matches_the_reference(n, rect_name, kind):
    pts = _points(n, kind)
    seg, r, p = _indexes(pts)
    rect = _rect(rect_name, pts)
    (got, want), (pd, rd) = _probe(seg, r, p, rect)
    assert got.dtype == bool and got.shape == (n,)
    np.testing.assert_array_equal(got, want)
    assert pd == rd
    assert p.last_blocks_read == r.last_blocks_read
    if rect_name == "every":
        assert p.last_blocks_read == -(-n // BLOCK_ROWS)
    if rect_name == "none":
        assert not got.any()
        # a NaN point's zone map compares false to every bound: its block
        # is listed, and the filter drops the point
        assert p.last_blocks_read == 0 or kind == "nan"
    if rect_name == "edges" and np.isfinite(pts).all(axis=1).any():
        assert got.any()                      # the corner points pass


@pytest.mark.parametrize("n,rect_name,kind", [
    (129, "some", "nan"), (129, "edges", "nan"), (129, "none", "uniform"),
    (5000, "some", "nan"), (5000, "every", "nan")])
def test_card_path_probe_matches_pallas_branch(monkeypatch, n, rect_name,
                                               kind):
    """The card's host logic (one launch for the list, charged as one
    padded Pallas dispatch per block; an empty list charges nothing),
    reached with a CPU device, against the reference's per-block Pallas
    branch (interpret mode)."""
    monkeypatch.setattr(r_ops, "USE_PALLAS", True)
    pts = _points(n, kind)
    seg, r, p = _indexes(pts)
    rect = _rect(rect_name, pts)
    r_ops._seen_shapes.clear()
    p_ops._seen_shapes.clear()
    b0 = r_ops.stats_snapshot()
    want = r.bitmap(seg, rq.GeoWithin("coordinate", rect))
    rd = tuple(a - b for a, b in zip(r_ops.stats_snapshot(), b0))
    blocks = p._overlapping_blocks(rect)
    pts_t, rows_t = p.device_arrays(HOST)
    b1 = p_ops.stats_snapshot()
    got = p_ops._rect_blocks_kernel(pts_t, rows_t, blocks, rect, n,
                                    BLOCK_ROWS, HOST)
    assert tuple(a - b for a, b in zip(p_ops.stats_snapshot(), b1)) == rd
    assert rd[0] == len(blocks) and rd[1] == len(blocks) * p_bf.BLOCK_N
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", SIZES)
def test_plain_version_and_wrapper_match_the_per_block_filter(n):
    """``ref.bitmap_filter_blocks_ref`` and the wrapper on CPU tensors
    against the reference's per-block ``rect_filter`` scattered through
    the index's rows, for a list with repeats and ids out of range (the
    plain version skips those), at a partial last block."""
    pts = _points(n, "nan")
    _, r, p = _indexes(pts)
    rect = RECTS["some"]
    nb = -(-n // BLOCK_ROWS)
    blocks = np.asarray(list(range(0, nb, 2)) + [nb - 1, nb - 1, nb, -1],
                        np.int32)
    want = np.zeros(n, bool)
    for b in blocks:
        if 0 <= b < nb:
            sl = slice(b * BLOCK_ROWS, min((b + 1) * BLOCK_ROWS, n))
            want[r.rows[sl][r_ops.rect_filter(r.points[sl], rect)]] = True
    pts_t, rows_t = p.device_arrays(HOST)
    bounds = torch.from_numpy(p_ops._rect_bounds(rect))
    bt = torch.from_numpy(blocks)
    plain = p_ref.bitmap_filter_blocks_ref(pts_t, rows_t, bt, bounds, n,
                                           BLOCK_ROWS)
    np.testing.assert_array_equal(plain.numpy(), want)
    before = (p_bf.launches.value, p_bf.blocks_launches.value)
    out = p_bf.bitmap_filter_blocks(pts_t, rows_t, bt, bounds, n, BLOCK_ROWS)
    assert out.dtype == torch.int8
    np.testing.assert_array_equal(out.numpy().astype(bool), want)
    assert (p_bf.launches.value, p_bf.blocks_launches.value) == before
    empty = p_bf.bitmap_filter_blocks(pts_t, rows_t, bt[:0], bounds, n,
                                      BLOCK_ROWS)
    assert empty.shape == (n,) and not empty.any()


def test_list_wrapper_checks_its_operands():
    pts = torch.zeros((10, 2))
    rows = torch.arange(10, dtype=torch.int32)
    blocks = torch.zeros(1, dtype=torch.int32)
    bounds = torch.zeros((2, 2))
    call = p_bf.bitmap_filter_blocks
    with pytest.raises(ValueError, match="shapes"):
        call(pts, rows[:5], blocks, bounds, 10, 4)
    with pytest.raises(ValueError, match="shapes"):
        call(pts, rows, blocks, torch.zeros((3, 2)), 10, 4)
    with pytest.raises(TypeError, match="int32"):
        call(pts, rows.long(), blocks, bounds, 10, 4)
    with pytest.raises(TypeError, match="fp32"):
        call(pts.double(), rows, blocks, bounds, 10, 4)
    with pytest.raises(ValueError, match="block_rows"):
        call(pts, rows, blocks, bounds, 10, 0)
    with pytest.raises(ValueError, match="different devices"):
        call(pts, rows, blocks.to("meta"), bounds, 10, 4)
    meta = [t.to("meta") for t in (pts, rows, blocks, bounds)]
    with pytest.raises(ValueError, match="no kernel"):
        call(*meta, 10, 4)


def test_device_copy_is_dropped_on_merge_and_from_arrays():
    """The index's device copy follows its points: set at the first probe,
    dropped by ``merge`` and ``from_arrays``, rebuilt at the next probe,
    and never exported."""
    pa, pb = _points(700, "uniform", seed=5), _points(300, "nan", seed=6)
    seg_a, r_a, p_a = _indexes(pa)
    seg_b, r_b, p_b = _indexes(pb)
    rect = RECTS["some"]
    assert p_a._on_device is None
    _probe(seg_a, r_a, p_a, rect)
    held = p_a._on_device
    assert held is not None and held[0] == HOST
    assert p_a.device_arrays(HOST)[0] is held[1]         # uploaded once
    assert set(p_a.to_arrays()) == set(r_a.to_arrays())
    # merge a and b, dropping every third row of a
    rng = np.random.default_rng(8)
    keep = np.arange(700) % 3 != 0
    map_a = np.where(keep, np.cumsum(keep) - 1, -1).astype(np.int64)
    map_b = (int(keep.sum()) + rng.permutation(300)).astype(np.int64)
    n = int(keep.sum()) + 300
    merged = types.SimpleNamespace(n_rows=n)
    r_m, p_m = RZOrder(), PZOrder()
    p_m.device = "cpu"
    p_m._on_device = held                    # as if an earlier probe left it
    with np.errstate(invalid="ignore"):
        r_m.merge([r_a, r_b], merged, COL, [map_a, map_b])
        p_m.merge([p_a, p_b], merged, COL, [map_a, map_b])
    assert p_m._on_device is None
    (got, want), (pd, rd) = _probe(merged, r_m, p_m, rect)
    np.testing.assert_array_equal(got, want)
    assert pd == rd
    np.testing.assert_array_equal(p_m._on_device[1].numpy(), p_m.points)
    np.testing.assert_array_equal(p_m._on_device[2].numpy(), p_m.rows)
    p_m.from_arrays(r_a.to_arrays(), seg_a, COL)
    assert p_m._on_device is None
    (got, want), (pd, rd) = _probe(seg_a, r_a, p_m, rect)
    np.testing.assert_array_equal(got, want)
    assert pd == rd
    np.testing.assert_array_equal(p_m._on_device[1].numpy(), pa[r_a.rows])
    p_m.build(seg_b, COL)
    assert p_m._on_device is None


# ---------------------------------------------------------------------------
# t2 end to end
# ---------------------------------------------------------------------------

# large enough segments that the planner probes the Z-order index for
# t2's rectangle (as at the smoke's 2 M rows) rather than leaving it
# residual to the time range's BTREE probe, as it does below ~32 k rows
T2_CFG = tracy.TracyConfig(n_rows=98_304, dim=8, flush_rows=16_384,
                           fanout=100, pq_m=4)


def _geo_probes(ex, qs):
    """Queries whose plan probes the Z-order index."""
    return sum("indexed=[GeoWithin" in ex.plan(x).describe().splitlines()[0]
               for x in qs)


def _t2_queries(seed, n=8):
    data = tracy.TracyData(dataclasses.replace(T2_CFG, seed=seed))
    search, _ = tracy.make_templates(data)
    t2 = {f.__name__: f for f in search}["t2"]
    return [t2() for _ in range(n)]


def _fill(store, cfg):
    """``tracy.build_store``'s put stream (batches of at most 2,048)."""
    data = tracy.TracyData(cfg)
    done = 0
    while done < cfg.n_rows:
        n = min(cfg.flush_rows, 2048, cfg.n_rows - done)
        store.put(*data.batch(n))
        done += n
    store.flush()


def _same(r_out, p_out):
    assert len(r_out) == len(p_out)
    for (r_rows, r_st), (p_rows, p_st) in zip(r_out, p_out):
        assert [(r.pk, r.score) for r in p_rows] == \
            [(r.pk, r.score) for r in r_rows]
        assert dataclasses.asdict(p_st) == dataclasses.asdict(r_st)


def _spy(monkeypatch):
    """Count the port's list probes and per-block filter calls."""
    calls = {"blocks": 0, "rect": 0}
    list_op, rect_op = p_ops.rect_filter_blocks, p_ops.rect_filter

    def blocks(*a, **k):
        calls["blocks"] += 1
        return list_op(*a, **k)

    def rect(*a, **k):
        calls["rect"] += 1
        return rect_op(*a, **k)
    monkeypatch.setattr(p_ops, "rect_filter_blocks", blocks)
    monkeypatch.setattr(p_ops, "rect_filter", rect)
    return calls


def test_t2_parity_on_a_store_of_several_segments(monkeypatch):
    ref, _ = tracy.build_store(T2_CFG)
    port = PStore(port_schema(T2_CFG.dim), PConfig(
        flush_rows=T2_CFG.flush_rows, fanout=T2_CFG.fanout,
        pq_m=T2_CFG.pq_m), device="cpu")
    _fill(port, T2_CFG)
    sizes = [s.n_rows for s in port.segments]
    assert sizes == [s.n_rows for s in ref.segments]
    assert len(sizes) >= 5 and min(sizes) > BLOCK_ROWS
    rqs = _t2_queries(seed=21)
    pqs = [to_port(x) for x in rqs]
    r_ex, p_ex = RExecutor(ref), PExecutor(port)
    probes = _geo_probes(p_ex, pqs)
    assert probes == _geo_probes(r_ex, rqs) >= 6
    calls = _spy(monkeypatch)
    r_ops._seen_shapes.clear()
    p_ops._seen_shapes.clear()
    got = p_ex.execute_many(pqs)
    _same(r_ex.execute_many(rqs), got)
    assert calls["blocks"] == probes * len(sizes)
    assert sum(len(rows) for rows, _ in got) > 0
    for r_q, p_q in zip(rqs[:2], pqs[:2]):
        r_plan, p_plan = r_ex.plan(r_q), p_ex.plan(p_q)
        assert (p_plan.kind, p_plan.fused) == (r_plan.kind, r_plan.fused)
        assert p_plan.describe() == r_plan.describe()


@pytest.mark.parametrize("shards", [2, 4])
def test_t2_parity_through_the_sharded_executor(monkeypatch, shards):
    cfg = dataclasses.replace(T2_CFG, flush_rows=8_192)
    ref = RShardRouter(tracy.tweet_schema(cfg.dim), RConfig(
        flush_rows=cfg.flush_rows, fanout=cfg.fanout, pq_m=cfg.pq_m),
        n_shards=shards)
    port = PShardRouter(port_schema(cfg.dim), PConfig(
        flush_rows=cfg.flush_rows, fanout=cfg.fanout, pq_m=cfg.pq_m),
        n_shards=shards, device="cpu")
    for router in (ref, port):
        _fill(router, cfg)
    segs = [[s.n_rows for s in sh.segments] for sh in port.shards]
    assert segs == [[s.n_rows for s in sh.segments] for sh in ref.shards]
    assert all(len(s) >= 2 and min(s) > BLOCK_ROWS for s in segs)
    rqs = _t2_queries(seed=22)
    pqs = [to_port(x) for x in rqs]
    r_ex, p_ex = RShardedExecutor(ref), PShardedExecutor(port)
    calls = _spy(monkeypatch)
    r_ops._seen_shapes.clear()
    p_ops._seen_shapes.clear()
    _same(r_ex.execute_many(rqs), p_ex.execute_many(pqs))
    assert calls["blocks"] > 0
    for r_q, p_q in zip(rqs, pqs):
        r_ops._seen_shapes.clear()
        p_ops._seen_shapes.clear()
        _same([r_ex.execute(r_q)], [p_ex.execute(p_q)])
        r_plan, p_plan = r_ex.plan(r_q), p_ex.plan(p_q)
        assert (p_plan.kind, p_plan.fused) == (r_plan.kind, r_plan.fused)
        assert p_plan.describe() == r_plan.describe()


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 129, 5000, 2_097_152])
def test_list_kernel_matches_its_plain_version_on_the_card(n):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    dev = torch.device("cuda")
    pts = _points(n, "nan")
    _, _, p = _indexes(pts)
    pts_t, rows_t = p.device_arrays(dev)
    nb = -(-n // BLOCK_ROWS)
    bounds = torch.from_numpy(p_ops._rect_bounds(RECTS["some"])).to(dev)
    before = (p_bf.launches.value, p_bf.blocks_launches.value)
    for blocks in (np.arange(nb), np.arange(0, nb, 3), [nb - 1, nb, -1]):
        bt = torch.as_tensor(np.asarray(blocks, np.int32), device=dev)
        out = p_bf.bitmap_filter_blocks(pts_t, rows_t, bt, bounds, n,
                                        BLOCK_ROWS)
        want = p_ref.bitmap_filter_blocks_ref(pts_t, rows_t, bt, bounds, n,
                                              BLOCK_ROWS)
        torch.cuda.synchronize()
        assert torch.equal(out.bool(), want)
    assert (p_bf.launches.value, p_bf.blocks_launches.value) == \
        (before[0] + 3, before[1] + 3)
