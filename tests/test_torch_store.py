"""Store parity: the port's LSM store (``repro_torch.core.lsm``, on the CPU)
against the JAX package's, fed one put/update/delete stream — the same
segment layout, the same ``Index.to_arrays()`` bitwise, the same
visibility answers — and the converter that builds a port store from a
reference store's exported arrays."""
import numpy as np
import pytest
import torch

from repro.core.lsm import LSMConfig as RConfig
from repro.core.lsm import LSMStore as RStore
from repro.core.types import Column as RColumn
from repro.core.types import ColumnType as RType
from repro.core.types import IndexKind as RKind
from repro.core.types import Schema as RSchema
from repro.core import visibility as r_vis
from repro.core.wal import pack_object_array
from repro_torch import convert
from repro_torch.core import segment as p_seg
from repro_torch.core import visibility as p_vis
from repro_torch.core.lsm import LSMConfig as PConfig
from repro_torch.core.lsm import LSMStore as PStore
from repro_torch.core.types import Column as PColumn
from repro_torch.core.types import ColumnType as PType
from repro_torch.core.types import IndexKind as PKind
from repro_torch.core.types import Schema as PSchema

WORDS = ["apple", "banana", "cherry", "delta", "echo", "foxtrot"]
COLS = [("embedding", "VECTOR", 16, "IVF"), ("coordinate", "SPATIAL", 0,
                                             "ZORDER"),
        ("content", "TEXT", 0, "INVERTED"), ("time", "SCALAR", 0, "BTREE")]


def schemas():
    r = RSchema([RColumn(n, RType[t], dim=d, index=RKind[k])
                 for n, t, d, k in COLS])
    p = PSchema([PColumn(n, PType[t], dim=d, index=PKind[k])
                 for n, t, d, k in COLS])
    return r, p


def batch(rng, pks):
    n = len(pks)
    return list(pks), {
        "embedding": rng.normal(size=(n, 16)).astype(np.float32),
        "coordinate": rng.uniform(0, 10, (n, 2)).astype(np.float32),
        "content": np.asarray([" ".join(rng.choice(WORDS, 3))
                               for _ in range(n)], object),
        "time": rng.uniform(0, 100, n)}


def stream(seed=11):
    """(op, payload) put/update/delete stream crossing flushes and a
    compaction."""
    rng = np.random.default_rng(seed)
    ops = []
    for lo in range(0, 2400, 300):
        ops.append(("put", batch(rng, range(lo, lo + 300))))
    ops.append(("put", batch(rng, rng.choice(2400, 150, replace=False))))
    ops.append(("delete", rng.choice(2400, 90, replace=False).tolist()))
    ops.append(("flush", None))
    ops.append(("put", batch(rng, range(2400, 2700))))
    ops.append(("delete", [5, 2401, 99999]))
    ops.append(("put", batch(rng, [7, 2402, 2700])))
    return ops


def feed(store, ops):
    for op, payload in ops:
        if op == "put":
            store.put(*payload)
        elif op == "delete":
            store.delete(payload)
        else:
            store.flush()


@pytest.fixture(scope="module")
def twin_stores():
    rs, ps = schemas()
    ref = RStore(rs, RConfig(flush_rows=512, fanout=4, pq_m=4))
    port = PStore(ps, PConfig(flush_rows=512, fanout=4, pq_m=4),
                  device="cpu")
    ops = stream()
    feed(ref, ops)
    feed(port, ops)
    return ref, port


def _seg_pos(store):
    return {s.seg_id: i for i, s in enumerate(store.segments)}


def test_same_segment_layout(twin_stores):
    ref, port = twin_stores
    assert [(s.level, s.n_rows) for s in port.segments] == \
        [(s.level, s.n_rows) for s in ref.segments]
    assert len(port.segments) >= 2 and port.metrics["compactions"] >= 1
    for rs, ps in zip(ref.segments, port.segments):
        np.testing.assert_array_equal(ps.pk, rs.pk)
        np.testing.assert_array_equal(ps.seqno, rs.seqno)
        np.testing.assert_array_equal(ps.tombstone, rs.tombstone)
        for name in rs.columns:
            np.testing.assert_array_equal(ps.columns[name], rs.columns[name])
    assert port.memtable_rows == ref.memtable_rows
    assert port.unique_pks == ref.unique_pks is False
    for pk in (0, 5, 7, 2401, 2700, 12345):
        rg, pg = ref.get(pk), port.get(pk)
        assert (rg is None) == (pg is None)
        if rg is not None:
            assert rg["_seqno"] == pg["_seqno"]


@pytest.mark.parametrize("col", [c[0] for c in COLS])
def test_same_index_arrays(twin_stores, col):
    ref, port = twin_stores
    for rs, ps in zip(ref.segments, port.segments):
        ra, pa = rs.indexes[col].to_arrays(), ps.indexes[col].to_arrays()
        assert sorted(ra) == sorted(pa)
        for key in ra:
            np.testing.assert_array_equal(pa[key], ra[key], err_msg=key)
        assert ps.indexes[col].device.type == "cpu"


def test_same_quantized_codes(twin_stores):
    ref, port = twin_stores
    for rs, ps in zip(ref.segments, port.segments):
        np.testing.assert_array_equal(ps.quantized["embedding"].codes,
                                      rs.quantized["embedding"].codes)


def test_same_visibility(twin_stores):
    ref, port = twin_stores
    rv, pv = r_vis.visibility_index(ref), p_vis.visibility_index(port)
    rpos, ppos = _seg_pos(ref), _seg_pos(port)
    for rs, ps in zip(ref.segments, port.segments):
        rows = np.arange(rs.n_rows)
        np.testing.assert_array_equal(
            pv.visible_mask(np.full(len(rows), ps.seg_id), rows),
            rv.visible_mask(np.full(len(rows), rs.seg_id), rows))
    pks = np.arange(-3, 2800)
    r_sid, r_row, r_found = rv.lookup_pks(pks)
    p_sid, p_row, p_found = pv.lookup_pks(pks)
    np.testing.assert_array_equal(p_found, r_found)
    f = r_found
    to_pos = np.vectorize(lambda s, pos: pos.get(int(s), -1))
    np.testing.assert_array_equal(to_pos(p_sid[f], ppos),
                                  to_pos(r_sid[f], rpos))
    np.testing.assert_array_equal(p_row[f], r_row[f])


def test_pack_segments_keeps_the_column_on_the_device(twin_stores):
    _, port = twin_stores
    segs, dev = port.segments, torch.device("cpu")
    packed = p_seg.pack_segments(segs, "embedding", dev)
    n = sum(s.n_rows for s in segs)
    assert packed.x.device == dev and packed.x.shape[0] % 512 == 0
    np.testing.assert_array_equal(
        packed.x[:n].numpy(),
        np.concatenate([s.columns["embedding"] for s in segs]))
    np.testing.assert_array_equal(packed.pks[:n].numpy(),
                                  np.concatenate([s.pk for s in segs]))
    assert (packed.x[n:] == 0).all() and (packed.pks[n:] == 2**31 - 1).all()
    # cached per segment set: the next batch uploads nothing
    assert p_seg.pack_segments(segs, "embedding", dev) is packed
    big = p_seg.Segment(port.schema, np.asarray([2**31]), np.zeros(1),
                        np.zeros(1, bool),
                        {c.name: np.asarray(segs[0].columns[c.name][:1])
                         for c in port.schema.columns})
    with pytest.raises(ValueError, match="int32"):
        p_seg.pack_segments([big], "embedding", dev)


def export(seg):
    """A reference segment as the converter's flat arrays."""
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


def test_converter_carries_the_state(twin_stores):
    ref, port = twin_stores
    ref.flush()
    port.flush()
    _, ps = schemas()
    conv = convert.store_from_arrays(
        ps, [export(s) for s in ref.segments],
        PConfig(flush_rows=512, fanout=4, pq_m=4), device="cpu",
        unique_pks=ref.unique_pks)
    assert [(s.level, s.n_rows) for s in conv.segments] == \
        [(s.level, s.n_rows) for s in ref.segments]
    for rs, cs in zip(ref.segments, conv.segments):
        np.testing.assert_array_equal(cs.pk, rs.pk)
        np.testing.assert_array_equal(cs.columns["content"],
                                      rs.columns["content"])
        for col in rs.indexes:
            ra, ca = rs.indexes[col].to_arrays(), cs.indexes[col].to_arrays()
            for key in ra:
                np.testing.assert_array_equal(ca[key], ra[key])
    rv, cv = r_vis.visibility_index(ref), p_vis.visibility_index(conv)
    pks = np.arange(0, 2800)
    np.testing.assert_array_equal(cv.lookup_pks(pks)[2],
                                  rv.lookup_pks(pks)[2])
    assert conv.unique_pks is False and conv.n_rows == ref.n_rows
    # the converted store takes writes where the exporting store left off
    assert conv._seqno == ref._seqno
