"""Carry a store's state across: build a port ``LSMStore`` from numpy arrays.

The system has no weights; its state is the store.  ``store_from_arrays``
takes each segment as a flat dict of numpy arrays, in the layout of the JAX
package's segment files (``repro.core.segment`` save format):

  ``pk`` (n,) int64, ``seqno`` (n,) int64, ``tombstone`` (n,) bool,
  ``meta`` (2,) int64 = (level, seg_id),
  ``col.<name>`` per column, or ``col.<name>.offsets`` + ``col.<name>.blob``
  for TEXT/BLOB columns (``segment.pack_object_array``),
  ``pq.<name>.codes`` + ``pq.<name>.codebooks`` for PQ residence,
  ``idx.<name>.<key>`` per index array (``SecondaryIndex.to_arrays()``;
  an IVF-PQ index carries its ``codes`` and ``codebooks`` there),

and rebuilds segments, indexes, PQ residence and the store's write
frontier from them, so a port store answers from exactly the state the
exporting store held.  ``router_from_arrays`` does so shard by shard for a
sharded store.  Only numpy arrays cross: nothing of the JAX package is
imported.
"""
from __future__ import annotations

from typing import Mapping, Optional, Sequence

import numpy as np

from repro_torch.core import quantize as qz
from repro_torch.core import segment as seg_lib
from repro_torch.core.lsm import LSMConfig, LSMStore
from repro_torch.core.shards import ShardRouter
from repro_torch.core.types import ColumnType, Schema
from repro_torch.kernels.ops import Device


def segment_from_arrays(store: LSMStore,
                        arrays: Mapping[str, np.ndarray]) -> seg_lib.Segment:
    """One segment (columns, PQ codes, indexes) of ``store``'s schema from
    its exported arrays.  Rows are already pk-sorted, so the segment keeps
    their order."""
    schema = store.schema
    level = int(arrays["meta"][0])
    cols = {}
    for c in schema.columns:
        key = f"col.{c.name}"
        if key in arrays:
            cols[c.name] = np.asarray(arrays[key])
        else:
            cols[c.name] = seg_lib.unpack_object_array(
                arrays[f"{key}.offsets"], arrays[f"{key}.blob"],
                as_str=(c.ctype == ColumnType.TEXT))
    seg = seg_lib.Segment(schema, np.asarray(arrays["pk"], np.int64),
                          np.asarray(arrays["seqno"], np.int64),
                          np.asarray(arrays["tombstone"], bool), cols,
                          level=level)
    seg.sort_order = None
    for c in schema.columns:
        ck = f"pq.{c.name}.codes"
        if ck in arrays:
            seg.quantized[c.name] = qz.QuantizedColumn(
                np.asarray(arrays[ck], np.uint8),
                np.asarray(arrays[f"pq.{c.name}.codebooks"], np.float32), 0)
    for c in schema.indexed_columns:
        prefix = f"idx.{c.name}."
        sub = {k[len(prefix):]: np.asarray(v) for k, v in arrays.items()
               if k.startswith(prefix)}
        if not sub:
            continue
        idx = store._make_index(c)
        if idx is not None:
            idx.from_arrays(sub, seg, c)
            seg.indexes[c.name] = idx
    return seg


def store_from_arrays(schema: Schema,
                      segments: Sequence[Mapping[str, np.ndarray]],
                      cfg: Optional[LSMConfig] = None,
                      device: Device = "cuda",
                      unique_pks: Optional[bool] = None) -> LSMStore:
    """A port store on ``device`` holding the given segments (oldest
    first, as the exporting store listed them) and an empty memtable.
    ``unique_pks`` is the exporting store's write-history flag (a delete
    clears it even once compaction dropped the tombstone); by default it
    is derived from the segments."""
    store = LSMStore(schema, cfg, device=device)
    segs = [segment_from_arrays(store, a) for a in segments]
    for seg in segs:
        store.segments.append(seg)
        store.global_index.on_new_segment(seg)
    # one fresh book id per distinct codebook set of a column, so segments
    # that shared books in the exporting store pack together here and
    # segments that did not fall back to the exact scan, as they did there
    for c in schema.columns:
        parts = [s.quantized[c.name] for s in segs if c.name in s.quantized]
        ids = {}
        for qc in parts:
            key = qc.codebooks.tobytes()
            if key not in ids:
                ids[key] = qz.fresh_book_id()
            qc.book_id = ids[key]
        if parts:
            store._pq_books[c.name] = (parts[0].book_id, parts[0].codebooks)
    live = [s for s in segs if s.n_rows]
    if live:
        pk = np.concatenate([s.pk for s in live])
        store._seqno = int(max(s.seqno.max() for s in live)) + 1
        store._seen_max_pk = int(pk.max())
        store.unique_pks = bool(len(np.unique(pk)) == len(pk) and not any(
            s.tombstone.any() for s in live))
    if unique_pks is not None:
        store.unique_pks = bool(unique_pks)
    return store


def router_from_arrays(schema: Schema,
                       shards: Sequence[Sequence[Mapping[str, np.ndarray]]],
                       cfg: Optional[LSMConfig] = None,
                       device: Device = "cuda",
                       unique_pks: Optional[Sequence[bool]] = None
                       ) -> ShardRouter:
    """A port ``ShardRouter`` on ``device`` whose shard i holds the
    segments ``shards[i]`` (``store_from_arrays`` per shard, in the
    exporting router's shard order, so pks keep their owning shard).
    ``unique_pks`` gives each shard's write-history flag."""
    router = ShardRouter(schema, cfg, n_shards=len(shards), device=device)
    flags = list(unique_pks) if unique_pks is not None \
        else [None] * len(shards)
    router.shards = [store_from_arrays(schema, segs, cfg, device=device,
                                       unique_pks=flag)
                     for segs, flag in zip(shards, flags)]
    return router
