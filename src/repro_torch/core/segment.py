"""Immutable columnar segments — the SST-file analog (DESIGN.md §2).

A segment stores rows sorted by primary key in fixed-height blocks of
``BLOCK_ROWS`` (the read unit). Block handles are
(segment_id, block_id) pairs; the per-segment secondary indexes map
attribute values / centroids to block handles + in-block offsets, mirroring
the paper's "(vector, block handle) pairs" posting lists.
"""
from __future__ import annotations

import dataclasses
import itertools
import threading
from collections import OrderedDict
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.types import BLOCK_ROWS, Schema
from repro_torch.kernels import fused_scan as fs_kernel

_seg_counter = itertools.count()


def pack_object_array(arr: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Flatten a TEXT/BLOB object array into (offsets i64 (n+1,),
    blob uint8) — the pickle-free array form indexes export."""
    parts = [v.encode("utf-8") if isinstance(v, str)
             else bytes(v) for v in arr]
    offsets = np.zeros(len(parts) + 1, np.int64)
    np.cumsum([len(p) for p in parts], out=offsets[1:])
    blob = np.frombuffer(b"".join(parts), np.uint8).copy() if parts \
        else np.zeros(0, np.uint8)
    return offsets, blob


def unpack_object_array(offsets: np.ndarray, blob: np.ndarray,
                        as_str: bool) -> np.ndarray:
    raw = blob.tobytes()
    out = np.empty(len(offsets) - 1, object)
    for i in range(len(out)):
        piece = raw[int(offsets[i]):int(offsets[i + 1])]
        out[i] = piece.decode("utf-8") if as_str else piece
    return out


@dataclasses.dataclass(frozen=True)
class BlockHandle:
    seg_id: int
    block_id: int

    def __repr__(self):
        return f"BH({self.seg_id}:{self.block_id})"


class Segment:
    """Immutable sorted run. ``indexes`` is populated by the index builders
    at flush/compaction time (the paper: vector index built in the
    background along with SST construction)."""

    def __init__(self, schema: Schema, pk: np.ndarray, seqno: np.ndarray,
                 tombstone: np.ndarray, columns: Dict[str, np.ndarray],
                 level: int = 0, seg_id: Optional[int] = None):
        order = np.argsort(pk, kind="stable")
        self.schema = schema
        self.seg_id = next(_seg_counter) if seg_id is None else seg_id
        self.level = level
        # input-row -> segment-row permutation; consumed exactly once (the
        # flush path extends the visibility index with it) then released
        self.sort_order: Optional[np.ndarray] = order
        self.pk = np.asarray(pk)[order]
        self.seqno = np.asarray(seqno)[order]
        self.tombstone = np.asarray(tombstone)[order]
        self.columns: Dict[str, np.ndarray] = {}
        for name, arr in columns.items():
            arr = np.asarray(arr)
            self.columns[name] = arr[order]
        self.n_rows = len(self.pk)
        self.indexes: Dict[str, Any] = {}
        # quantized residence tier: col name -> quantize.QuantizedColumn
        # (PQ codes in segment row order), populated at flush/compaction
        self.quantized: Dict[str, Any] = {}
        # bumped whenever derived per-segment content (quantized codes)
        # is assigned after construction: pack caches key on it, because
        # seg_id alone cannot distinguish a segment packed before its
        # codes arrived from the same segment packed after
        self.content_gen = 0
        # per-segment zone map (fence pointers) for the global index
        self.pk_min = int(self.pk[0]) if self.n_rows else 0
        self.pk_max = int(self.pk[-1]) if self.n_rows else 0

    # ---- blocks ----------------------------------------------------------
    @property
    def n_blocks(self) -> int:
        return (self.n_rows + BLOCK_ROWS - 1) // BLOCK_ROWS

    def block_rows(self, block_id: int) -> slice:
        lo = block_id * BLOCK_ROWS
        return slice(lo, min(lo + BLOCK_ROWS, self.n_rows))

    def read_block(self, col: str, block_id: int) -> np.ndarray:
        """Block-granular read — the unit the cost model charges for."""
        return self.columns[col][self.block_rows(block_id)]

    # ---- point lookups ----------------------------------------------------
    def get(self, key: int) -> Optional[int]:
        """Row index of the NEWEST version of ``key`` or None (binary
        search over sorted pk).  A segment can legally hold several
        versions of one pk — original + update ingested into the same
        memtable flush side by side — so the equal-pk run is resolved by
        max seqno, never by position."""
        i = int(np.searchsorted(self.pk, key))
        if i >= self.n_rows or self.pk[i] != key:
            return None
        j = int(np.searchsorted(self.pk, key, side="right"))
        if j - i == 1:
            return i
        return i + int(np.argmax(self.seqno[i:j]))

    def may_contain(self, key: int) -> bool:
        return self.n_rows > 0 and self.pk_min <= key <= self.pk_max

    def row(self, i: int) -> Dict[str, Any]:
        out = {"_pk": int(self.pk[i]), "_seqno": int(self.seqno[i]),
               "_tombstone": bool(self.tombstone[i])}
        for name, arr in self.columns.items():
            out[name] = arr[i]
        return out


@dataclasses.dataclass
class PackedColumn:
    """Cross-segment superbatch: one column of every visible segment
    stacked into a single matrix, with parallel row-provenance arrays —
    the unit the fused scan->top-k kernel consumes (one launch per query
    batch instead of one per segment).  ``x`` and ``pks`` live on the
    store's device, uploaded once per (column, segment set) and padded to
    a multiple of the fused scan's block (zero rows, SENTINEL pks); the
    provenance arrays stay on the host, where candidates are resolved."""
    x: torch.Tensor          # (rows, d) fp32 stacked column values
    pks: torch.Tensor        # (rows,) int32 primary keys
    sids: np.ndarray         # (N,) int64 owning segment id per row
    rows: np.ndarray         # (N,) int64 row index inside the segment
    offsets: np.ndarray      # (n_segs + 1,) int64 segment start offsets


# segments are immutable, so a packed column is valid for as long as its
# exact (col, seg_id...) combination is queried; a small LRU bounds the
# device memory pinned by superbatches that outlive compaction (each entry
# is a full fp32 copy of the packed column, so the cap is deliberately
# tight)
_pack_cache: "OrderedDict[Tuple, PackedColumn]" = OrderedDict()
_PACK_CACHE_CAP = 4
# query threads and the background flush worker share the LRU: an
# unguarded move_to_end/popitem pair from two threads corrupts the
# OrderedDict's internal links
_pack_lock = threading.Lock()


def pack_segments(segments: Sequence[Segment], col: str,
                  device: torch.device) -> PackedColumn:
    """Concatenate ``col`` across ``segments`` into one superbatch held on
    ``device``.  Primary keys must fit int32 (the kernel's tie-break key;
    the planner's fusable gate checks it)."""
    key = (col, str(device)) + tuple((s.seg_id, s.content_gen)
                                     for s in segments)
    with _pack_lock:
        hit = _pack_cache.get(key)
        if hit is not None:
            _pack_cache.move_to_end(key)
            return hit
    ns = [s.n_rows for s in segments]
    n = int(sum(ns))
    dim = int(np.shape(segments[0].columns[col])[1]) if segments else 0
    sentinel = int(fs_kernel.SENTINEL)
    rows = -(-n // fs_kernel.BLOCK_N) * fs_kernel.BLOCK_N
    x = torch.zeros((rows, dim), dtype=torch.float32, device=device)
    pks = torch.full((rows,), sentinel, dtype=torch.int32, device=device)
    lo = 0
    for s in segments:
        if s.n_rows:
            spk = np.asarray(s.pk, np.int64)
            if spk.min() < -sentinel - 1 or spk.max() >= sentinel:
                raise ValueError("packed primary keys must fit int32")
            x[lo:lo + s.n_rows] = torch.from_numpy(
                np.ascontiguousarray(s.columns[col], np.float32)).to(device)
            pks[lo:lo + s.n_rows] = torch.from_numpy(
                spk.astype(np.int32)).to(device)
        lo += s.n_rows
    packed = PackedColumn(
        x=x, pks=pks,
        sids=np.concatenate([np.full(n, s.seg_id, np.int64)
                             for s, n in zip(segments, ns)]),
        rows=np.concatenate([np.arange(n, dtype=np.int64) for n in ns]),
        offsets=np.cumsum([0] + ns).astype(np.int64))
    with _pack_lock:
        while len(_pack_cache) >= _PACK_CACHE_CAP:
            _pack_cache.popitem(last=False)       # evict least-recent
        _pack_cache[key] = packed
    return packed



@dataclasses.dataclass
class PackedCodes:
    """Quantized sibling of ``PackedColumn``: the PQ code matrices of the
    same segments stacked in the SAME row order as ``pack_segments``, so
    a packed row id indexes both the fp32 superbatch and the code
    superbatch.  The codes live on the store's device, padded like the
    packed column (code 0 past the last row); the codebooks stay on the
    host, where the per-query ADC tables are computed.  Only well-defined
    when every segment carries codes from one shared codebook set (one
    ``book_id``)."""
    codes: torch.Tensor      # (rows, m) uint8 PQ codes
    codebooks: np.ndarray    # (m, 256, dsub) fp32 shared codebooks
    book_id: int


def pack_quantized(segments: Sequence[Segment], col: str,
                   device: torch.device) -> Optional[PackedCodes]:
    """Stack ``col``'s PQ codes across ``segments`` onto ``device``
    (row-aligned with ``pack_segments``, cached beside it).  Returns None
    when any segment lacks codes or the segments' codebooks differ —
    callers fall back to the exact path."""
    qcols = [s.quantized.get(col) for s in segments]
    if not qcols or any(qc is None for qc in qcols):
        return None
    book_id = qcols[0].book_id
    if any(qc.book_id != book_id for qc in qcols[1:]):
        return None
    key = ("#codes", col, str(device)) + tuple((s.seg_id, s.content_gen)
                                               for s in segments)
    with _pack_lock:
        hit = _pack_cache.get(key)
        if hit is not None:
            _pack_cache.move_to_end(key)
            return hit
    n = int(sum(s.n_rows for s in segments))
    rows = -(-n // fs_kernel.BLOCK_N) * fs_kernel.BLOCK_N
    codes = np.zeros((rows, qcols[0].codes.shape[1]), np.uint8)
    codes[:n] = np.concatenate([qc.codes for qc in qcols])
    packed = PackedCodes(codes=torch.from_numpy(codes).to(device),
                         codebooks=qcols[0].codebooks, book_id=book_id)
    with _pack_lock:
        while len(_pack_cache) >= _PACK_CACHE_CAP:
            _pack_cache.popitem(last=False)
        _pack_cache[key] = packed
    return packed

def merge_segments(schema: Schema, segments: Sequence[Segment],
                   level: int, drop_tombstones: bool,
                   return_maps: bool = False):
    """K-way merge by primary key keeping the newest seqno per key
    (size-tiered compaction). Tombstones are dropped only when compacting
    into the bottom tier (no older data can be shadowed).

    With ``return_maps`` also returns, per input segment, an int64 array
    mapping each source row to its row in the merged segment (-1 when the
    row was shadowed or tombstone-dropped) — the plumbing mergeable
    per-segment indexes need to remap their entries without a rebuild.
    """
    if not segments:
        raise ValueError("nothing to merge")
    pk = np.concatenate([s.pk for s in segments])
    seqno = np.concatenate([s.seqno for s in segments])
    tomb = np.concatenate([s.tombstone for s in segments])
    cols = {c.name: np.concatenate([s.columns[c.name] for s in segments])
            for c in schema.columns}
    # newest version per key: sort by (pk, -seqno), keep first
    order = np.lexsort((-seqno, pk))
    spk, sseq, stomb = pk[order], seqno[order], tomb[order]
    keep = np.ones(len(spk), bool)
    keep[1:] = spk[1:] != spk[:-1]
    if drop_tombstones:
        keep &= ~stomb
    cols = {k: v[order][keep] for k, v in cols.items()}
    merged = Segment(schema, spk[keep], sseq[keep], stomb[keep], cols,
                     level=level)
    if not return_maps:
        return merged
    # surviving rows are already pk-sorted (strictly increasing after the
    # dedup), so Segment's stable argsort is the identity and the merged
    # row of the i-th kept sorted position is simply its rank
    concat_to_new = np.full(len(pk), -1, np.int64)
    concat_to_new[order[keep]] = np.arange(int(keep.sum()), dtype=np.int64)
    maps, lo = [], 0
    for s in segments:
        maps.append(concat_to_new[lo:lo + s.n_rows])
        lo += s.n_rows
    return merged, maps
