"""Partitioned LSM store: memtable + immutable segments + size-tiered
compaction, with the unified secondary index framework built at flush /
compaction time (paper §3-§4).

Write path:  put/delete forward whole *columnar* batches to the chunked
memtable (O(#columns) per batch); the FlushScheduler seals full memtables
and turns them into level-0 Segments off the write critical path, building
all declared secondary indexes *with* the segment (the paper's central
ingestion claim vs global in-memory vector indexes).  Compaction *merges*
the per-segment indexes of the input tier (posting remap / sorted-run
merge / Z-order re-sort / centroid reuse) instead of rebuilding them.

Read path:   point gets via memtables (active + sealed) -> zone-map-pruned
segments (newest seqno wins); query execution lives in core.executor /
core.nra driven by the optimizer.

The store runs its device work (index build and probe kernels, the packed
columns the fused scan reads) on ``device``: the card unless the caller
asks for the CPU.  Durability (``LSMConfig.path``) is not ported yet.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import memtable as mt
from repro_torch.core import segment as seg_lib
from repro_torch.core.faults import NO_FAULTS, FaultInjector
from repro_torch.core.flush import FlushScheduler
from repro_torch.core.types import Column, ColumnType, Schema
from repro_torch.kernels.ops import Device, resolve_device
from repro_torch.obs import REGISTRY
from repro_torch.obs import trace as obs_trace


@dataclasses.dataclass
class LSMConfig:
    flush_rows: int = 4096
    flush_bytes: int = 0          # optional byte threshold (0 = rows only)
    fanout: int = 4               # size-tiered: merge when a tier has this many
    max_levels: int = 6
    build_indexes: bool = True
    merge_indexes: bool = True    # compaction merges indexes vs rebuilds
    pipeline: bool = False        # decouple seal from flush/compaction
    max_sealed: int = 4           # write-stall threshold (pipelined modes)
    background: bool = False      # drain on a worker thread (benchmarks)
    quantize_vectors: bool = True  # PQ residence tier for vector columns
    pq_m: int = 8                  # subquantizers (halved until d % m == 0)
    # durability: only the process-resident store (path=None) is ported
    path: Optional[str] = None


# what every durable entry point of the port raises with
NO_DURABILITY = "durability is not ported yet (ROADMAP queue 1, item 6)"


class LSMStore:
    def __init__(self, schema: Schema, cfg: Optional[LSMConfig] = None,
                 index_factory: Optional[Callable[[Column], Any]] = None,
                 memtable_factory: Optional[Callable[[Schema], Any]] = None,
                 device: Device = "cuda"):
        from repro_torch.core.index import (GlobalIndexSet,
                                            default_index_factory)
        self.schema = schema
        self.cfg = cfg or LSMConfig()
        if self.cfg.path:
            raise NotImplementedError(f"LSMConfig(path=...): "
                                      f"{NO_DURABILITY}")
        self.device = resolve_device(device)
        self._memtable_factory = memtable_factory or mt.MemTable
        self.memtable = self._memtable_factory(schema)
        self.sealed: List[Any] = []      # full memtables awaiting flush
        self.segments: List[seg_lib.Segment] = []
        self._seqno = 0
        self._index_factory = index_factory or default_index_factory
        self.global_index = GlobalIndexSet(schema)
        # quantized residence: col -> (book_id, codebooks); trained once
        # on the first flush, reused for every later flush so all of this
        # store's segments share one book (packable cross-segment)
        self._pq_books: Dict[str, Tuple[int, np.ndarray]] = {}
        # fast path: when every pk was written once and nothing deleted,
        # visibility resolution is the identity (skipped in NRA/executor)
        self.unique_pks = True
        self._seen_max_pk = -1
        self.metrics = {"flushes": 0, "compactions": 0, "puts": 0,
                        "deletes": 0, "noop_deletes": 0, "seals": 0,
                        "stalls": 0, "flush_s": 0.0, "compact_s": 0.0,
                        "index_build_s": 0.0, "index_merge_s": 0.0,
                        "index_rebuild_s": 0.0, "index_merges": 0,
                        "index_rebuilds": 0, "vis_extends": 0}
        self._on_delta: List[Callable] = []   # continuous-query hooks
        self._mt_epoch = 0                    # bumps on any memtable change
        self._mt_cache = None                 # (epoch, concat scan arrays)
        # store lock: every mutation of shared state (segments, sealed,
        # memtable, metrics, global_index, caches, PQ books) happens under
        # it.  Re-entrant so visibility helpers called from a publish
        # window can re-take it.  Expensive work (segment build, index
        # construction, PQ training) runs OUTSIDE; only the publish is
        # locked.  Lock order: never hold _lock while waiting on the
        # scheduler's condition variable.
        self._lock = threading.RLock()
        self.faults: FaultInjector = NO_FAULTS
        self._closed = False
        self.scheduler = FlushScheduler(self)

    def set_faults(self, faults: FaultInjector) -> None:
        """Wire a fault injector into every crash point this store passes
        through — test-only."""
        self.faults = faults

    def _make_index(self, col: Column):
        """A fresh index for ``col`` that runs its kernels on the store's
        device (the IVF build/probe and the spatial bitmap)."""
        idx = self._index_factory(col)
        if idx is not None:
            idx.device = self.device
        return idx

    @property
    def durable_seqno(self) -> int:
        """Highest seqno the store acknowledges: a process-resident store
        acknowledges everything (nothing survives it)."""
        return self._seqno - 1

    def close(self) -> None:
        """Idempotent shutdown: stop the background flush worker (it
        drains queued work first)."""
        if self._closed:
            return
        self._closed = True
        self.scheduler.close()

    # ------------------------------------------------------------------ write
    def put(self, pks: Sequence[int], batch: Dict[str, Any]) -> None:
        """Ingest one columnar batch: O(#columns) array appends into the
        active memtable; flush/compaction/indexing happen off this path
        via the scheduler.  Empty batches are a complete no-op (no delta
        hooks, no metrics)."""
        pks = np.asarray(pks, np.int64)
        if len(pks) == 0:
            return
        cbatch = batch
        with self._lock:
            self._track_unique(pks)
            self._seqno = self.memtable.put_batch(pks, batch, self._seqno)
            self._mt_epoch += 1
            self._mt_cache = None
            self.metrics["puts"] += len(pks)
            REGISTRY.inc("lsm.puts", len(pks))
            if self._on_delta and isinstance(self.memtable, mt.MemTable):
                # hand hooks the memtable's canonical numpy chunk
                # (zero-copy, already validated) — never per-row dicts
                cbatch = {name: chunks[-1] for name, chunks
                          in self.memtable._col_chunks.items()}
        # hooks and backpressure run unlocked: on_write may wait on the
        # scheduler's condition variable, which the worker needs _lock-free
        if self._on_delta:
            self._notify_delta(pks, cbatch, deleted=False)
        self.scheduler.on_write()

    def delete(self, pks: Sequence[int]) -> None:
        """Tombstone the given pks.  Deletes of never-written keys are
        no-ops: they write nothing and keep the ``unique_pks`` fast path
        (visibility resolution stays skippable)."""
        pks = np.asarray(pks, np.int64)
        if len(pks) == 0:
            return
        with self._lock:
            exists = self._contains_any_version(pks)
            if not exists.any():
                self.metrics["noop_deletes"] += len(pks)
                return
            live = pks[exists]
            self.unique_pks = False
            self._seqno = self.memtable.put_batch(live, {}, self._seqno,
                                                  tombstone=True)
            self._mt_epoch += 1
            self._mt_cache = None
            self.metrics["deletes"] += len(live)
            self.metrics["noop_deletes"] += int(len(pks) - len(live))
            REGISTRY.inc("lsm.deletes", len(live))
        self._notify_delta(live, None, deleted=True)
        self.scheduler.on_write()

    def _track_unique(self, pks: np.ndarray) -> None:
        if self.unique_pks:
            if int(pks.min()) <= self._seen_max_pk:
                self.unique_pks = False
            elif len(pks) > 1 and not (np.diff(pks) > 0).all() and \
                    len(np.unique(pks)) != len(pks):
                self.unique_pks = False
        self._seen_max_pk = max(self._seen_max_pk, int(pks.max()))

    def _contains_any_version(self, pks: np.ndarray) -> np.ndarray:
        """Bool mask: does any version (including tombstones) of each pk
        exist in the store?  Vectorized over segments; memtables checked
        via their O(1) key maps."""
        out = np.zeros(len(pks), bool)
        if self._seen_max_pk < 0:
            return out
        cand = np.nonzero(pks <= self._seen_max_pk)[0]
        if not len(cand):
            return out
        for m in (self.memtable, *self.sealed):
            if len(m):
                latest = m._latest
                for i in cand:
                    if int(pks[i]) in latest:
                        out[i] = True
        rest = cand[~out[cand]]
        for seg in self.segments:
            if not len(rest):
                break
            if seg.n_rows == 0:
                continue
            pos = np.minimum(np.searchsorted(seg.pk, pks[rest]),
                             seg.n_rows - 1)
            hit = seg.pk[pos] == pks[rest]
            out[rest[hit]] = True
            rest = rest[~hit]
        return out

    def on_delta(self, fn: Callable) -> None:
        """Register a hook called with ``(pks, batch, deleted)`` on writes
        — ``pks`` an int64 array and ``batch`` a columnar dict of numpy
        arrays (None for deletes).  Drives incremental view maintenance
        and ASYNC continuous queries."""
        self._on_delta.append(fn)

    def _notify_delta(self, pks, batch, deleted: bool) -> None:
        for fn in self._on_delta:
            fn(pks, batch, deleted)

    # ------------------------------------------------- flush / compaction
    def seal(self) -> bool:
        """Move the active memtable onto the flush queue (O(1) swap)."""
        with self._lock:
            if not len(self.memtable):
                return False
            self.sealed.append(self.memtable)
            self.memtable = self._memtable_factory(self.schema)
            self._mt_epoch += 1
            self._mt_cache = None
            self.metrics["seals"] += 1
            REGISTRY.inc("lsm.seals")
            return True

    def flush(self) -> Optional[seg_lib.Segment]:
        """Seal the active memtable and drain all queued work; returns
        the segment the active memtable became (None if it was empty)."""
        sealed_now = self.seal()
        segs = self.scheduler.drain()
        return segs[-1] if (segs and sealed_now) else None

    def drain(self) -> List[seg_lib.Segment]:
        """Deterministically process all queued flushes + compactions
        (pipelined mode); returns the segments flushed."""
        return self.scheduler.drain()

    def _flush_sealed(self) -> seg_lib.Segment:
        """Turn the oldest sealed memtable into a level-0 segment with
        its indexes, then extend the visibility cache incrementally (a
        flush relocates versions without changing any pk's winner)."""
        from repro_torch.core import visibility as vis_lib
        with self._lock:
            mtab = self.sealed[0]
        t0 = time.perf_counter()
        with obs_trace.span("flush") as fsp:
            # build outside the lock: the sealed memtable is immutable
            # (only the active one takes writes) and the segment is
            # private until published, so index construction never
            # blocks writers/readers
            pk, seqno, tomb, cols = mtab.scan_arrays()
            seg = seg_lib.Segment(self.schema, pk, seqno, tomb, cols,
                                  level=0)
            self._build_indexes(seg)
            self._quantize_segment(seg)
            with self._lock:
                # atomic publish: readers see (old segments + sealed) or
                # (new segment, sealed popped) — never the torn middle
                pre_key = (self._seqno,
                           tuple(s.seg_id for s in self.segments))
                self.segments.append(seg)
                self.sealed.pop(0)
                self._mt_epoch += 1
                self._mt_cache = None
                self.global_index.on_new_segment(seg)
                if vis_lib.extend_cache_on_flush(self, pre_key, seg,
                                                 len(pk)):
                    self.metrics["vis_extends"] += 1
                seg.sort_order = None  # one-shot; don't retain 8B/row
                self.metrics["flushes"] += 1
                dt = time.perf_counter() - t0
                self.metrics["flush_s"] += dt
            REGISTRY.observe("lsm.flush_s", dt)
            REGISTRY.inc("lsm.flushes")
            if fsp.live:
                fsp.set(rows=len(pk), seg_id=seg.seg_id)
        return seg

    def _build_indexes(self, seg: seg_lib.Segment) -> None:
        """Per-segment index construction at SST-build time (paper §4)."""
        if not self.cfg.build_indexes:
            return
        t0 = time.perf_counter()
        for col in self.schema.indexed_columns:
            idx = self._make_index(col)
            if idx is not None:
                idx.build(seg, col)
                seg.indexes[col.name] = idx
        with self._lock:
            self.metrics["index_build_s"] += time.perf_counter() - t0

    # ------------------------------------------------ quantized residence
    def _vector_columns(self):
        return [c for c in self.schema.columns
                if c.ctype == ColumnType.VECTOR]

    def _quantize_segment(self, seg: seg_lib.Segment) -> None:
        """Encode-at-flush: PQ codes for every vector column, stored
        alongside the fp32 column (the quantized residence tier the fused
        quantized scan streams).  Codebooks come from the store-level
        cache — only the very first flush of a column trains."""
        if not self.cfg.quantize_vectors:
            return
        t0 = time.perf_counter()
        for col in self._vector_columns():
            self._encode_quantized(seg, col.name)
        with self._lock:
            self.metrics["quantize_s"] = \
                self.metrics.get("quantize_s", 0.0) \
                + (time.perf_counter() - t0)

    def _encode_quantized(self, seg: seg_lib.Segment, name: str) -> None:
        from repro_torch.core import quantize as qz
        vecs = np.asarray(seg.columns[name], np.float32)
        if not len(vecs):
            return
        cached = self._pq_books.get(name)
        if cached is None:
            qc = qz.quantize_column(vecs, m=self.cfg.pq_m)
            with self._lock:
                self._pq_books[name] = (qc.book_id, qc.codebooks)
        else:
            bid, books = cached
            qc = qz.QuantizedColumn(qz.encode(vecs, books), books, bid)
        seg.quantized[name] = qc
        seg.content_gen += 1      # invalidate packed-code cache entries

    def _merge_quantized(self, tier, merged, row_maps) -> None:
        """Compaction maintenance for the quantized tier: donate the
        largest part's codebooks and copy its codes through the row maps
        (``quantize.merge_quantized`` — assignment pass at most, never a
        retrain).  Parts without codes force a plain re-encode from the
        store's cached books."""
        from repro_torch.core import quantize as qz
        t0 = time.perf_counter()
        for col in self._vector_columns():
            parts = [s.quantized.get(col.name) for s in tier]
            if all(p is not None for p in parts) and any(
                    len(p.codes) for p in parts):
                merged.quantized[col.name] = qz.merge_quantized(
                    parts, merged.columns[col.name], row_maps)
                merged.content_gen += 1
            else:
                self._encode_quantized(merged, col.name)
        with self._lock:
            self.metrics["quantize_s"] = \
                self.metrics.get("quantize_s", 0.0) \
                + (time.perf_counter() - t0)

    def _compactable_level(self) -> Optional[int]:
        """Lowest level whose tier reached the size-tiered fanout."""
        counts: Dict[int, int] = {}
        for s in self.segments:
            counts[s.level] = counts.get(s.level, 0) + 1
        for level in range(self.cfg.max_levels):
            if counts.get(level, 0) >= self.cfg.fanout:
                return level
        return None

    def _compact_level(self, level: int) -> seg_lib.Segment:
        """Merge one full tier into a level+1 segment, *merging* the
        per-segment indexes through the compaction row maps instead of
        rebuilding them (paper §4's compaction-aware maintenance)."""
        with self._lock:
            tier = [s for s in self.segments if s.level == level]
            bottom = level + 1 >= self.cfg.max_levels or not any(
                s.level > level for s in self.segments)
        t0 = time.perf_counter()
        with obs_trace.span("compact", level=level,
                            n_inputs=len(tier)) as csp:
            # merge + index maintenance outside the lock: inputs are
            # immutable segments, the output is private until published
            merged, row_maps = seg_lib.merge_segments(
                self.schema, tier, level + 1, drop_tombstones=bottom,
                return_maps=True)
            merged.sort_order = None   # identity by construction; drop it
            if self.cfg.build_indexes:
                self._merge_or_rebuild_indexes(tier, merged, row_maps)
            if self.cfg.quantize_vectors:
                self._merge_quantized(tier, merged, row_maps)
            with self._lock:
                # single-assignment swap so concurrent readers iterating
                # self.segments never observe a half-replaced tier
                keep = [s for s in self.segments if s not in tier]
                keep.append(merged)
                self.segments = keep
                for s in tier:
                    self.global_index.on_drop_segment(s.seg_id)
                self.global_index.on_new_segment(merged)
                self.metrics["compactions"] += 1
                dt = time.perf_counter() - t0
                self.metrics["compact_s"] += dt
            REGISTRY.observe("lsm.compact_s", dt)
            REGISTRY.inc("lsm.compactions")
            if csp.live:
                csp.set(out_rows=merged.n_rows)
        return merged

    def _merge_or_rebuild_indexes(self, tier, merged, row_maps) -> None:
        """Index maintenance at compaction: structural merge when every
        input segment has a compatible built index, fresh rebuild
        otherwise; both paths are timed separately in ``metrics`` so the
        merge-vs-rebuild win is measurable."""
        for col in self.schema.indexed_columns:
            idx = self._make_index(col)
            if idx is None:
                continue
            parts = [s.indexes.get(col.name) for s in tier]
            mergeable = self.cfg.merge_indexes and all(
                p is not None and type(p) is type(idx) for p in parts)
            t0 = time.perf_counter()
            if mergeable:
                idx.merge(parts, merged, col, row_maps)
                with self._lock:
                    self.metrics["index_merge_s"] += \
                        time.perf_counter() - t0
                    self.metrics["index_merges"] += 1
            else:
                idx.build(merged, col)
                with self._lock:
                    self.metrics["index_rebuild_s"] += \
                        time.perf_counter() - t0
                    self.metrics["index_rebuilds"] += 1
            merged.indexes[col.name] = idx

    # ------------------------------------------------------------------- read
    def get(self, key: int) -> Optional[Dict[str, Any]]:
        best = None
        # memtables newest-first: active, then sealed youngest->oldest
        for m in (self.memtable, *reversed(self.sealed)):
            best = m.get(key)
            if best is not None:
                break
        if best is None:
            # newest-first: segments are appended in time order
            for seg in reversed(self.segments):
                if not seg.may_contain(key):
                    continue
                i = seg.get(key)
                if i is not None:
                    r = seg.row(i)
                    if best is None or r["_seqno"] > best["_seqno"]:
                        best = r
        if best is None or best["_tombstone"]:
            return None
        return best

    @property
    def n_rows(self) -> int:
        return sum(s.n_rows for s in self.segments) + self.memtable_rows

    @property
    def memtable_rows(self) -> int:
        """Rows buffered in RAM (active + sealed awaiting flush)."""
        return len(self.memtable) + sum(len(m) for m in self.sealed)

    def all_segments(self) -> List[seg_lib.Segment]:
        return list(self.segments)

    def memtable_arrays(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                       Dict[str, np.ndarray]]:
        """Columnar view over ALL RAM-resident rows (sealed memtables
        oldest-first, then the active one) — the read paths' single
        window onto unflushed data, cached per write epoch."""
        with self._lock:
            if self._mt_cache is None or \
                    self._mt_cache[0] != self._mt_epoch:
                parts = [m.scan_arrays()
                         for m in (*self.sealed, self.memtable)]
                self._mt_cache = (
                    self._mt_epoch,
                    mt.concat_memtable_arrays(parts, self.schema))
            return self._mt_cache[1]

    # visible-version resolution across segments (newest seqno per pk wins)
    def resolve_visible(self, per_segment_rows: Dict[int, np.ndarray]
                        ) -> Dict[int, np.ndarray]:
        """Given {seg_id: row_indices}, drop rows shadowed by newer versions
        of the same pk elsewhere (or by memtable / tombstones).  Delegates
        to the shared vectorized resolver in ``core.visibility``."""
        from repro_torch.core import visibility
        return visibility.visibility_index(self).resolve(per_segment_rows)
