"""Hash-partitioned write/read routing across N independent LSM shards.

``ShardRouter`` is the scale-out data plane's store surface: it owns N
``LSMStore`` shards and presents the same columnar API (`put`/`delete`/
`get`/`flush`/`drain`/`on_delta`, aggregated `metrics` and row counts),
so the facade's ``Table`` swaps it in transparently.  Rows are routed by
a SplitMix64 hash of the pk — every version of a pk (puts, updates,
tombstones) lands on the same shard, which makes per-shard MVCC
visibility resolution globally correct and keeps shard pk sets disjoint
(the property the exact cross-shard top-k merge relies on).

Routing is fully vectorized: one hash + stable argsort per batch, then
sliced per-shard sub-batches in original relative order (so per-shard
seqno order preserves the caller's write order and the ``unique_pks``
fast path survives monotonic ingest).

Every shard runs its device work on the router's ``device``: the card
unless the caller asks for the CPU.  Durability (``LSMConfig.path``,
``snapshot``, fault arming and acknowledgement frontiers) is not ported
yet and raises.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import memtable as mt
from repro_torch.core.lsm import NO_DURABILITY, LSMConfig, LSMStore
from repro_torch.core.types import Schema
from repro_torch.kernels.ops import Device, resolve_device

_MIX1 = np.uint64(0xBF58476D1CE4E5B9)
_MIX2 = np.uint64(0x94D049BB133111EB)


def hash_pks(pks: Sequence[int]) -> np.ndarray:
    """SplitMix64 finalizer, vectorized over an int64 pk array.

    Decorrelates the key pattern from the shard choice so partitioning
    stays balanced for sequential, strided, or clustered pks alike; the
    wrap-around uint64 arithmetic is numpy's native behavior."""
    x = np.asarray(pks, np.int64).astype(np.uint64)
    x = (x ^ (x >> np.uint64(30))) * _MIX1
    x = (x ^ (x >> np.uint64(27))) * _MIX2
    return x ^ (x >> np.uint64(31))


class ShardRouter:
    """N independent ``LSMStore`` shards behind one store-shaped surface.

    Each shard runs the complete single-store write path — its own
    memtable, flush scheduler, size-tiered compaction and per-segment
    secondary indexes — so ingest work parallelizes shard-wise without
    any cross-shard coordination.  Reads go through ``ShardedExecutor``
    (core/shards/executor.py), which fans queries out and merges."""

    def __init__(self, schema: Schema, cfg: Optional[LSMConfig] = None,
                 n_shards: int = 2,
                 index_factory: Optional[Callable] = None,
                 device: Device = "cuda"):
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        self.schema = schema
        self.cfg = cfg or LSMConfig()
        if self.cfg.path:
            raise NotImplementedError(f"LSMConfig(path=...): "
                                      f"{NO_DURABILITY}")
        self.n_shards = int(n_shards)
        self.device = resolve_device(device)
        self.shards: List[LSMStore] = [
            LSMStore(schema, self.cfg, index_factory, device=self.device)
            for _ in range(self.n_shards)]
        self._cols = {c.name: c for c in schema.columns}

    # ------------------------------------------------------------ routing
    def shard_of(self, pks: Sequence[int]) -> np.ndarray:
        """Owning shard id per pk (deterministic, version-stable)."""
        return (hash_pks(pks) % np.uint64(self.n_shards)).astype(np.int64)

    def _split(self, pks: np.ndarray
               ) -> Iterator[Tuple[int, np.ndarray]]:
        """Yield ``(shard_id, positions)`` for each non-empty shard's
        slice of the batch; positions preserve original relative order
        (stable argsort), so per-shard write order mirrors the caller's."""
        sid = self.shard_of(pks)
        order = np.argsort(sid, kind="stable")
        bounds = np.searchsorted(sid[order], np.arange(self.n_shards + 1))
        for s in range(self.n_shards):
            lo, hi = int(bounds[s]), int(bounds[s + 1])
            if lo < hi:
                yield s, order[lo:hi]

    # -------------------------------------------------------------- write
    def put(self, pks: Sequence[int], batch: Dict[str, Any]) -> None:
        """Partition one columnar batch by pk hash and forward each
        shard's sub-batch whole — O(#columns) canonical conversions plus
        one fancy-index slice per shard, never a per-row loop."""
        pks = np.asarray(pks, np.int64)
        if len(pks) == 0:
            return
        if self.n_shards == 1:
            self.shards[0].put(pks, batch)
            return
        cols = {name: mt.as_column_array(self._cols[name], vals, len(pks))
                if name in self._cols else np.asarray(vals)
                for name, vals in batch.items()}
        for s, idx in self._split(pks):
            self.shards[s].put(pks[idx],
                               {name: arr[idx] for name, arr in cols.items()})

    insert = put

    def delete(self, pks: Sequence[int]) -> None:
        """Tombstones go to each pk's owning shard only; a shard that
        never saw the pk is never touched (its ``unique_pks`` fast path
        survives)."""
        pks = np.asarray(pks, np.int64)
        if len(pks) == 0:
            return
        for s, idx in self._split(pks):
            self.shards[s].delete(pks[idx])

    def on_delta(self, fn: Callable) -> None:
        """Register a write hook on EVERY shard; callers receive the
        per-shard sub-batches (columnar, same signature as the
        single-store hook) — the continuous engine aggregates them."""
        for sh in self.shards:
            sh.on_delta(fn)

    # ------------------------------------------------- flush / compaction
    def seal(self) -> bool:
        return any([sh.seal() for sh in self.shards])

    def flush(self) -> List:
        """Seal + drain every shard; returns the flushed segments."""
        out = []
        for sh in self.shards:
            seg = sh.flush()
            if seg is not None:
                out.append(seg)
        return out

    def drain(self) -> List:
        """Deterministically finish every shard's queued flush/compaction
        work (pipelined configs); returns all segments flushed."""
        out = []
        for sh in self.shards:
            out.extend(sh.drain())
        return out

    # --------------------------------------------------------- durability
    def set_faults(self, faults, shard: int = 0) -> None:
        raise NotImplementedError(f"set_faults: {NO_DURABILITY}")

    def durable_seqnos(self) -> List[int]:
        raise NotImplementedError(f"durable_seqnos: {NO_DURABILITY}")

    def close(self) -> None:
        """Close every shard (idempotent): stop background workers."""
        for sh in self.shards:
            sh.close()

    def snapshot(self, path: str) -> None:
        raise NotImplementedError(f"snapshot: {NO_DURABILITY}")

    # --------------------------------------------------------------- read
    def get(self, key: int) -> Optional[Dict[str, Any]]:
        return self.shards[int(self.shard_of([key])[0])].get(int(key))

    def all_segments(self) -> List:
        return [s for sh in self.shards for s in sh.segments]

    @property
    def segments(self) -> List:
        """Merged per-shard segment lists (stats / EXPLAIN; execution
        always iterates each shard's own list)."""
        return self.all_segments()

    @property
    def n_rows(self) -> int:
        return sum(sh.n_rows for sh in self.shards)

    @property
    def memtable_rows(self) -> int:
        return sum(sh.memtable_rows for sh in self.shards)

    @property
    def unique_pks(self) -> bool:
        """Global uniqueness: shards hold disjoint pk sets by routing, so
        every-shard-unique implies globally unique."""
        return all(sh.unique_pks for sh in self.shards)

    @property
    def metrics(self) -> Dict[str, float]:
        """Element-wise sum of the per-shard metrics dicts."""
        out: Dict[str, float] = {}
        for sh in self.shards:
            for key, val in sh.metrics.items():
                out[key] = out.get(key, 0) + val
        return out

    def shard_rows(self) -> List[int]:
        """Per-shard row counts (balance diagnostics / benchmarks)."""
        return [sh.n_rows for sh in self.shards]
