"""Unified secondary index interface (paper §4, Challenge #1).

Every modality index — vector IVF, spatial Z-order, text inverted, scalar
btree — implements the same contract:

  build(segment, column)            index construction at SST-build time
  bitmap(segment, predicate)        -> bool mask over segment rows
  iterator(segment, query)          -> SortedAccess yielding (dist, rows)
                                       blocks in ascending distance order
  stats()                           -> selectivity inputs for the optimizer

The standardized sorted ``Next()`` access is what enables the NRA
aggregation across modalities (paper Algorithm 1): ARCADE's key interface
unification.
"""
from __future__ import annotations

import abc
import heapq
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np


class SortedAccess(abc.ABC):
    """Sorted access stream over one segment: blocks of (distance, row_id)
    pairs in globally ascending distance order.

    Block adaptation: ``next_block`` yields a *block* at a time (vectorized
    bound updates in the NRA loop) rather than one row; bound semantics are
    preserved because every yielded distance is >= all previously yielded
    distances (see DESIGN.md §8.1).
    """

    @abc.abstractmethod
    def next_block(self) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """Returns (distances ascending, row_ids) or None when exhausted."""

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        while True:
            blk = self.next_block()
            if blk is None:
                return
            yield blk


class ExactSortedAccess(SortedAccess):
    """Sorted access over fully-materialized (dist, row) arrays."""

    def __init__(self, dists: np.ndarray, rows: np.ndarray,
                 block: int = 128):
        # (score, row) comparator: deterministic tie order for NRA's
        # sorted-access streams regardless of producer ordering
        order = np.lexsort((np.asarray(rows), np.asarray(dists)))
        self._d = np.asarray(dists)[order]
        self._r = np.asarray(rows)[order]
        self._i = 0
        self._block = block

    def next_block(self):
        if self._i >= len(self._d):
            return None
        j = min(self._i + self._block, len(self._d))
        out = (self._d[self._i:j], self._r[self._i:j])
        self._i = j
        return out


class MergedSortedAccess(SortedAccess):
    """Heap-merge of per-segment sorted streams into one global stream —
    the paper's 'top-level merging iterator using a priority queue'.
    Yields (dists, global_keys) where keys are (seg_id, row) encoded by
    ``key_fn``.

    The merged stream must be *globally* non-decreasing (NRA's bound
    bookkeeping relies on it), so when a block is popped only the prefix
    not exceeding the next-smallest stream head is emitted; the remainder
    is pushed back keyed by its new first element.
    """

    def __init__(self, streams: List[Tuple[int, SortedAccess]],
                 key_fn=None):
        self._heap: List[Tuple[float, int, int, np.ndarray, np.ndarray]] = []
        self._streams = dict(streams)
        self._key_fn = key_fn or (lambda sid, rows: rows)
        self._counter = 0
        for sid, st in streams:
            self._pull(sid)

    def _pull(self, sid: int):
        blk = self._streams[sid].next_block()
        if blk is not None:
            d, r = blk
            self._push_buf(sid, d, r)

    def _push_buf(self, sid: int, d: np.ndarray, r: np.ndarray):
        if len(d):
            self._counter += 1
            heapq.heappush(self._heap,
                           (float(d[0]), self._counter, sid, d, r))

    def next_block(self):
        if not self._heap:
            return None
        _, _, sid, d, r = heapq.heappop(self._heap)
        bound = self._heap[0][0] if self._heap else np.inf
        cut = int(np.searchsorted(d, bound, side="right"))
        cut = max(cut, 1)                  # d[0] <= bound by heap order
        rest_d, rest_r = d[cut:], r[cut:]
        if len(rest_d):
            self._push_buf(sid, rest_d, rest_r)
        else:
            self._pull(sid)
        return d[:cut], self._key_fn(sid, r[:cut])


def merge_sorted_runs(vals_list: List[np.ndarray],
                      rows_list: List[np.ndarray]
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Vectorized k-way merge of pre-sorted (value, row) runs.

    Each run is merged in via searchsorted rank arithmetic — the final
    position of ``a[i]`` is ``i + #{b < a[i]}`` — which is O(n log m)
    with no Python-level per-element loop (the sorted-run analog of the
    LSM merge itself; used by the mergeable scalar index).
    """
    pairs = [(v, r) for v, r in zip(vals_list, rows_list) if len(v)]
    if not pairs:
        return np.zeros(0, np.float64), np.zeros(0, np.int64)
    av, ar = pairs[0]
    for bv, br in pairs[1:]:
        pa = np.searchsorted(bv, av, side="left") + np.arange(len(av))
        pb = np.searchsorted(av, bv, side="right") + np.arange(len(bv))
        ov = np.empty(len(av) + len(bv), av.dtype)
        orr = np.empty(len(ar) + len(br), ar.dtype)
        ov[pa], ov[pb] = av, bv
        orr[pa], orr[pb] = ar, br
        av, ar = ov, orr
    return av, ar


class SecondaryIndex(abc.ABC):
    kind: str = "abstract"
    # where the index's kernels (IVF build/probe distances, the spatial
    # bitmap) run; the owning store sets its own device on every index
    device = "cuda"

    @abc.abstractmethod
    def build(self, segment, column) -> None:
        ...

    def merge(self, parts: List["SecondaryIndex"], merged_seg, column,
              row_maps: List[np.ndarray]) -> None:
        """Compaction-aware construction (paper §4): populate this index
        for ``merged_seg`` from the source segments' already-built
        indexes instead of rebuilding from raw columns.

        ``parts`` are the source indexes (one per merged segment, same
        order as the merge) and ``row_maps[i]`` maps source segment i's
        row ids to merged rows (-1 = dropped by the merge).  The default
        falls back to a fresh ``build`` — subclasses override with a
        cheaper structural merge (posting-list remap, sorted-run merge,
        Z-order re-sort, centroid reuse).
        """
        self.build(merged_seg, column)

    # persistence -----------------------------------------------------------
    def to_arrays(self) -> Dict[str, np.ndarray]:
        """Serialize the *built* state to named numpy arrays — the
        segment file's pickle-free on-disk contract (core/segment.py
        stores them under ``idx.<column>.<key>``). Hyperparameters
        (n_probe, R, ...) are NOT persisted: they are serving policy and
        come from the index factory at load time."""
        raise NotImplementedError(f"{self.kind} is not persistable")

    def from_arrays(self, arrays: Dict[str, np.ndarray],
                    segment, column) -> None:
        """Restore built state from ``to_arrays`` output onto a
        factory-fresh instance. ``segment`` supplies the raw columns
        for indexes that keep references into them (the graph's vecs)."""
        raise NotImplementedError(f"{self.kind} is not persistable")

    def bitmap(self, segment, predicate) -> np.ndarray:
        raise NotImplementedError(f"{self.kind} has no bitmap access")

    def iterator(self, segment, query) -> SortedAccess:
        raise NotImplementedError(f"{self.kind} has no sorted access")

    # optimizer hooks --------------------------------------------------------
    def selectivity(self, segment, predicate) -> float:
        """Estimated fraction of rows passing ``predicate``."""
        return 1.0

    def probe_cost_blocks(self, segment, predicate) -> float:
        """Estimated #blocks touched to answer ``predicate`` via this index."""
        return segment.n_blocks
