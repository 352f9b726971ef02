"""Shared vectorized MVCC visibility resolution (newest seqno per pk).

One implementation serves every read path: the filter executor, the NN
candidate finisher, and NRA's streaming candidate check all resolve
visibility against the same ``VisibilityIndex``.  The resolver is
``np.lexsort``-based: concatenate (pk, seqno, tombstone) across all
segments plus the memtable, order by (pk asc, seqno desc), and the first
row of every pk group is the winning version.  A segment row is visible
iff it is its pk's winner and that winner is neither a tombstone nor a
memtable entry (memtable rows are served by the memtable-overlay
operator, never by segment scans).

The index is O(total rows) to build and is cached on the store, keyed by
(write seqno, segment ids) so any put/delete/flush/compaction
invalidates it.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Tuple

import numpy as np


def _store_lock(store):
    """The store's lock, or a no-op context for lock-less store stand-ins
    (unit-test doubles).  LSMStore always carries ``_lock`` (re-entrant),
    so flush-time callers already inside the publish window re-enter."""
    return getattr(store, "_lock", None) or contextlib.nullcontext()


def memtable_visible(pk: np.ndarray, tomb: np.ndarray) -> np.ndarray:
    """Bool mask over memtable rows: newest version per pk, tombstones out.

    Rows are append-ordered, so within a pk group the last occurrence is
    the newest (seqnos increase with position).
    """
    n = len(pk)
    if n == 0:
        return np.zeros(0, bool)
    pk = np.asarray(pk, np.int64)
    # stable sort by pk keeps append order inside each group
    order = np.argsort(pk, kind="stable")
    spk = pk[order]
    last = np.ones(n, bool)
    last[:-1] = spk[1:] != spk[:-1]
    keep = np.zeros(n, bool)
    keep[order[last]] = True
    return keep & ~np.asarray(tomb, bool)


class VisibilityIndex:
    """Global winner set: for every pk in the store, which (seg, row) —
    if any — is the visible version."""

    def __init__(self, store):
        parts_pk, parts_seq, parts_sid, parts_row, parts_tomb = \
            [], [], [], [], []
        for seg in store.segments:
            if seg.n_rows == 0:
                continue
            parts_pk.append(np.asarray(seg.pk, np.int64))
            parts_seq.append(np.asarray(seg.seqno, np.int64))
            parts_sid.append(np.full(seg.n_rows, seg.seg_id, np.int64))
            parts_row.append(np.arange(seg.n_rows, dtype=np.int64))
            parts_tomb.append(np.asarray(seg.tombstone, bool))
        mt_pk, mt_seq, mt_tomb, _ = store.memtable_arrays()
        if len(mt_pk):
            parts_pk.append(mt_pk)
            parts_seq.append(mt_seq)
            parts_sid.append(np.full(len(mt_pk), -1, np.int64))
            parts_row.append(np.arange(len(mt_pk), dtype=np.int64))
            parts_tomb.append(mt_tomb)
        if not parts_pk:
            self._winners = np.zeros(0, np.int64)
            self._win_pk = np.zeros(0, np.int64)
            self._win_sid = np.zeros(0, np.int64)
            self._win_row = np.zeros(0, np.int64)
            return
        pk = np.concatenate(parts_pk)
        seqno = np.concatenate(parts_seq)
        sid = np.concatenate(parts_sid)
        row = np.concatenate(parts_row)
        tomb = np.concatenate(parts_tomb)
        # (pk asc, seqno desc): first row of each pk group is the winner
        order = np.lexsort((-seqno, pk))
        pk, sid, row, tomb = pk[order], sid[order], row[order], tomb[order]
        first = np.ones(len(pk), bool)
        first[1:] = pk[1:] != pk[:-1]
        # full winner set (pk-sorted), memtable winners included: the
        # point-lookup side (lookup_pks) must see memtable versions
        win = first & ~tomb
        self._win_pk = pk[win]
        self._win_sid = sid[win]
        self._win_row = row[win]
        seg_win = win & (sid >= 0)
        self._winners = np.sort(_encode(sid[seg_win], row[seg_win]))

    def extend_on_flush(self, seg, n_flushed: int) -> None:
        """Incremental update when the oldest ``n_flushed`` memtable rows
        become segment ``seg``: a flush moves versions without changing
        any pk's winner, so the winner set is *remapped* instead of
        rebuilt — memtable winners in the flushed prefix point at their
        new segment rows, remaining memtable winners shift down, and the
        new segment winners merge into the sorted membership array.
        O(winners) instead of O(total rows · log)."""
        inv = np.empty(n_flushed, np.int64)
        inv[seg.sort_order] = np.arange(n_flushed, dtype=np.int64)
        mt = self._win_sid == -1
        flushed = mt & (self._win_row < n_flushed)
        later = mt & ~flushed
        new_rows = inv[self._win_row[flushed]]
        self._win_sid[flushed] = seg.seg_id
        self._win_row[flushed] = new_rows
        self._win_row[later] -= n_flushed
        if len(new_rows):
            enc = _encode(np.full(len(new_rows), seg.seg_id, np.int64),
                          new_rows)
            self._winners = np.sort(
                np.concatenate([self._winners, enc]))

    def visible_mask(self, sids: np.ndarray, rows: np.ndarray) -> np.ndarray:
        """Vectorized membership test: is each (seg_id, row) the visible
        version of its pk?"""
        if len(self._winners) == 0:
            return np.zeros(len(sids), bool)
        enc = _encode(np.asarray(sids, np.int64), np.asarray(rows, np.int64))
        pos = np.searchsorted(self._winners, enc)
        pos = np.minimum(pos, len(self._winners) - 1)
        return self._winners[pos] == enc

    def lookup_pks(self, pks: np.ndarray
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Vectorized point lookup: pk -> its winning (sid, row).

        Returns (sids, rows, found); ``sid == -1`` means the winner lives
        in the memtable, ``found == False`` means the pk has no visible
        version (absent or tombstoned).
        """
        pks = np.asarray(pks, np.int64)
        if len(self._win_pk) == 0:
            z = np.zeros(len(pks), np.int64)
            return z, z, np.zeros(len(pks), bool)
        pos = np.minimum(np.searchsorted(self._win_pk, pks),
                         len(self._win_pk) - 1)
        found = self._win_pk[pos] == pks
        return self._win_sid[pos], self._win_row[pos], found

    def resolve(self, per_segment_rows: Dict[int, np.ndarray]
                ) -> Dict[int, np.ndarray]:
        """{seg_id: row_indices} -> same shape, shadowed rows dropped."""
        out: Dict[int, np.ndarray] = {}
        for sid, rows in per_segment_rows.items():
            rows = np.asarray(rows, np.int64)
            keep = self.visible_mask(np.full(len(rows), sid, np.int64), rows)
            kept = np.sort(rows[keep])
            if len(kept):
                out[sid] = kept
        return out


def _encode(sids: np.ndarray, rows: np.ndarray) -> np.ndarray:
    return (sids << 32) | rows


def visibility_index(store) -> VisibilityIndex:
    """Cached VisibilityIndex for the store's current write state.

    Key computation, index build, and cache publish all happen under the
    store lock: the build walks ``store.segments`` and the memtable, and
    a background flush republishing mid-walk would hand back an index
    keyed for a state it was not built from."""
    with _store_lock(store):
        key = (store._seqno, tuple(s.seg_id for s in store.segments))
        cached = getattr(store, "_vis_cache", None)
        if cached is None or cached[0] != key:
            cached = (key, VisibilityIndex(store))
            store._vis_cache = cached
        return cached[1]


def extend_cache_on_flush(store, pre_key, seg, n_flushed: int) -> bool:
    """Flush-time cache maintenance: if the store's cached index matches
    the pre-flush state, remap it in place (``extend_on_flush``) and
    re-key it for the post-flush state instead of discarding it.  Returns
    whether the incremental path was taken."""
    with _store_lock(store):
        cached = getattr(store, "_vis_cache", None)
        if cached is None or cached[0] != pre_key or n_flushed == 0:
            return False
        vis = cached[1]
        vis.extend_on_flush(seg, n_flushed)
        new_key = (store._seqno, tuple(s.seg_id for s in store.segments))
        store._vis_cache = (new_key, vis)
        return True
