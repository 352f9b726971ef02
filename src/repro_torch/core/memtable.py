"""Write buffer (memtable) — columnar append store, the skip-list analog.

Storage is *chunked columnar*: every ``put_batch`` appends whole numpy
arrays (one chunk per batch) instead of looping rows/columns in Python,
so the write critical path is O(#columns) array conversions per batch —
never O(rows).  ``scan_arrays`` concatenates the chunks once and memoizes
the result; point reads binary-search the chunk offsets.

The LSM store seals the memtable (hands it to the flush scheduler) once
``flush_rows`` / ``flush_bytes`` is reached; reads over the memtable are
brute-force — it is small and RAM-resident by construction, exactly like
RocksDB's write buffer.
"""
from __future__ import annotations

import bisect
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.types import Column, ColumnType, Schema, validate_batch

# fixed per-row overhead: pk (8) + seqno (8) + tombstone flag
_ROW_OVERHEAD = 17
# per-string object overhead on top of the payload
_STR_OVERHEAD = 16


def as_column_array(c: Column, values, n: Optional[int] = None
                    ) -> np.ndarray:
    """Canonical numpy representation of one column of a batch."""
    if c.ctype == ColumnType.VECTOR:
        arr = np.asarray(values, np.float32)
        return arr.reshape(len(arr), c.dim) if arr.size else \
            np.zeros((n or 0, c.dim), np.float32)
    if c.ctype == ColumnType.SPATIAL:
        arr = np.asarray(values, np.float32)
        return arr.reshape(len(arr), 2) if arr.size else \
            np.zeros((n or 0, 2), np.float32)
    if c.ctype == ColumnType.SCALAR:
        return np.asarray(values, np.float64)
    arr = np.asarray(values, object)           # TEXT / BLOB
    return arr


def _null_chunk(c: Column, n: int) -> np.ndarray:
    if c.ctype == ColumnType.VECTOR:
        return np.zeros((n, c.dim), np.float32)
    if c.ctype == ColumnType.SPATIAL:
        return np.zeros((n, 2), np.float32)
    if c.ctype == ColumnType.SCALAR:
        return np.zeros(n, np.float64)
    return np.full(n, "", object)


def _empty_columns(schema: Schema) -> Dict[str, np.ndarray]:
    return {c.name: _null_chunk(c, 0) for c in schema.columns}


def _var_chunk_bytes(arr: np.ndarray) -> int:
    """Actual payload size of one TEXT/BLOB chunk (by content, not a
    flat per-row constant — flush-by-bytes depends on this)."""
    return int(sum(len(v) if isinstance(v, (str, bytes)) else
                   len(str(v)) for v in arr)) + _STR_OVERHEAD * len(arr)


class MemTable:
    def __init__(self, schema: Schema):
        self.schema = schema
        self._pk_chunks: List[np.ndarray] = []
        self._seq_chunks: List[np.ndarray] = []
        self._tomb_chunks: List[np.ndarray] = []
        self._col_chunks: Dict[str, List[np.ndarray]] = \
            {c.name: [] for c in schema.columns}
        self._starts: List[int] = [0]      # chunk start offsets (+ total)
        # newest row index per key for O(1) point reads
        self._latest: Dict[int, int] = {}
        self._bytes = 0                    # fixed-width payload (eager)
        # TEXT/BLOB payloads are summed lazily in ``approx_bytes`` (the
        # O(rows) len() walk must never run on the write critical path)
        self._var_cols = [c.name for c in schema.columns
                          if c.ctype in (ColumnType.TEXT, ColumnType.BLOB)]
        self._var_bytes = 0
        self._var_counted: Dict[str, int] = {n: 0 for n in self._var_cols}
        # scan_arrays() memo — every read path materializes the same
        # columnar view; cleared on write (flush swaps the instance)
        self._scan_cache = None

    def __len__(self) -> int:
        return self._starts[-1]

    @property
    def approx_bytes(self) -> int:
        # catch up on variable-width chunks appended since the last call
        for name in self._var_cols:
            chunks = self._col_chunks[name]
            for ci in range(self._var_counted[name], len(chunks)):
                self._var_bytes += _var_chunk_bytes(chunks[ci])
            self._var_counted[name] = len(chunks)
        return self._bytes + self._var_bytes + _ROW_OVERHEAD * len(self)

    def put_batch(self, pks, batch: Dict[str, Any], seqno_start: int,
                  tombstone: bool = False) -> int:
        """Append a columnar batch as one chunk; returns the next unused
        seqno.  O(#columns) array appends — no per-row loop."""
        n = validate_batch(self.schema, batch) if not tombstone else len(pks)
        if n == 0:
            return seqno_start
        self._scan_cache = None
        pk = np.asarray(pks, np.int64)
        base = self._starts[-1]
        self._pk_chunks.append(pk)
        self._seq_chunks.append(
            np.arange(seqno_start, seqno_start + n, dtype=np.int64))
        self._tomb_chunks.append(np.full(n, tombstone, bool))
        for c in self.schema.columns:
            arr = _null_chunk(c, n) if tombstone else \
                as_column_array(c, batch[c.name], n)
            self._col_chunks[c.name].append(arr)
            if c.ctype not in (ColumnType.TEXT, ColumnType.BLOB):
                self._bytes += int(arr.nbytes)      # O(1), no row walk
        self._starts.append(base + n)
        # one C-level dict update: pk -> newest global row index
        self._latest.update(zip(pk.tolist(), range(base, base + n)))
        return seqno_start + n

    def _locate(self, i: int) -> Tuple[int, int]:
        """Global row index -> (chunk id, offset within chunk)."""
        ci = bisect.bisect_right(self._starts, i) - 1
        return ci, i - self._starts[ci]

    def get(self, key: int) -> Optional[Dict[str, Any]]:
        i = self._latest.get(int(key))
        if i is None:
            return None
        ci, off = self._locate(i)
        row = {"_pk": int(self._pk_chunks[ci][off]),
               "_seqno": int(self._seq_chunks[ci][off]),
               "_tombstone": bool(self._tomb_chunks[ci][off])}
        for name, chunks in self._col_chunks.items():
            row[name] = chunks[ci][off]
        return row

    def scan_arrays(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                   Dict[str, np.ndarray]]:
        """Materialize as columnar arrays (for flush or brute-force read):
        one concatenation per column.  Memoized until the next write;
        callers must not mutate."""
        if self._scan_cache is not None:
            return self._scan_cache
        if not self._pk_chunks:
            empty = (np.zeros(0, np.int64), np.zeros(0, np.int64),
                     np.zeros(0, bool), _empty_columns(self.schema))
            self._scan_cache = empty
            return empty
        pk = np.concatenate(self._pk_chunks)
        seqno = np.concatenate(self._seq_chunks)
        tomb = np.concatenate(self._tomb_chunks)
        cols = {name: np.concatenate(chunks)
                for name, chunks in self._col_chunks.items()}
        self._scan_cache = (pk, seqno, tomb, cols)
        return self._scan_cache


def concat_memtable_arrays(parts: List[Tuple[np.ndarray, np.ndarray,
                                             np.ndarray,
                                             Dict[str, np.ndarray]]],
                           schema: Schema):
    """Stack several memtables' scan_arrays into one logical view (sealed
    memtables awaiting flush + the active one, oldest first)."""
    parts = [p for p in parts if len(p[0])]
    if not parts:
        return (np.zeros(0, np.int64), np.zeros(0, np.int64),
                np.zeros(0, bool), _empty_columns(schema))
    if len(parts) == 1:
        return parts[0]
    pk = np.concatenate([p[0] for p in parts])
    seqno = np.concatenate([p[1] for p in parts])
    tomb = np.concatenate([p[2] for p in parts])
    cols = {c.name: np.concatenate([p[3][c.name] for p in parts])
            for c in schema.columns}
    return pk, seqno, tomb, cols
