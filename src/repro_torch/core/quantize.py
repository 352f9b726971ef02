"""Quantized residence tier: PQ codes stored alongside every vector rank
column (paper §4's IVF+PQ pairing, promoted from index detail to a
storage-level property).

At flush time each vector column is PQ-encoded (m subquantizers, uint8
codes) next to the full-precision column; the fused quantized scan
(``kernels/quantized_scan.py``) streams the code matrix — m bytes/row
instead of 4*d — for candidate generation, then the survivors are
re-ranked exactly against the fp32 column.

Codebook lifecycle mirrors ``IVFIndex.merge``'s donation rule:

  * the store trains codebooks ONCE per column (first flush) and reuses
    them for every later flush, so cross-segment packing sees a single
    shared book (``book_id``) and LUTs are computed once per query;
  * at compaction the largest part donates its codebooks; donor rows keep
    their codes verbatim through the compaction row maps and only rows
    from foreign-book parts are re-encoded (one assignment pass — never a
    k-means retrain).

Everything here is plain numpy on purpose: flush/compaction run on the
ingest path and must not touch the kernel-dispatch accounting
(``kernels.ops.stats_snapshot``) that read-path tests and benchmarks
meter.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import List, Optional, Sequence

import numpy as np

DEFAULT_PQ_M = 8
# training is sampled + few-iter: codebooks only steer candidate
# generation, the exact re-rank restores full precision
TRAIN_SAMPLE = 1024
TRAIN_ITERS = 4
# pad value for unused codeword slots: large enough never to win an
# assignment, small enough that its squared LUT entry stays finite in
# fp32 (1e15**2 = 1e30 << fp32 max) — inf LUT entries would turn the
# one-hot matmul's 0*inf lanes into NaN
PAD_CENTROID = np.float32(1e15)

_book_ids = itertools.count(1)


def fresh_book_id() -> int:
    """Allocate a new shared-codebook identity (recovery re-keys loaded
    segments' codes with one of these per column, since saved book ids
    from a dead process mean nothing here)."""
    return next(_book_ids)


@dataclasses.dataclass
class QuantizedColumn:
    """PQ residence for one segment column, in segment row order."""
    codes: np.ndarray       # (n, m) uint8
    codebooks: np.ndarray   # (m, 256, dsub) fp32, padded with PAD_CENTROID
    book_id: int            # shared-codebook identity (packability gate)

    @property
    def m(self) -> int:
        return int(self.codes.shape[1])

    def decode(self) -> np.ndarray:
        """Reconstruct (n, d) fp32 from codes — test/debug helper."""
        n, m = self.codes.shape
        dsub = self.codebooks.shape[2]
        out = np.empty((n, m * dsub), np.float32)
        for j in range(m):
            out[:, j * dsub:(j + 1) * dsub] = \
                self.codebooks[j][self.codes[:, j].astype(np.int64)]
        return out


def subquantizers(d: int, m: int = DEFAULT_PQ_M) -> int:
    """Largest m' <= m with d % m' == 0 (same halving rule as IVF PQ)."""
    m = min(m, d)
    while m > 1 and d % m:
        m //= 2
    return max(1, m)


def _kmeans256(x: np.ndarray, seed: int) -> np.ndarray:
    """(256, dsub) codebook for one subspace: sampled gemm k-means,
    unused slots padded with PAD_CENTROID."""
    n, dsub = x.shape
    rng = np.random.default_rng(seed)
    k = min(256, n)
    cents = x[rng.choice(n, size=k, replace=False)].astype(np.float32)
    for _ in range(TRAIN_ITERS):
        assign = _assign(x, cents)
        for j in range(k):
            sel = assign == j
            if sel.any():
                cents[j] = x[sel].mean(axis=0)
    if k < 256:
        cents = np.pad(cents, ((0, 256 - k), (0, 0)),
                       constant_values=PAD_CENTROID)
    return cents


def _assign(x: np.ndarray, cents: np.ndarray) -> np.ndarray:
    """Nearest-centroid assignment via the expansion form, chunked so the
    (chunk, k) distance matrix stays small."""
    cn = (cents.astype(np.float32) ** 2).sum(axis=1)[None, :]
    out = np.empty(len(x), np.int64)
    for lo in range(0, len(x), 16384):
        c = np.asarray(x[lo:lo + 16384], np.float32)
        d2 = (c * c).sum(axis=1)[:, None] - 2.0 * (c @ cents.T) + cn
        out[lo:lo + 16384] = np.argmin(d2, axis=1)
    return out


def train_codebooks(vecs: np.ndarray, m: int, seed: int = 0) -> np.ndarray:
    """(m, 256, dsub) codebooks from a sample of the first flush."""
    vecs = np.asarray(vecs, np.float32)
    n, d = vecs.shape
    dsub = d // m
    if n > TRAIN_SAMPLE:
        rng = np.random.default_rng(seed)
        vecs = vecs[rng.choice(n, size=TRAIN_SAMPLE, replace=False)]
    books = np.empty((m, 256, dsub), np.float32)
    for j in range(m):
        books[j] = _kmeans256(vecs[:, j * dsub:(j + 1) * dsub], seed + j)
    return books


def encode(vecs: np.ndarray, codebooks: np.ndarray) -> np.ndarray:
    """(n, m) uint8 codes: per-subspace nearest codeword."""
    vecs = np.asarray(vecs, np.float32)
    n = len(vecs)
    m, _, dsub = codebooks.shape
    codes = np.empty((n, m), np.uint8)
    for j in range(m):
        codes[:, j] = _assign(vecs[:, j * dsub:(j + 1) * dsub],
                              codebooks[j])
    return codes


def quantize_column(vecs: np.ndarray,
                    codebooks: Optional[np.ndarray] = None,
                    book_id: Optional[int] = None,
                    m: int = DEFAULT_PQ_M,
                    seed: int = 0) -> QuantizedColumn:
    """Encode one segment column; trains fresh codebooks (new book_id)
    only when none are supplied."""
    vecs = np.asarray(vecs, np.float32)
    if codebooks is None:
        codebooks = train_codebooks(vecs, subquantizers(vecs.shape[1], m),
                                    seed=seed)
        book_id = next(_book_ids)
    assert book_id is not None
    return QuantizedColumn(encode(vecs, codebooks), codebooks, book_id)


def merge_quantized(parts: Sequence[QuantizedColumn],
                    merged_vecs: np.ndarray,
                    row_maps: List[np.ndarray]) -> QuantizedColumn:
    """Compaction merge with codebook donation (no retrain, ever).

    The largest part donates its codebooks; every part sharing the
    donor's book copies its codes verbatim through the compaction row
    maps, and only rows from foreign-book parts get a single re-encode
    assignment pass against the donated books.
    """
    donor_i = max(range(len(parts)), key=lambda i: len(parts[i].codes))
    donor = parts[donor_i]
    merged_vecs = np.asarray(merged_vecs, np.float32)
    n_out = len(merged_vecs)
    codes = np.zeros((n_out, donor.m), np.uint8)
    filled = np.zeros(n_out, bool)
    for part, rmap in zip(parts, row_maps):
        if part.book_id != donor.book_id or part.m != donor.m:
            continue
        live = rmap >= 0
        codes[rmap[live]] = part.codes[live]
        filled[rmap[live]] = True
    rest = ~filled
    if rest.any():
        codes[rest] = encode(merged_vecs[rest], donor.codebooks)
    return QuantizedColumn(codes, donor.codebooks, donor.book_id)
