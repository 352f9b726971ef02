"""Per-segment vector IVF / PQ-IVF index with block-level access (paper §4).

Structure mirrors Figure 2:
  level 1 — index metadata: centroid table (n_centroids, dim) +
            centroid -> posting-list block ranges;
  level 2 — posting-list blocks: (vector, row-id) pairs grouped by
            centroid, padded to BLOCK_ROWS multiples (the read unit).

Query path (3 steps, per the paper): load centroid metadata -> score
centroids (distance kernel) -> read only the n_probe nearest centroids'
posting blocks -> exact distances (ivf_scan kernel) -> top-k. Only the
selected blocks are touched: that is the block-granular I/O claim vs
fully-memory-resident per-segment indexes (SingleStore-V).

The PQ variant (``IndexKind.PQIVF``) stores uint8 codes; distances via
ADC (the pq_adc kernel), with exact re-ranking of the top candidates.

Every distance runs on the index's ``device`` (set by the owning store).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np

from repro_torch.core.index.base import SecondaryIndex, SortedAccess
from repro_torch.core.types import BLOCK_ROWS
from repro_torch.kernels import ops as kops


def kmeans(x: np.ndarray, k: int, iters: int = 8, seed: int = 0,
           device="cuda") -> np.ndarray:
    """Lightweight k-means for centroid tables (float32, L2)."""
    n = len(x)
    rng = np.random.default_rng(seed)
    k = min(k, n)
    cents = x[rng.choice(n, size=k, replace=False)].astype(np.float32)
    for _ in range(iters):
        assign = kops.assign_nearest(x, cents, device=device)
        for j in range(k):
            m = assign == j
            if m.any():
                cents[j] = x[m].mean(axis=0)
    return cents


class IVFIndex(SecondaryIndex):
    kind = "ivf"

    def __init__(self, n_probe: int = 4, use_pq: bool = False,
                 pq_m: int = 8, refine: int = 4):
        self.n_probe = n_probe
        self.use_pq = use_pq
        self.pq_m = pq_m
        self.refine = refine            # PQ: exact-rerank factor (x k)
        # built state
        self.centroids: Optional[np.ndarray] = None
        self.post_rows: Optional[np.ndarray] = None     # row ids, grouped
        self.post_vecs: Optional[np.ndarray] = None     # vectors, grouped
        self.post_offsets: Optional[np.ndarray] = None  # centroid -> range
        self.codes: Optional[np.ndarray] = None         # PQ codes (n, m)
        self.codebooks: Optional[np.ndarray] = None     # (m, 256, dsub)
        self.blocks_total = 0

    # ------------------------------------------------------------- build
    def build(self, segment, column) -> None:
        vecs = np.asarray(segment.columns[column.name], np.float32)
        n = len(vecs)
        if n == 0:
            self.centroids = np.zeros((1, column.dim), np.float32)
            self.post_rows = np.zeros((0,), np.int64)
            self.post_vecs = np.zeros((0, column.dim), np.float32)
            self.post_offsets = np.zeros((2,), np.int64)
            return
        k = max(1, int(math.sqrt(n)))
        self.centroids = kmeans(vecs, k, device=self.device)
        self._group(vecs, self._assign(vecs))
        if self.use_pq:
            self._build_pq(vecs)

    def _assign(self, vecs: np.ndarray) -> np.ndarray:
        return kops.assign_nearest(vecs, self.centroids, device=self.device)

    def _l2(self, q: np.ndarray, x: np.ndarray) -> np.ndarray:
        """Squared distances of one query to ``x`` on the index's device."""
        return kops.l2_distances(q[None, :], x, device=self.device)[0]

    def _group(self, vecs: np.ndarray, assign: np.ndarray) -> None:
        """Group vectors into posting lists by centroid assignment and
        compute the per-centroid radii (triangle-inequality lower bound
        d(q, v) >= d(q, c) - radius(c) for sorted NRA-exact access) — all
        vectorized, no per-centroid kernel loop."""
        n = len(vecs)
        order = np.argsort(assign, kind="stable")
        self.post_rows = order.astype(np.int64)
        self.post_vecs = vecs[order]
        counts = np.bincount(assign, minlength=len(self.centroids))
        self.post_offsets = np.zeros(len(self.centroids) + 1, np.int64)
        np.cumsum(counts, out=self.post_offsets[1:])
        self.blocks_total = (n + BLOCK_ROWS - 1) // BLOCK_ROWS
        diff = self.post_vecs - self.centroids[assign[order]]
        d = np.sqrt(np.maximum((diff * diff).sum(axis=1), 0.0))
        self.radii = np.zeros(len(self.centroids), np.float32)
        nonempty = counts > 0
        if nonempty.any():
            starts = self.post_offsets[:-1][nonempty]
            self.radii[nonempty] = np.maximum.reduceat(d, starts)

    def merge(self, parts, merged_seg, column, row_maps) -> None:
        """Compaction-aware merge (paper §4): reuse the parts' centroid
        tables (their union) instead of re-running k-means, and reassign
        only the surviving rows in one vectorized ``assign_nearest`` —
        index maintenance cost at compaction is a single assignment pass,
        not a full rebuild."""
        vecs = np.asarray(merged_seg.columns[column.name], np.float32)
        n = len(vecs)
        if n == 0:
            self.centroids = np.zeros((1, column.dim), np.float32)
            self.post_rows = np.zeros((0,), np.int64)
            self.post_vecs = np.zeros((0, column.dim), np.float32)
            self.post_offsets = np.zeros((2,), np.int64)
            self.radii = np.zeros(1, np.float32)
            return
        usable = [p for p in parts
                  if getattr(p, "centroids", None) is not None
                  and len(p.centroids)]
        if not usable:
            self.build(merged_seg, column)
            return
        # keep the centroid table at the rebuild-equivalent size so the
        # n_probe/#lists ratio (and with it recall) is unchanged: each
        # part contributes its highest-occupancy centroids, proportional
        # to its share of the surviving rows
        target_k = max(1, int(math.sqrt(n)))
        total = sum(len(p.post_rows) for p in usable) or 1
        kept_c, kept_n = [], []
        for p in usable:
            quota = max(1, round(target_k * len(p.post_rows) / total))
            counts = np.diff(p.post_offsets)
            top = np.sort(np.argsort(counts)[::-1][:quota])
            kept_c.append(p.centroids[top])
            kept_n.append(counts[top])
        cents = np.concatenate(kept_c).astype(np.float32)
        if len(cents) > target_k:
            # quotas round up, so trim the lowest-occupancy centroids
            # globally — never a positional tail (that would erase one
            # part's whole contribution)
            occ = np.concatenate(kept_n)
            cents = cents[np.sort(np.argsort(occ)[::-1][:target_k])]
        self.centroids = cents
        self._group(vecs, self._assign(vecs))
        if self.use_pq:
            donor = max((p for p in parts
                         if getattr(p, "codebooks", None) is not None),
                        key=lambda p: len(p.post_rows), default=None)
            if donor is None:
                self._build_pq(vecs)
            else:
                self._reencode_pq(vecs, donor.codebooks)

    def _reencode_pq(self, vecs: np.ndarray, codebooks: np.ndarray) -> None:
        """PQ codebook reuse: keep a donor part's codebooks and re-encode
        the merged vectors (one assignment per subspace, no k-means)."""
        m, _, dsub = codebooks.shape
        self.pq_m = m
        self.codebooks = codebooks
        codes = [kops.assign_nearest(vecs[:, j * dsub:(j + 1) * dsub],
                                     codebooks[j], device=self.device)
                 for j in range(m)]
        codes = np.stack(codes, axis=1).astype(np.uint8)
        self.codes = codes[self.post_rows]

    def _build_pq(self, vecs: np.ndarray) -> None:
        n, d = vecs.shape
        m = self.pq_m
        while d % m:
            m //= 2
        self.pq_m = m
        dsub = d // m
        n_codes = min(256, max(2, n))
        books, codes = [], []
        for j in range(m):
            sub = vecs[:, j * dsub:(j + 1) * dsub]
            cb = kmeans(sub, n_codes, seed=j, device=self.device)
            if len(cb) < 256:
                cb = np.pad(cb, ((0, 256 - len(cb)), (0, 0)),
                            constant_values=1e30)
            books.append(cb)
            codes.append(kops.assign_nearest(sub, cb[:n_codes],
                                             device=self.device))
        self.codebooks = np.stack(books).astype(np.float32)   # (m,256,dsub)
        codes = np.stack(codes, axis=1).astype(np.uint8)       # (n, m)
        self.codes = codes[self.post_rows]                     # grouped order

    # ------------------------------------------------------- persistence
    def to_arrays(self):
        out = {"centroids": np.asarray(self.centroids, np.float32),
               "post_rows": np.asarray(self.post_rows, np.int64),
               "post_vecs": np.asarray(self.post_vecs, np.float32),
               "post_offsets": np.asarray(self.post_offsets, np.int64),
               "radii": np.asarray(
                   getattr(self, "radii",
                           np.zeros(len(self.centroids), np.float32)),
                   np.float32),
               "blocks_total": np.asarray([self.blocks_total], np.int64)}
        if self.codes is not None:
            out["codes"] = np.asarray(self.codes, np.uint8)
            out["codebooks"] = np.asarray(self.codebooks, np.float32)
        return out

    def from_arrays(self, arrays, segment, column) -> None:
        self.centroids = np.asarray(arrays["centroids"], np.float32)
        self.post_rows = np.asarray(arrays["post_rows"], np.int64)
        self.post_vecs = np.asarray(arrays["post_vecs"], np.float32)
        self.post_offsets = np.asarray(arrays["post_offsets"], np.int64)
        self.radii = np.asarray(arrays["radii"], np.float32)
        self.blocks_total = int(arrays["blocks_total"][0])
        if "codes" in arrays:
            self.codes = np.asarray(arrays["codes"], np.uint8)
            self.codebooks = np.asarray(arrays["codebooks"], np.float32)
            self.use_pq = True
            self.pq_m = int(self.codebooks.shape[0])

    # ------------------------------------------------------------- query
    def _probe_order(self, q: np.ndarray) -> np.ndarray:
        cd = self._l2(q, self.centroids)
        return np.argsort(cd)

    @staticmethod
    def _euclid(d2: np.ndarray) -> np.ndarray:
        return np.sqrt(np.maximum(d2, 0.0))

    def search(self, q: np.ndarray, k: int, n_probe: Optional[int] = None
               ) -> Tuple[np.ndarray, np.ndarray, int]:
        """Top-k (dists, row_ids, blocks_read) via n_probe posting lists."""
        q = np.asarray(q, np.float32)
        n_probe = n_probe or self.n_probe
        probe = self._probe_order(q)[:n_probe]
        cand_slices = [slice(int(self.post_offsets[c]),
                             int(self.post_offsets[c + 1])) for c in probe]
        rows = np.concatenate([self.post_rows[s] for s in cand_slices]) \
            if cand_slices else np.zeros((0,), np.int64)
        if len(rows) == 0:
            return np.zeros((0,)), rows, 0
        blocks_read = sum((s.stop - s.start + BLOCK_ROWS - 1) // BLOCK_ROWS
                          for s in cand_slices)
        if self.use_pq:
            codes = np.concatenate([self.codes[s] for s in cand_slices])
            d_adc = kops.pq_adc_distances(q, codes, self.codebooks,
                                          device=self.device)
            keep = min(len(rows), max(k * self.refine, k))
            top = np.argpartition(d_adc, keep - 1)[:keep]
            vecs = np.concatenate([self.post_vecs[s] for s in cand_slices])
            d_exact = self._euclid(self._l2(q, vecs[top]))
            # (score, row) comparator: pk order within a segment
            order = np.lexsort((rows[top], d_exact))[:k]
            return d_exact[order], rows[top][order], blocks_read
        vecs = np.concatenate([self.post_vecs[s] for s in cand_slices])
        d, idx = kops.block_topk(q, vecs, min(k, len(rows)),
                                 device=self.device)
        return self._euclid(d), rows[idx], blocks_read

    def bitmap(self, segment, predicate) -> np.ndarray:
        """VectorRange: dist(col, q) < thresh — probe lists, exact check."""
        q = np.asarray(predicate.q, np.float32)
        # distance filters need high recall: probe ~half the lists
        mask = np.zeros(segment.n_rows, bool)
        if predicate.thresh <= 0:          # admits nothing: skip the probe
            return mask
        t2 = float(predicate.thresh) ** 2
        n_probe = max(self.n_probe, len(self.centroids) // 2)
        probe = self._probe_order(q)[:n_probe]
        for c in probe:
            s = slice(int(self.post_offsets[c]), int(self.post_offsets[c + 1]))
            if s.stop == s.start:
                continue
            # compare squared distances against thresh^2: same admitted
            # rows, one less full-posting-list sqrt pass
            d2 = self._l2(q, self.post_vecs[s])
            hit = d2 < t2
            mask[self.post_rows[s][hit]] = True
        return mask

    def iterator(self, segment, query) -> SortedAccess:
        return IVFSortedAccess(self, np.asarray(query, np.float32))

    # --------------------------------------------------------- optimizer
    def selectivity(self, segment, predicate) -> float:
        """Sample centroid distances as a proxy for the distance filter."""
        if segment.n_rows == 0:
            return 0.0
        q = np.asarray(predicate.q, np.float32)
        cd = self._euclid(self._l2(q, self.centroids))
        frac = float(np.mean(cd < predicate.thresh * 1.5))
        return min(1.0, max(1.0 / segment.n_rows, frac))

    def probe_cost_blocks(self, segment, predicate) -> float:
        """Blocks touched by an n_probe-deep probe.  Priced from the
        ACTUAL trained list sizes, not n_rows/n_lists: k-means on skewed
        data leaves some posting lists holding most of the rows, and the
        probe order follows query-centroid distance — worst case it
        lands on the heaviest lists, so the conservative estimate sums
        the n_probe LARGEST lists."""
        if self.post_offsets is None:       # not trained yet: balanced guess
            n_lists = len(self.centroids) if self.centroids is not None else 1
            per_list = max(1.0, segment.n_rows / max(1, n_lists) / BLOCK_ROWS)
            return 1.0 + self.n_probe * per_list
        sizes = np.diff(self.post_offsets).astype(np.float64)
        if not len(sizes):
            return 1.0
        top = np.sort(sizes)[::-1][:self.n_probe]
        # every probed list costs at least one block fetch
        return 1.0 + float(np.maximum(top / BLOCK_ROWS, 1.0).sum())


class IVFSortedAccess(SortedAccess):
    """Rigorously sorted access for NRA: posting lists are expanded in
    centroid-distance order; a buffered row is emitted only once its exact
    distance is <= the triangle-inequality lower bound of every unexpanded
    list (max(0, d(q, c) - radius(c))) — so the emitted stream is globally
    non-decreasing and the NRA bound bookkeeping is exact."""

    def __init__(self, index: IVFIndex, q: np.ndarray, block: int = 256):
        self.idx = index
        self.q = q
        cd2 = index._l2(q, index.centroids)
        cd = IVFIndex._euclid(cd2)
        self.order = np.argsort(cd)
        radii = getattr(index, "radii", np.zeros(len(cd), np.float32))
        lbs = np.maximum(cd - radii, 0.0)
        # frontier bound after expanding the first i lists (in cd order)
        lbs_ord = lbs[self.order]
        self._suffix_lb = np.concatenate([
            np.minimum.accumulate(lbs_ord[::-1])[::-1], [np.inf]])
        self.next_list = 0
        self.block = block
        self.buf_d = np.zeros((0,), np.float32)
        self.buf_r = np.zeros((0,), np.int64)
        self.blocks_read = 0

    def _frontier(self) -> float:
        """Lower bound of anything still unexpanded."""
        return float(self._suffix_lb[self.next_list])

    def _expand(self) -> bool:
        if self.next_list >= len(self.order):
            return False
        c = int(self.order[self.next_list])
        self.next_list += 1
        s = slice(int(self.idx.post_offsets[c]),
                  int(self.idx.post_offsets[c + 1]))
        if s.stop > s.start:
            d = IVFIndex._euclid(
                self.idx._l2(self.q, self.idx.post_vecs[s]))
            self.blocks_read += (s.stop - s.start + BLOCK_ROWS - 1) \
                // BLOCK_ROWS
            self.buf_d = np.concatenate([self.buf_d, d])
            self.buf_r = np.concatenate([self.buf_r, self.idx.post_rows[s]])
            o = np.argsort(self.buf_d)
            self.buf_d, self.buf_r = self.buf_d[o], self.buf_r[o]
        return True

    def next_block(self):
        # expand until at least `block` buffered rows are certified
        # (distance <= frontier bound) or nothing remains to expand
        while True:
            certified = int(np.searchsorted(self.buf_d, self._frontier(),
                                            side="right"))
            if certified >= self.block or not self._expand():
                break
        certified = int(np.searchsorted(self.buf_d, self._frontier(),
                                        side="right"))
        n = min(max(certified, 0), len(self.buf_d))
        if n == 0:
            n = min(self.block, len(self.buf_d))  # all expanded: flush
        if n == 0:
            return None
        out = (self.buf_d[:n], self.buf_r[:n])
        self.buf_d, self.buf_r = self.buf_d[n:], self.buf_r[n:]
        return out
