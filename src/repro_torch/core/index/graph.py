"""Per-segment Vamana-style graph index: flat-array CSR over the vector
column (paper §4's secondary-index framework; HMGI's production answer
for high-recall integrated search).

Layout is device-shaped from the start: ``neighbors`` is a dense int32
``(n, R)`` matrix with fixed out-degree R and -1 padding — exactly what
``kernels/graph_search.py`` gathers — plus a medoid entry point.  Build
is the standard incremental loop: greedy beam search from the medoid for
candidates, robust prune (alpha-relaxed) down to R, bidirectional edges
with overflow re-prune.  All squared distances; no sqrt anywhere.

Compaction MERGES graphs instead of rebuilding (the codebook-donation
rule from ``core/quantize.py`` applied to adjacency): the largest part
donates its CSR, remapped through the compaction row maps (-1 for edges
to dropped rows), and only rows the donor does not cover — foreign
parts' rows — are stitched in by bounded re-insertion.  ``reinserted``
/ ``donated_rows`` counters let tests prove the bound.

``pack_graphs`` stacks the per-segment CSRs into packed row space for
the one-launch cross-segment kernel, seeding every segment's medoid.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from repro_torch.core.index.base import ExactSortedAccess, SecondaryIndex
from repro_torch.core.types import BLOCK_ROWS

DEFAULT_R = 16          # fixed out-degree (CSR row width)
DEFAULT_BUILD_BEAM = 32  # greedy-search working-set size at build time
PRUNE_ALPHA = 1.2        # robust-prune relaxation (squared: alpha^2)
N_ENTRIES = 16           # farthest-point-sampled seeds per segment


class GraphIndex(SecondaryIndex):
    """Vamana-style CSR graph over one segment's vector column."""

    kind = "graph"

    def __init__(self, r_degree: int = DEFAULT_R,
                 build_beam: int = DEFAULT_BUILD_BEAM, seed: int = 0):
        self.R = int(r_degree)
        self.build_beam = int(build_beam)
        self.seed = int(seed)
        self.neighbors: Optional[np.ndarray] = None   # (n, R) int32, -1 pad
        self.medoid = 0
        self.entries = np.zeros(0, np.int64)          # FPS seed rows
        self.vecs: Optional[np.ndarray] = None        # segment column ref
        # build-vs-merge accounting (tests assert the re-insertion bound)
        self.inserted_rows = 0
        self.donated_rows = 0

    # ------------------------------------------------------------ build
    def build(self, segment, column) -> None:
        """Vamana build: start from a random R-regular graph (an expander
        — navigable everywhere before any geometry exists), then refine
        every node in two passes, alpha=1.0 then alpha-relaxed.  Pure
        incremental insertion from a single medoid entry is NOT enough:
        on clustered data the build-time search gets stuck in the entry
        point's cluster, plants wrong-cluster edges, and the finished
        graph cannot descend into most clusters at all."""
        vecs = np.asarray(segment.columns[column.name], np.float32)
        self._init_arrays(vecs)
        n = len(vecs)
        if not n:
            return
        rng = np.random.default_rng(self.seed + n)
        if n > 1:
            init = rng.integers(0, n - 1, size=(n, self.R))
            init += init >= np.arange(n)[:, None]      # no self-loops
            self.neighbors[:] = init.astype(np.int32)
        self._built[:] = True
        self.inserted_rows = n
        self._set_medoid()
        self._pick_entries(np.arange(n))
        for alpha in (1.0, PRUNE_ALPHA):
            for i in rng.permutation(n):
                self._refine(int(i), alpha)
        self._ensure_reachable()

    def _init_arrays(self, vecs: np.ndarray) -> None:
        self.vecs = vecs
        self.neighbors = np.full((len(vecs), self.R), -1, np.int32)
        self.medoid = 0
        self.inserted_rows = 0
        self.donated_rows = 0
        self._built = np.zeros(len(vecs), bool)

    def _set_medoid(self) -> None:
        """Entry point = row nearest the column mean (squared L2)."""
        if self.vecs is None or not len(self.vecs):
            return
        mean = self.vecs.mean(axis=0)
        diff = self.vecs - mean
        self.medoid = int(np.argmin((diff * diff).sum(axis=1)))

    def _pick_entries(self, rows: np.ndarray) -> None:
        """Farthest-point-sample N_ENTRIES seed rows (starting nearest
        the medoid).  A single medoid entry is a navigability trap on
        clustered columns — greedy routing cannot always cross cluster
        gaps — while FPS provably lands a seed in every well-separated
        cluster, so the beam opens inside the right one."""
        rows = np.asarray(rows, np.int64)
        if not len(rows):
            self.entries = np.asarray([self.medoid], np.int64)
            return
        sub = self.vecs[rows]
        d = ((sub - self.vecs[self.medoid]) ** 2).sum(axis=1)
        chosen = [int(np.argmin(d))]
        dmin = ((sub - sub[chosen[0]]) ** 2).sum(axis=1)
        while len(chosen) < min(N_ENTRIES, len(rows)):
            nxt = int(np.argmax(dmin))
            chosen.append(nxt)
            dmin = np.minimum(dmin, ((sub - sub[nxt]) ** 2).sum(axis=1))
        self.entries = np.unique(rows[chosen])

    def _seed_rows(self) -> np.ndarray:
        """Seed set for a beam search: the FPS entries restricted to
        built rows, falling back to the medoid mid-insertion."""
        ent = self.entries
        if len(ent):
            ent = ent[self._built[ent]]
            if len(ent):
                return ent
        return np.asarray([self.medoid], np.int64)

    def _greedy(self, qv: np.ndarray, entry, L: int):
        """Best-first search over built rows, seeded with one or many
        entry rows; returns every visited row id with its squared
        distance, sorted ascending by (d2, id)."""
        vecs, nbrs = self.vecs, self.neighbors
        ent = np.unique(np.atleast_1d(np.asarray(entry, np.int64)))
        visited = np.zeros(len(vecs), bool)
        visited[ent] = True
        diff = vecs[ent] - qv
        cand_i = ent
        cand_d = (diff * diff).sum(axis=1).astype(np.float32)
        order = np.lexsort((cand_i, cand_d))
        cand_i, cand_d = cand_i[order], cand_d[order]
        expanded = np.zeros(len(vecs), bool)
        while True:
            head = cand_i[:L]
            todo = head[~expanded[head]]
            if not len(todo):
                break
            u = int(todo[0])
            expanded[u] = True
            nb = nbrs[u]
            nb = nb[nb >= 0]
            nb = nb[~visited[nb]]
            if len(nb):
                visited[nb] = True
                diff = vecs[nb] - qv
                d = (diff * diff).sum(axis=1).astype(np.float32)
                cand_i = np.concatenate([cand_i, nb])
                cand_d = np.concatenate([cand_d, d])
                order = np.lexsort((cand_i, cand_d))
                cand_i, cand_d = cand_i[order], cand_d[order]
        return cand_i, cand_d

    def _robust_prune(self, cand_i: np.ndarray, cand_d: np.ndarray,
                      alpha: float = PRUNE_ALPHA) -> np.ndarray:
        """Vamana robust prune: keep the nearest candidate, drop every
        other candidate it alpha-dominates, repeat up to R survivors.
        Inputs sorted ascending by distance; squared form throughout."""
        a2 = alpha * alpha
        out = []
        ids, d = cand_i, cand_d
        while len(ids) and len(out) < self.R:
            c = int(ids[0])
            out.append(c)
            diff = self.vecs[ids] - self.vecs[c]
            dc = (diff * diff).sum(axis=1)
            keep = a2 * dc > d
            keep[0] = False
            ids, d = ids[keep], d[keep]
        return np.asarray(out, np.int64)

    def _refine(self, i: int, alpha: float) -> None:
        """One Vamana refinement step: greedy-search candidates UNION the
        node's current out-edges -> robust prune -> bidirectional edges
        with overflow re-prune (all at the pass's alpha)."""
        cand_i, cand_d = self._greedy(self.vecs[i], self._seed_rows(),
                                      self.build_beam)
        cur = self.neighbors[i].astype(np.int64)
        cur = cur[cur >= 0]
        if len(cur):
            diff = self.vecs[cur] - self.vecs[i]
            cur_d = (diff * diff).sum(axis=1).astype(np.float32)
            cand_i = np.concatenate([cand_i, cur])
            cand_d = np.concatenate([cand_d, cur_d])
        sel = cand_i != i
        cand_i, cand_d = cand_i[sel], cand_d[sel]
        cand_i, first = np.unique(cand_i, return_index=True)
        cand_d = cand_d[first]
        order = np.lexsort((cand_i, cand_d))
        sel = self._robust_prune(cand_i[order], cand_d[order], alpha)
        self.neighbors[i] = -1
        self.neighbors[i, :len(sel)] = sel
        for j in sel:
            self._backlink(int(j), i, alpha)

    def _backlink(self, j: int, i: int, alpha: float) -> None:
        """Add edge j->i, re-pruning j's list when it overflows."""
        row = self.neighbors[j]
        if i in row:
            return
        free = np.nonzero(row < 0)[0]
        if len(free):
            row[free[0]] = i
            return
        cand = np.concatenate([row.astype(np.int64), [i]])
        diff = self.vecs[cand] - self.vecs[j]
        d = (diff * diff).sum(axis=1).astype(np.float32)
        order = np.lexsort((cand, d))
        pruned = self._robust_prune(cand[order], d[order], alpha)
        self.neighbors[j] = -1
        self.neighbors[j, :len(pruned)] = pruned

    def _insert(self, i: int) -> None:
        """Bounded insertion: greedy-search candidates -> robust prune ->
        bidirectional edges with overflow re-prune."""
        self.inserted_rows += 1
        if not self._built.any():
            self._built[i] = True
            self.medoid = i
            return
        cand_i, cand_d = self._greedy(self.vecs[i], self._seed_rows(),
                                      self.build_beam)
        sel = cand_i != i
        sel &= self._built[cand_i]
        sel = self._robust_prune(cand_i[sel], cand_d[sel])
        self.neighbors[i, :len(sel)] = sel
        self._built[i] = True
        for j in sel:
            self._backlink(int(j), i, PRUNE_ALPHA)

    # ------------------------------------------------------------ merge
    def merge(self, parts: Sequence["GraphIndex"], merged_seg, column,
              row_maps: Sequence[np.ndarray]) -> None:
        """Donation merge (mirrors ``quantize.merge_quantized``): the
        part with the most surviving rows donates its CSR, remapped
        through the compaction row maps; every other row is stitched in
        by the same bounded insertion build uses.  Never a from-scratch
        rebuild."""
        vecs = np.asarray(merged_seg.columns[column.name], np.float32)
        usable = all(p is not None and p.neighbors is not None
                     for p in parts)
        if not usable or not len(vecs):
            self.build(merged_seg, column)
            return
        survivors = [int((rmap >= 0).sum()) for rmap in row_maps]
        donor_i = int(np.argmax(survivors))
        donor, dmap = parts[donor_i], row_maps[donor_i]
        self.R = donor.R
        self._init_arrays(vecs)
        alive = dmap >= 0
        src = np.nonzero(alive)[0]
        if len(src):
            dst = dmap[src]
            nbr = donor.neighbors[src].astype(np.int64)
            valid = nbr >= 0
            safe = np.where(valid, nbr, 0)
            mapped = np.where(valid, dmap[safe], -1)
            mapped = np.where(mapped >= 0, mapped, -1)
            self.neighbors[dst] = mapped.astype(np.int32)
            self._built[dst] = True
            self.donated_rows = len(src)
            dm = dmap[donor.medoid]
            self.medoid = int(dm) if dm >= 0 else int(dst[0])
            # seed insertion searches from FPS entries over donor rows
            self._pick_entries(np.nonzero(self._built)[0])
        # foreign + new rows: everything the donor's map does not cover
        foreign = np.nonzero(~self._built)[0]
        rng = np.random.default_rng(self.seed + len(vecs))
        for i in rng.permutation(foreign):
            self._insert(int(i))
        self._set_medoid()
        self._pick_entries(np.arange(len(vecs)))
        self._ensure_reachable()

    def _reachable(self) -> np.ndarray:
        """Rows reachable from the seed set via out-edges (BFS)."""
        reach = np.zeros(len(self.vecs), bool)
        seeds = np.unique(np.concatenate(
            [[self.medoid], np.asarray(self.entries, np.int64)]))
        reach[seeds] = True
        frontier = seeds
        while len(frontier):
            nb = self.neighbors[frontier].ravel()
            nb = nb[nb >= 0]
            nb = np.unique(nb)
            nb = nb[~reach[nb]]
            reach[nb] = True
            frontier = nb
        return reach

    def _ensure_reachable(self, max_rounds: int = 16) -> None:
        """Repair connectivity: robust-prune drops backward edges freely,
        so a few rows end up with no in-edge path from the medoid and are
        invisible to every beam search.  Each round grafts every stranded
        row onto a near reachable host — a free out-degree slot when the
        host has one, otherwise evicting a neighbor only if that neighbor
        keeps at least two other in-edges (so a graft cannot strand
        someone else).  Rounds repeat until the BFS covers the graph."""
        n = len(self.vecs)
        if not n:
            return
        for _ in range(max_rounds):
            reach = self._reachable()
            miss = np.nonzero(~reach)[0]
            if not len(miss):
                return
            hosts = np.nonzero(reach)[0]
            flat = self.neighbors.ravel()
            indeg = np.bincount(flat[flat >= 0], minlength=n)
            for lo in range(0, len(miss), 256):
                chunk = miss[lo:lo + 256]
                diff = self.vecs[chunk][:, None, :] - \
                    self.vecs[hosts][None, :, :]
                d2 = (diff * diff).sum(axis=2)
                # analysis: allow[parity/raw-score-sort] host candidate
                # shortlist for edge grafting, not a rank ordering — ties
                # pick an arbitrary equally-near host, never a result row
                near = np.argsort(d2, axis=1)[:, :8]
                for mi, m in enumerate(chunk):
                    for hj in near[mi]:
                        row = self.neighbors[int(hosts[hj])]
                        free = np.nonzero(row < 0)[0]
                        if len(free):
                            row[free[0]] = int(m)
                            indeg[m] += 1
                            break
                        # full host: evict the most-redundant neighbor
                        safe = np.where(indeg[row] >= 3, indeg[row], -1)
                        if safe.max() < 0:
                            continue
                        slot = int(np.argmax(safe))
                        indeg[row[slot]] -= 1
                        row[slot] = int(m)
                        indeg[m] += 1
                        break

    # ------------------------------------------------------- persistence
    def to_arrays(self):
        """The CSR survives as-is; ``vecs`` is a reference into the
        segment column and is re-pointed at load, never duplicated."""
        return {"neighbors": np.asarray(self.neighbors, np.int32),
                "entries": np.asarray(self.entries, np.int64),
                "meta": np.asarray([self.medoid, self.R], np.int64)}

    def from_arrays(self, arrays, segment, column) -> None:
        self.neighbors = np.asarray(arrays["neighbors"], np.int32)
        self.entries = np.asarray(arrays["entries"], np.int64)
        self.medoid = int(arrays["meta"][0])
        self.R = int(arrays["meta"][1])
        self.vecs = np.asarray(segment.columns[column.name], np.float32)
        self._built = np.ones(len(self.vecs), bool)
        self.inserted_rows = 0
        self.donated_rows = len(self.vecs)

    # ------------------------------------------------------------ reads
    def search(self, q: np.ndarray, k: int, beam: Optional[int] = None):
        """Host-side greedy beam search -> (sqrt dists, rows, blocks)."""
        if self.neighbors is None or self.vecs is None \
                or not len(self.vecs):
            return (np.zeros(0, np.float32), np.zeros(0, np.int64), 0.0)
        L = max(int(beam or self.build_beam), k)
        cand_i, cand_d = self._greedy(np.asarray(q, np.float32),
                                      self._seed_rows(), L)
        cand_i, cand_d = cand_i[:k], cand_d[:k]
        blocks = 1.0 + len(np.unique(cand_i // BLOCK_ROWS))
        return (np.sqrt(np.maximum(cand_d, 0), dtype=np.float32),
                cand_i, blocks)

    def iterator(self, segment, qv):
        """Exact sorted access (NRA fallback): the graph orders its own
        beam, but NRA's bound bookkeeping needs globally sorted access —
        serve it exactly from the column."""
        diff = self.vecs - np.asarray(qv, np.float32)
        d = np.sqrt(np.maximum((diff * diff).sum(axis=1), 0),
                    dtype=np.float32)
        return ExactSortedAccess(d, np.arange(len(self.vecs),
                                              dtype=np.int64))

    def probe_cost_blocks(self, segment, predicate) -> float:
        gathered = min(segment.n_rows,
                       4 * self.build_beam * max(1, self.R))
        return 1.0 + gathered / BLOCK_ROWS


@dataclasses.dataclass
class PackedGraph:
    """Cross-segment CSR stack in packed row space (row-aligned with
    ``segment.pack_segments``): neighbor ids shifted by each segment's
    packed offset (-1 padding survives), every segment's medoid and FPS
    entry rows all seeds."""
    neighbors: np.ndarray    # (N, R) int32, -1 padded
    entries: np.ndarray      # (E,) int32 packed-space seed rows
    r_degree: int


def pack_graphs(segments: Sequence, col: str) -> Optional[PackedGraph]:
    """Stack per-segment graphs for the one-launch kernel; None when any
    non-empty segment lacks a built graph index (callers fall back to
    the exact fused scan)."""
    idxs, ns = [], []
    for s in segments:
        idx = s.indexes.get(col)
        if s.n_rows and (getattr(idx, "kind", None) != "graph"
                         or idx.neighbors is None):
            return None
        idxs.append(idx)
        ns.append(s.n_rows)
    if not ns or not sum(ns):
        return None
    r_deg = max((idx.R for idx, n in zip(idxs, ns) if n), default=1)
    offsets = np.cumsum([0] + ns)
    nbr = np.full((int(offsets[-1]), r_deg), -1, np.int32)
    entries = []
    for idx, n, off in zip(idxs, ns, offsets[:-1]):
        if not n:
            continue
        part = idx.neighbors
        shifted = np.where(part >= 0, part + np.int32(off), -1)
        nbr[off:off + n, :part.shape[1]] = shifted
        seeds = np.unique(np.concatenate(
            [[idx.medoid], np.asarray(idx.entries, np.int64)]))
        entries.extend(int(e) + int(off) for e in seeds)
    return PackedGraph(nbr, np.asarray(entries, np.int32), int(r_deg))
