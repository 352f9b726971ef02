"""Cost model for hybrid query plans (paper §5: "a robust cost model that
accounts for index access cost within the LSM layout, expected candidate
set size, and residual predicate evaluation overhead").

Units: 1.0 = one block read (HBM->VMEM tile fetch). Kernel compute per
block is folded into per-block constants (distance scans cost more per
block than bitmap filters — MXU vs VPU work).
"""
from __future__ import annotations

import dataclasses
from typing import List

from repro_torch.core import query as q
from repro_torch.core.types import BLOCK_ROWS

# per-block kernel cost multipliers (relative to a plain block read)
C_FILTER_BLOCK = 1.2       # bitmap_filter kernel over one block
C_VECTOR_BLOCK = 3.0       # ivf_scan distance kernel over one block
C_ROW_RESIDUAL = 1.0 / BLOCK_ROWS   # fetch+eval one row's residual preds
C_MERGE = 0.5              # per-segment top-k merge overhead

# kernel dispatch model (fused vs staged read-path choice)
C_LAUNCH = 5.0             # fixed overhead per kernel dispatch
C_FUSED_BLOCK = 3.4        # fused scan + on-chip top-k merge per block
#                            (C_VECTOR_BLOCK plus the sort network)
C_D2H_ROW = 1.0 / BLOCK_ROWS   # ship one row of distances device->host

# quantized dispatch model (PQ-ADC candidate generation + exact re-rank)
C_RERANK_ROW = C_VECTOR_BLOCK / BLOCK_ROWS  # gather + exact-score 1 row

# graph dispatch model (CSR beam-search candidate generation + re-rank)
C_HOP = 2.0                # one frontier expansion: neighbor gather +
#                            distance batch + sort-network beam prune
C_GATHER_ROW = 2.0 / BLOCK_ROWS  # random-access row gather — pricier
#                            per row than a streamed block read


@dataclasses.dataclass
class PlanCost:
    blocks: float            # estimated block-read units
    candidates: float        # expected candidate rows materialized

    @property
    def total(self) -> float:
        return self.blocks + self.candidates * C_ROW_RESIDUAL


def full_scan_cost(catalog, filters: List) -> PlanCost:
    nb = catalog.total_blocks
    per_block = C_FILTER_BLOCK * max(1, len(filters))
    for f in filters:
        leaf = f.child if isinstance(f, q.Not) else f
        if isinstance(leaf, q.VectorRange):
            per_block += C_VECTOR_BLOCK
    return PlanCost(blocks=nb * per_block, candidates=0.0)


def conjunct_passing(catalog, literals: List) -> float:
    """Expected rows satisfying a conjunction of literals (independence
    assumption — the same estimate the subset enumeration uses)."""
    sel = 1.0
    for p in literals:
        sel *= catalog.selectivity(p)
    return sel * catalog.total_rows


def intersect_cost(catalog, indexed: List, residual: List) -> PlanCost:
    probe = sum(catalog.index_probe_blocks(p) for p in indexed)
    sel = 1.0
    for p in indexed:
        sel *= catalog.selectivity(p)
    cand = sel * catalog.total_rows
    res_cost = cand * C_ROW_RESIDUAL * max(1, len(residual))
    return PlanCost(blocks=probe + res_cost, candidates=cand)


def prefilter_nn_cost(catalog, filters: List, ranks: List,
                      filter_cost: PlanCost) -> PlanCost:
    sel = 1.0
    for p in filters:
        sel *= catalog.selectivity(p)
    passing = sel * catalog.total_rows
    # exact rank scan over passing rows (gathered into blocks)
    rank_blocks = (passing / BLOCK_ROWS) * C_VECTOR_BLOCK * max(1, len(ranks))
    return PlanCost(blocks=filter_cost.blocks + rank_blocks,
                    candidates=passing)


def postfilter_nn_cost(catalog, vector_rank, filters: List, k: int
                       ) -> PlanCost:
    sel = 1.0
    for p in filters:
        sel *= catalog.selectivity(p)
    sel = max(sel, 1e-6)
    inflation = min(catalog.total_rows, k / sel) / max(k, 1)
    probe = catalog.index_probe_blocks(
        q.VectorRange(vector_rank.col, vector_rank.q, float("inf")))
    probe *= max(1.0, inflation / 4.0)      # deeper probes for low sel
    cand = min(catalog.total_rows, k * inflation)
    return PlanCost(blocks=probe * C_VECTOR_BLOCK,
                    candidates=cand * max(1, len(filters)))


def staged_dispatch_cost(catalog, passing_rows: float) -> float:
    """Dispatch + device->host overhead of the staged NN scan path: one
    distance-kernel launch per segment, and the full per-candidate
    distance matrix shipped back for the host top-k cut."""
    n_segs = max(1, len(catalog.store.segments))
    return C_LAUNCH * n_segs + passing_rows * C_D2H_ROW


def fused_dispatch_cost(catalog, passing_rows: float, k: int) -> float:
    """Dispatch + device->host overhead of the fused packed path: ONE
    launch for the whole batch, only (k) rows shipped back, plus the
    on-chip top-k maintenance surcharge over the scanned blocks."""
    merge_extra = (passing_rows / BLOCK_ROWS) * (C_FUSED_BLOCK
                                                 - C_VECTOR_BLOCK)
    return C_LAUNCH + k * C_D2H_ROW + merge_extra


def quantized_dispatch_cost(catalog, passing_rows: float, k: int,
                            refine: int, code_ratio: float) -> float:
    """Dispatch surcharge of the quantized read path, charged (like the
    other ``*_dispatch_cost`` terms) ON TOP of a logical plan that
    already paid ``C_VECTOR_BLOCK`` per scanned block for a full-
    precision scan.  ``code_ratio`` = code bytes per row / fp32 bytes per
    row (m / 4d): the ADC candidate-generation scan streams only that
    fraction of the bytes, so the dominant term is NEGATIVE — the
    bandwidth saving over the logical plan's assumed exact scan.  Against
    it: two launches (ADC scan + re-rank), the on-chip top-k' surcharge
    on the (smaller) scanned bytes, the exact re-rank of refine*k
    surviving rows, and k result rows shipped back."""
    blocks = passing_rows / BLOCK_ROWS
    scan_savings = blocks * C_VECTOR_BLOCK * (1.0 - code_ratio)
    merge_extra = blocks * code_ratio * (C_FUSED_BLOCK - C_VECTOR_BLOCK)
    rerank = C_LAUNCH + refine * k * C_RERANK_ROW
    return C_LAUNCH + k * C_D2H_ROW + merge_extra + rerank - scan_savings


def graph_dispatch_cost(catalog, passing_rows: float, k: int, beam: int,
                        hops: int, r_degree: int) -> float:
    """Dispatch surcharge of the graph read path, charged (like the other
    ``*_dispatch_cost`` terms) ON TOP of a logical plan that already paid
    ``C_VECTOR_BLOCK`` per scanned block for a full-precision scan.  The
    beam search never streams the column: it gathers only the rows the
    traversal touches, so the dominant term is NEGATIVE — the whole scan
    the logical plan assumed.  Against it: per-hop frontier expansion,
    the gathered rows, the exact re-rank of the beam survivors, and k
    result rows shipped back.

    The gather estimate discounts the naive ``beam * R * hops``: the
    visited bitmap dedups re-expansions, so after the opening fan-out
    (~``beam * R / 4`` rows survive the prune) each hop contributes only
    about half a beam of fresh rows.  Traversal cost is deliberately
    mask-INDEPENDENT — the kernel's beam routes through predicate-
    failing rows (dual accumulators), so a filter changes what is
    admitted, not what is gathered.  Selectivity still decides the
    dispatch: the scan savings shrink with the passing-row count, so
    below the point where a pre-filtered exact scan touches fewer rows
    than the fixed traversal, the graph prices itself out."""
    blocks = passing_rows / BLOCK_ROWS
    scan_savings = blocks * C_VECTOR_BLOCK
    gathered = min(float(catalog.total_rows),
                   beam * (r_degree / 4.0 + hops / 2.0))
    probe = hops * C_HOP + gathered * C_GATHER_ROW
    rerank = C_LAUNCH + beam * C_RERANK_ROW
    return C_LAUNCH + k * C_D2H_ROW + probe + rerank - scan_savings


def nra_cost(catalog, ranks: List, filters: List, k: int) -> PlanCost:
    """NRA touches an estimated depth per modality before bounds close;
    heuristic depth grows with modality count and k."""
    n = max(catalog.total_rows, 1)
    ell = len(ranks)
    depth_frac = min(1.0, (k * 8.0 * ell) / n)
    blocks = 0.0
    for r in ranks:
        per_modality = (n * depth_frac) / BLOCK_ROWS
        mult = C_VECTOR_BLOCK if isinstance(r, q.VectorRank) else C_FILTER_BLOCK
        blocks += per_modality * mult + C_MERGE * len(catalog.store.segments)
    cand = n * depth_frac * ell
    if filters:
        cand *= 1.2
    return PlanCost(blocks=blocks, candidates=cand)
