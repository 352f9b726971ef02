"""Plain PyTorch versions of the hand-written kernels.

Each function computes, on any device, what one CUDA kernel computes
(the port's counterpart of ``repro.kernels.ref``).  The kernel wrappers
take them only for tensors that lie on the CPU; the CPU tests hold them
against the JAX package's oracles and Pallas kernels, and ``chip_smoke.py``
holds each kernel against its plain version on the card.
"""
from __future__ import annotations

import torch

SENTINEL = 2 ** 31 - 1      # int32 max: the "no candidate" pk / row


def ivf_scan_ref(q: torch.Tensor, vecs: torch.Tensor) -> torch.Tensor:
    """Squared-L2 distances. q: (nq, d); vecs: (n, d) -> (nq, n) fp32, by
    the expansion (||q||^2 - 2 q.v) + ||v||^2."""
    q = q.to(torch.float32)
    v = vecs.to(torch.float32)
    qn = (q * q).sum(dim=-1, keepdim=True)
    vn = (v * v).sum(dim=-1)[None, :]
    return qn - 2.0 * (q @ v.T) + vn


def bitmap_filter_ref(cols: torch.Tensor, bounds: torch.Tensor
                      ) -> torch.Tensor:
    """cols (n, c) fp32; bounds (c, 2) [lo, hi] inclusive -> (n,) bool:
    AND over all per-column range predicates."""
    lo = bounds[:, 0][None, :]
    hi = bounds[:, 1][None, :]
    return ((cols >= lo) & (cols <= hi)).all(dim=1)


def bitmap_filter_blocks_ref(cols: torch.Tensor, rows: torch.Tensor,
                             blocks: torch.Tensor, bounds: torch.Tensor,
                             n_out: int, block_rows: int) -> torch.Tensor:
    """``bitmap_filter_ref`` over the listed blocks of ``cols``, scattered
    through ``rows``: cols (n, c) fp32 and rows (n,) int, a segment's points
    in index order and each one's segment row; blocks (nb,) int ids of
    ``block_rows``-point blocks -> (n_out,) bool, True at rows[i] for every
    point i of a listed block inside every [lo, hi] of bounds (c, 2).
    Block ids outside [0, ceil(n / block_rows)) and row ids outside
    [0, n_out) are skipped."""
    n = cols.shape[0]
    b = blocks.to(torch.int64)
    b = b[(b >= 0) & (b * block_rows < n)]
    idx = (b[:, None] * block_rows
           + torch.arange(block_rows, device=cols.device)[None, :]).flatten()
    idx = idx[idx < n]
    r = rows[idx][bitmap_filter_ref(cols[idx], bounds)].to(torch.int64)
    out = torch.zeros(n_out, dtype=torch.bool, device=cols.device)
    out[r[(r >= 0) & (r < n_out)]] = True
    return out


def rect_filter_ref(points: torch.Tensor, rect: torch.Tensor
                    ) -> torch.Tensor:
    """points (n, 2); rect (4,) = (xmin, ymin, xmax, ymax) -> (n,) bool."""
    x, y = points[:, 0], points[:, 1]
    return (x >= rect[0]) & (x <= rect[2]) & (y >= rect[1]) & (y <= rect[3])


def stable_order(keys) -> torch.Tensor:
    """Per-row argsort of (nq, m) key tensors, most significant first, ties
    kept in position order (as ``lax.sort`` with ``num_keys=len(keys)``
    orders them): one stable sort per key, least significant first.  NaN
    sorts last."""
    order = None
    for key in reversed(keys):
        k = key if order is None else torch.gather(key, 1, order)
        o = torch.argsort(k, dim=1, stable=True)
        order = o if order is None else torch.gather(order, 1, o)
    return order


def masked_topk(d: torch.Tensor, mask: torch.Tensor, pks: torch.Tensor,
                k: int):
    """Per row of the (nq, n) scores ``d``, the k smallest over the columns
    ``mask`` admits by (d, pk, column); (+inf, SENTINEL, SENTINEL) fill the
    slots past the admitted count.  Returns (scores, pks, columns)."""
    m = mask != 0
    d = torch.where(m, d, torch.full_like(d, float("inf")))
    ids = torch.arange(d.shape[1], dtype=torch.int32,
                       device=d.device)[None, :].expand_as(d)
    sent = torch.full_like(ids, SENTINEL)
    ids = torch.where(m, ids, sent)
    pkb = torch.where(m, pks.to(torch.int32).expand_as(d), sent)
    order = stable_order([d, pkb, ids])[:, :k]
    return (torch.gather(d, 1, order), torch.gather(pkb, 1, order),
            torch.gather(ids, 1, order))


def fused_topk_ref(q: torch.Tensor, x: torch.Tensor, mask: torch.Tensor,
                   pks: torch.Tensor, k: int):
    """Fused masked scan -> top-k (kernels/fused_scan.py).

    q (nq, d); x (n, d); mask (nq, n); pks (1, n) int32 -> per query the k
    smallest squared-L2 distances over mask-admitted rows, ties broken by
    pk, then row id.  Returns ((nq, k) fp32, (nq, k) int32 pks, (nq, k)
    int32 row ids); empty slots hold (+inf, SENTINEL, SENTINEL)."""
    return masked_topk(ivf_scan_ref(q, x), mask, pks, k)


def pq_adc_ref(codes: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    """ADC (kernels/pq_adc.py): codes (n, m) uint8; lut (m, 256) fp32 ->
    (n,) fp32 = sum_j lut[j, codes[:, j]], summed in fp32 over j in order
    from 0 — the order of the TPU kernel's one-hot contraction (one exact
    term per j), which the CUDA kernel keeps."""
    lut = lut.to(torch.float32)
    acc = torch.zeros(codes.shape[0], dtype=torch.float32, device=lut.device)
    for j in range(codes.shape[1]):
        acc = acc + lut[j][codes[:, j].long()]
    return acc


def quantized_topk_ref(lut: torch.Tensor, codes: torch.Tensor,
                       mask: torch.Tensor, pks: torch.Tensor, k: int):
    """Fused quantized ADC scan -> top-k' (kernels/quantized_scan.py).

    lut (nq, m, 256) fp32 per-query ADC tables; codes (n, m); mask
    (nq, n); pks (1, n) int32 -> per query the k smallest ADC distances
    (summed over j in order, as ``pq_adc_ref``) over mask-admitted rows,
    ties broken by pk, then row id.  Returns ((nq, k) fp32, (nq, k) int32
    pks, (nq, k) int32 row ids); empty slots hold (+inf, SENTINEL,
    SENTINEL)."""
    lut = lut.to(torch.float32)
    nq, n = mask.shape
    d = torch.zeros((nq, n), dtype=torch.float32, device=lut.device)
    for j in range(codes.shape[1]):
        d = d + lut[:, j, :][:, codes[:, j].long()]
    return masked_topk(d, mask, pks, k)


def topk_merge_ref(dists: torch.Tensor, ids: torch.Tensor, k: int):
    """Merge S per-segment top-k lists (kernels/topk_merge.py
    ``topk_merge``): dists/ids (s, kk) -> the k smallest distances,
    (k,) and (k,), ties broken by flattened position (a stable argsort);
    each position is taken at most once.  ``ids`` are payload only and
    keep their dtype."""
    flat_d = dists.reshape(-1).to(torch.float32)
    flat_i = ids.reshape(-1)
    # analysis: allow[parity/raw-score-sort] ties break by flattened
    # position here, matching the kernel's selection order
    order = torch.argsort(flat_d, stable=True)[:k]
    return flat_d[order], flat_i[order]


def batched_topk_merge_ref(dists: torch.Tensor, ids: torch.Tensor, k: int):
    """Batched cross-shard merge (topk_merge.batched_topk_merge).

    dists (nq, s, kk) fp32; ids (nq, s, kk) int32 -> ((nq, k), (nq, k)):
    per query the k smallest candidates across all shard lists in
    ascending (score, id) lexicographic order; padded slots carry
    (+inf, SENTINEL) and sort last, and slots past the s * kk candidates
    come back as (+inf, SENTINEL)."""
    nq = dists.shape[0]
    flat_d = dists.reshape(nq, -1).to(torch.float32)
    flat_i = ids.reshape(nq, -1).to(torch.int32)
    order = stable_order([flat_d, flat_i])[:, :k]
    sd = torch.gather(flat_d, 1, order)
    si = torch.gather(flat_i, 1, order)
    short = k - sd.shape[1]
    if short > 0:
        sd = torch.cat([sd, sd.new_full((nq, short), float("inf"))], dim=1)
        si = torch.cat([si, si.new_full((nq, short), SENTINEL)], dim=1)
    return sd, si


def graph_search_topk_ref(q: torch.Tensor, x: torch.Tensor,
                          neighbors: torch.Tensor, entries: torch.Tensor,
                          mask: torch.Tensor, pks: torch.Tensor,
                          beam: int, hops: int):
    """Batched CSR beam search (kernels/graph_search.py).

    q (nq, d); x (n, d); neighbors (n, R) int32 packed CSR, -1 padded;
    entries (1, E) int32 seed rows, SENTINEL padded; mask (nq, n); pks
    (1, n) int32; n a multiple of 32.  The hop loop of the JAX package's
    oracle, operation for operation: seed from every entry (all of them
    visited), then each hop expands the whole traversal beam's neighbour
    lists, drops -1 padding, dead lanes and visited rows, dedups by row,
    and merges the fresh rows into the unfiltered traversal beam and the
    mask-admitting result beam by a stable sort on (d2, pk) over
    [beam || fresh rows in row order].  d2 is the difference form summed
    over the d features in order 0..d-1, one fp32 rounding per operation
    (the CUDA kernel's order).  Returns ((nq, beam) fp32 d2 ascending,
    (nq, beam) int32 pks, (nq, beam) int32 rows, (nq, n/32) int32 visited
    bitmask); empty result slots hold (+inf, SENTINEL, SENTINEL)."""
    dev = q.device
    q = q.to(torch.float32)
    x = x.to(torch.float32)
    nbrs = neighbors.to(torch.int32)
    m = mask != 0
    pk1 = pks[0].to(torch.int32)
    ent = entries[0].to(torch.int32)
    nq, d = q.shape
    r_deg = nbrs.shape[1]
    nw = x.shape[0] // 32
    inf = float("inf")

    def dists_to(safe):
        diff = x[safe.long()] - q[:, None, :]           # (nq, C, d)
        acc = torch.zeros(safe.shape, dtype=torch.float32, device=dev)
        for j in range(d):
            acc = acc + diff[:, :, j] * diff[:, :, j]
        return acc

    def scatter_bits(safe, live):
        bit = torch.where(live, torch.ones_like(safe, dtype=torch.int64)
                          << (safe & 31).to(torch.int64), 0)
        acc = torch.zeros((nq, nw), dtype=torch.int64, device=dev)
        acc.scatter_add_(1, (safe >> 5).long(), bit)
        # distinct single bits: the sum is the OR; wrap bit 31 to int32
        return torch.where(acc >= 2 ** 31, acc - 2 ** 32, acc).to(
            torch.int32)

    def merge_topm(acc, cd, cp, ci):
        md = torch.cat([acc[0], cd], dim=1)
        mp = torch.cat([acc[1], cp], dim=1)
        mi = torch.cat([acc[2], ci], dim=1)
        order = stable_order([md, mp])[:, :beam]
        return tuple(torch.gather(t, 1, order) for t in (md, mp, mi))

    def where(c, a, fill):
        return torch.where(c, a, torch.full_like(a, fill))

    n_ent = ent.shape[0]
    ev = (ent != SENTINEL)[None, :].expand(nq, n_ent)
    esafe = torch.where(ent != SENTINEL, ent, 0)[None, :].expand(nq, n_ent)
    ed = where(ev, dists_to(esafe), inf)
    epk = where(ev, pk1[esafe.long()], SENTINEL)
    eid = where(ev, esafe, SENTINEL)
    empty = (torch.full((nq, beam), inf, device=dev),
             torch.full((nq, beam), SENTINEL, dtype=torch.int32, device=dev),
             torch.full((nq, beam), SENTINEL, dtype=torch.int32, device=dev))
    bd, bp, bi = merge_topm(empty, ed, epk, eid)
    epass = ev & torch.gather(m, 1, esafe.long())
    rd, rp, ri = merge_topm(empty, where(epass, ed, inf),
                            where(epass, epk, SENTINEL),
                            where(epass, eid, SENTINEL))
    vis = scatter_bits(esafe, ev)
    for _ in range(hops):
        fval = bi != SENTINEL
        fsafe = torch.where(fval, bi, 0)
        cand = nbrs[fsafe.long()].reshape(nq, beam * r_deg)
        # guard before any gather keyed by cand: -1 padding and dead
        # frontier lanes would otherwise read row 0
        cval = (cand >= 0) & fval.repeat_interleave(r_deg, dim=1)
        csafe = torch.where(cval, cand, 0)
        words = torch.gather(vis, 1, (csafe >> 5).long())
        seen = ((words >> (csafe & 31)) & 1) != 0
        fresh = cval & ~seen
        cd = where(fresh, dists_to(csafe), inf)
        cp = where(fresh, pk1[csafe.long()], SENTINEL)
        ci = where(fresh, csafe, SENTINEL)
        # in-hop dedup: repeated rows are adjacent once sorted by row and
        # carry identical (d2, pk), so all but the first are dropped
        order = stable_order([ci])
        si_, sd_, sp_ = (torch.gather(t, 1, order) for t in (ci, cd, cp))
        dup = torch.cat([torch.zeros((nq, 1), dtype=torch.bool, device=dev),
                         si_[:, 1:] == si_[:, :-1]], dim=1) & (si_ != SENTINEL)
        uniq = (si_ != SENTINEL) & ~dup
        usafe = torch.where(uniq, si_, 0)
        ud = where(uniq, sd_, inf)
        up = where(uniq, sp_, SENTINEL)
        ui = where(uniq, si_, SENTINEL)
        vis = vis | scatter_bits(usafe, uniq)
        bd, bp, bi = merge_topm((bd, bp, bi), ud, up, ui)
        admit = uniq & torch.gather(m, 1, usafe.long())
        rd, rp, ri = merge_topm((rd, rp, ri), where(admit, ud, inf),
                                where(admit, up, SENTINEL),
                                where(admit, ui, SENTINEL))
    return rd, rp, ri, vis
