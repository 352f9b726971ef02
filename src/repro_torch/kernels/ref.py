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


def rect_filter_ref(points: torch.Tensor, rect: torch.Tensor
                    ) -> torch.Tensor:
    """points (n, 2); rect (4,) = (xmin, ymin, xmax, ymax) -> (n,) bool."""
    x, y = points[:, 0], points[:, 1]
    return (x >= rect[0]) & (x <= rect[2]) & (y >= rect[1]) & (y <= rect[3])


def lex_order(d: torch.Tensor, pk: torch.Tensor, row: torch.Tensor
              ) -> torch.Tensor:
    """Per-row argsort of (nq, m) keys by (d, pk, row) ascending: three
    stable sorts, least significant key first.  NaN sorts last."""
    order = torch.argsort(row, dim=1, stable=True)
    pk_o = torch.gather(pk, 1, order)
    order = torch.gather(order, 1, torch.argsort(pk_o, dim=1, stable=True))
    d_o = torch.gather(d, 1, order)
    return torch.gather(order, 1, torch.argsort(d_o, dim=1, stable=True))



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
    order = lex_order(d, pkb, ids)[:, :k]
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
