"""Fused filter-aware distance scan -> per-query top-k: the hand-written
CUDA kernel (``csrc/fused_scan.cu``) that replaces the JAX package's
Pallas ``fused_scan_topk``, and its wrapper.

The kernel reads the device-resident packed column through a list of kept
block ids, so the host never builds a compacted copy of ``x``; its result
is the Pallas kernel's: per query the ``KMAX`` smallest squared-L2
distances over mask-admitted rows ordered by (d2, pk, row), each row
reported as its kept-block position (kept index * BLOCK_N + offset), empty
slots (+inf, SENTINEL, SENTINEL).

``BLOCK_Q``/``BLOCK_N``/``KMAX``/``SENTINEL`` are the host packing and
occupancy contract (and what the planner reads); the CUDA launch tiles are
named in the source.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.kernels import build, ref

BLOCK_Q = 8          # query rows per tile (occupancy-grid rows)
BLOCK_N = 512        # packed rows per block (occupancy-grid columns)
KMAX = 128           # top-k capacity per query

# int32 sentinel for "no candidate" slots: +inf distance partners with the
# largest pk/id so sentinels sort after every real candidate
SENTINEL = np.int32(np.iinfo(np.int32).max)

launches = build.LaunchCount()
_CHUNKS_PER_SM = 4          # pass-1 blocks per SM the chunking aims at
MAX_DIM = 4096              # the query tile (8 x d fp32) sits in shared memory


def chunking(n_qtiles: int, nkeep: int, device: torch.device
              ) -> Tuple[int, int]:
    """(blocks per chunk, chunks): enough pass-1 blocks to fill the card."""
    want = max(1, -(-build.sm_count(device) * _CHUNKS_PER_SM // n_qtiles))
    per = max(1, -(-nkeep // min(want, nkeep)))
    return per, -(-nkeep // per)


def empty_topk(nq: int, device) -> Tuple[torch.Tensor, ...]:
    """(nq, KMAX) results with every slot empty: (+inf, SENTINEL,
    SENTINEL)."""
    sent = torch.full((nq, KMAX), int(SENTINEL), dtype=torch.int32,
                      device=device)
    return (torch.full((nq, KMAX), float("inf"), device=device), sent,
            sent.clone())


def launch_buffers(nq: int, nkeep: int, device):
    """Chunking and buffers of a two-pass launch: (blocks per chunk,
    chunks, the (nq, KMAX) outputs, the (nq, chunks, KMAX) pass-1
    scratch), each a (d, pk, row) triple."""
    per, chunks = chunking(nq // BLOCK_Q, nkeep, device)
    out = (torch.empty((nq, KMAX), dtype=torch.float32, device=device),
           torch.empty((nq, KMAX), dtype=torch.int32, device=device),
           torch.empty((nq, KMAX), dtype=torch.int32, device=device))
    part = (torch.empty((nq, chunks, KMAX), dtype=torch.float32,
                        device=device),
            torch.empty((nq, chunks, KMAX), dtype=torch.int32, device=device),
            torch.empty((nq, chunks, KMAX), dtype=torch.int32, device=device))
    return per, chunks, out, part


def compact(x: torch.Tensor, mask: torch.Tensor, pks: torch.Tensor,
            keep: torch.Tensor):
    """The kept blocks of the packed column, bitmap and pks gathered into
    contiguous (xk, mk, pk (1, rows)) on their device — the matrix the
    JAX package's host compaction builds and its Pallas kernel scans."""
    nq, d = mask.shape[0], x.shape[1]
    mfull = torch.zeros((nq, x.shape[0]), dtype=torch.uint8,
                        device=x.device)
    mfull[:, :mask.shape[1]] = mask
    kl = keep.long()
    xk = x.view(-1, BLOCK_N, d)[kl].reshape(-1, d)
    mk = mfull.view(nq, -1, BLOCK_N)[:, kl].reshape(nq, -1)
    pk = pks.view(-1, BLOCK_N)[kl].reshape(1, -1)
    return xk, mk, pk


def plain(q, x, mask, pks, keep):
    """The plain version of the kernel on the same inputs and device:
    ``ref.fused_topk_ref`` over the compacted kept blocks (every kept block
    holds BLOCK_N >= KMAX rows, so KMAX columns come back)."""
    xk, mk, pk = compact(x, mask, pks, keep)
    return ref.fused_topk_ref(q, xk, mk, pk, KMAX)


def fused_scan_topk(q: torch.Tensor, x: torch.Tensor, mask: torch.Tensor,
                    pks: torch.Tensor, keep: torch.Tensor, occ: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """q (nq, d) fp32 with nq a multiple of BLOCK_Q; x (rows, d) fp32 with
    rows a multiple of BLOCK_N; mask (nq, n) uint8 over the first n <= rows
    rows of x; pks (rows,) int32; keep (nkeep,) int32 ascending block ids
    of x to scan; occ (nq / BLOCK_Q, nkeep) int32, 0 where a query tile
    admits no row of a kept block.  Returns ((nq, KMAX) fp32 d2, (nq, KMAX)
    int32 pks, (nq, KMAX) int32 kept-block row ids).

    A CUDA tensor launches the kernel; a CPU tensor takes the plain
    version ``ref.fused_topk_ref`` over the kept blocks (the occupancy grid
    only skips work and changes no result)."""
    nq, d = q.shape
    rows = x.shape[0]
    nkeep = keep.shape[0]
    if nq % BLOCK_Q or rows % BLOCK_N or x.shape[1] != d or d > MAX_DIM:
        raise ValueError(f"fused_scan_topk shapes q {tuple(q.shape)}, "
                         f"x {tuple(x.shape)}")
    if mask.dim() != 2 or mask.shape[0] != nq or mask.shape[1] > rows:
        raise ValueError(f"fused_scan_topk mask {tuple(mask.shape)}")
    if pks.shape != (rows,) or occ.shape != (nq // BLOCK_Q, nkeep):
        raise ValueError("fused_scan_topk pks/occ shapes")
    if (q.dtype, x.dtype, mask.dtype, pks.dtype, keep.dtype, occ.dtype) != (
            torch.float32, torch.float32, torch.uint8, torch.int32,
            torch.int32, torch.int32):
        raise TypeError("fused_scan_topk dtypes")
    if len({t.device for t in (q, x, mask, pks, keep, occ)}) != 1:
        raise ValueError("fused_scan_topk operands on different devices")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_scan_topk has no kernel for {q.device}")
    if nq == 0 or nkeep == 0:
        return empty_topk(nq, q.device)
    if q.device.type == "cpu":
        return plain(q, x, mask, pks, keep)
    q, x, mask = q.contiguous(), x.contiguous(), mask.contiguous()
    pks, keep, occ = pks.contiguous(), keep.contiguous(), occ.contiguous()
    dev = q.device
    per, chunks, out, part = launch_buffers(nq, nkeep, dev)
    launch = build.launcher("fused_scan")
    err = launch(q.data_ptr(), x.data_ptr(), mask.data_ptr(), pks.data_ptr(),
                 keep.data_ptr(), occ.data_ptr(),
                 *(t.data_ptr() for t in part + out), nq, d, mask.shape[1],
                 nkeep, per, chunks, torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "fused_scan_topk")
    launches.add()
    return out
