"""Fused PQ-ADC scan -> per-query top-k': the hand-written CUDA kernel
(``csrc/quantized_scan.cu``) that replaces the JAX package's Pallas
``quantized_scan_topk``, and its wrapper.

The quantized sibling of ``fused_scan``: the same kept-block ids over a
device-resident packed matrix (here the uint8 PQ codes, m bytes a row,
row-aligned with the fp32 column), the same occupancy grid and the same
result contract — per query the ``KMAX`` smallest ADC distances
sum_j lut[q, j, code[i, j]] (fp32, over j in order) over mask-admitted
rows, ordered by (adc, pk, row), each row reported as its kept-block
position, empty slots (+inf, SENTINEL, SENTINEL).

One wrapper call is four launches on the card: witnesses (a sample's 2
smallest ADC values per chunk and query), a per-query threshold (at or
above the 128th smallest witness, so no row of the answer exceeds it),
the scan (only rows at or under the threshold are kept, up to KMAX a
chunk and query, else that chunk is rescanned through a top-KMAX list)
and a per-query select over what was kept.  The chunking below is the
scan's own.

A query tile's 8 LUTs sit in the kernel's shared memory, so ``m`` is
bounded by the card's per-block limit: a larger ``m`` raises
``ValueError`` (there is no other route for it on the card).
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.fused_scan import (BLOCK_N, BLOCK_Q, KMAX, compact,
                                            empty_topk)

N_CODES = 256               # codewords per subquantizer (uint8 codes)
WITNESSES = 2               # sampled ADC values a (chunk, query) publishes
MIN_CHUNKS = 64             # chunks a query tile: 64 x 2 >= KMAX witnesses
MAX_CHUNKS = 512            # most chunks (csrc kMaxChunks)
_BLOCKS_PER_SM = 3          # scan blocks an SM holds at m = 8
_WARPS = 8                  # warps of a scan block (csrc kWarps)

launches = build.LaunchCount()


def smem_bytes(m: int) -> int:
    """Shared memory of one scan block at ``m`` subquantizers: the tile's
    LUTs, each warp's two-slot ring of its 32 rows' codes, and a count and
    an overflow flag per query.  The launcher is handed this sum and
    refuses it unless it is the size of ``csrc/quantized_scan.cu``'s
    carve-out."""
    return BLOCK_Q * m * N_CODES * 4 + _WARPS * 2 * 32 * m + 2 * BLOCK_Q * 4


def chunking(n_qtiles: int, nkeep: int, sms: int) -> Tuple[int, int]:
    """(kept blocks per chunk, chunks) of the scan grid: about
    ``_BLOCKS_PER_SM`` blocks an SM over all query tiles, at least
    ``MIN_CHUNKS`` chunks a tile (so that its witnesses can number KMAX)
    and at most ``MAX_CHUNKS``, never more chunks than kept blocks."""
    want = max(MIN_CHUNKS, -(-_BLOCKS_PER_SM * sms // n_qtiles))
    want = max(1, min(want, MAX_CHUNKS, nkeep))
    per = -(-nkeep // want)
    if -(-nkeep // per) < min(MIN_CHUNKS, nkeep):   # rounding lost chunks
        per = max(1, nkeep // MIN_CHUNKS)
    return per, -(-nkeep // per)


def launch_scratch(nq: int, chunks: int, m: int, device):
    """The launch's scratch, in the launcher's order: witnesses (nq,
    chunks * WITNESSES) uint32 keys, thresholds (nq,) fp32, the LUTs in
    the scan's shared-memory layout (nq, m * 256) fp32, each chunk's
    candidate region (ADC values and kept rows, (nq, chunks * KMAX)), the
    per-query candidate lists (the same shape) and their lengths (nq,)."""
    f32, i32 = torch.float32, torch.int32
    cap = chunks * KMAX
    return (torch.empty((nq, chunks * WITNESSES), dtype=i32, device=device),
            torch.empty((nq,), dtype=f32, device=device),
            torch.empty((nq, m * N_CODES), dtype=f32, device=device),
            torch.empty((nq, cap), dtype=f32, device=device),
            torch.empty((nq, cap), dtype=i32, device=device),
            torch.empty((nq, cap), dtype=f32, device=device),
            torch.empty((nq, cap), dtype=i32, device=device),
            torch.empty((nq,), dtype=i32, device=device))


def plain(lut, codes, mask, pks, keep):
    """The plain version of the kernel on the same inputs and device:
    ``ref.quantized_topk_ref`` over the compacted kept blocks (every kept
    block holds BLOCK_N >= KMAX rows, so KMAX columns come back)."""
    ck, mk, pk = compact(codes, mask, pks, keep)
    return ref.quantized_topk_ref(lut.view(lut.shape[0], -1, N_CODES), ck,
                                  mk, pk, KMAX)


def quantized_scan_topk(lut: torch.Tensor, codes: torch.Tensor,
                        mask: torch.Tensor, pks: torch.Tensor,
                        keep: torch.Tensor, occ: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """lut (nq, m * 256) fp32 with nq a multiple of BLOCK_Q; codes (rows, m)
    uint8 with rows a multiple of BLOCK_N; mask (nq, n) uint8 over the
    first n <= rows rows; pks (rows,) int32; keep (nkeep,) int32 ascending
    block ids of ``codes`` to scan; occ (nq / BLOCK_Q, nkeep) int32, 0
    where a query tile admits no row of a kept block.  Returns ((nq, KMAX)
    fp32 ADC distances, (nq, KMAX) int32 pks, (nq, KMAX) int32 kept-block
    row ids).

    A CUDA tensor launches the kernel; a CPU tensor takes the plain
    version over the kept blocks (the occupancy grid only skips work)."""
    nq, lut_w = lut.shape
    rows, m = codes.shape
    nkeep = keep.shape[0]
    if nq % BLOCK_Q or rows % BLOCK_N or m == 0 or lut_w != m * N_CODES:
        raise ValueError(f"quantized_scan_topk shapes lut "
                         f"{tuple(lut.shape)}, codes {tuple(codes.shape)}")
    smem, limit = smem_bytes(m), build.smem_per_block(lut.device)
    if smem > limit:
        raise ValueError(f"quantized_scan_topk: m={m} needs {smem} bytes "
                         f"of shared memory a block, more than the {limit} "
                         f"the card allows")
    if mask.dim() != 2 or mask.shape[0] != nq or mask.shape[1] > rows:
        raise ValueError(f"quantized_scan_topk mask {tuple(mask.shape)}")
    if pks.shape != (rows,) or occ.shape != (nq // BLOCK_Q, nkeep):
        raise ValueError("quantized_scan_topk pks/occ shapes")
    if (lut.dtype, codes.dtype, mask.dtype, pks.dtype, keep.dtype,
            occ.dtype) != (torch.float32, torch.uint8, torch.uint8,
                           torch.int32, torch.int32, torch.int32):
        raise TypeError("quantized_scan_topk dtypes")
    if len({t.device for t in (lut, codes, mask, pks, keep, occ)}) != 1:
        raise ValueError("quantized_scan_topk operands on different devices")
    if lut.device.type not in ("cpu", "cuda"):
        raise ValueError(f"quantized_scan_topk has no kernel for "
                         f"{lut.device}")
    dev = lut.device
    if nq == 0 or nkeep == 0:
        return empty_topk(nq, dev)
    if dev.type == "cpu":
        return plain(lut, codes, mask, pks, keep)
    lut, codes, mask = lut.contiguous(), codes.contiguous(), mask.contiguous()
    if codes.data_ptr() % 16:       # the scan copies codes 16 bytes at a time
        codes = codes.clone()
    pks, keep, occ = pks.contiguous(), keep.contiguous(), occ.contiguous()
    per, chunks = chunking(nq // BLOCK_Q, nkeep, build.sm_count(dev))
    f32, i32 = torch.float32, torch.int32
    scratch = launch_scratch(nq, chunks, m, dev)
    out = tuple(torch.empty((nq, KMAX), dtype=t, device=dev)
                for t in (f32, i32, i32))
    launch = build.launcher("quantized_scan")
    err = launch(lut.data_ptr(), codes.data_ptr(), mask.data_ptr(),
                 pks.data_ptr(), keep.data_ptr(), occ.data_ptr(),
                 *(t.data_ptr() for t in scratch),
                 *(t.data_ptr() for t in out), nq, m, mask.shape[1],
                 nkeep, per, chunks, smem,
                 torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "quantized_scan_topk")
    launches.add()
    return out
