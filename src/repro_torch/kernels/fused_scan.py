"""Fused filter-aware distance scan -> per-query top-k: the hand-written
CUDA kernel (``csrc/fused_scan.cu``) that replaces the JAX package's
Pallas ``fused_scan_topk``, and its wrapper.

The kernel reads the device-resident packed column through a list of kept
block ids, so the host never builds a compacted copy of ``x``; its result
is the Pallas kernel's: per query the ``KMAX`` smallest squared-L2
distances over mask-admitted rows ordered by (d2, pk, row), each row
reported as its kept-block position (kept index * BLOCK_N + offset), empty
slots (+inf, SENTINEL, SENTINEL).

One wrapper call is four launches on the card: ``fscan_witness`` (each
chunk's 2 smallest sampled d2 per query), ``topk_threshold`` (a per-query
tau at or above the 128th smallest witness), ``fscan_scan`` (every
admitted row streamed once; rows at or under tau kept, up to KMAX a chunk
and query, else that chunk is rescanned through a top-KMAX list) and
``topk_select`` (a per-query sort of what was kept).  The scan splits the
kept blocks' 32-row groups evenly into ``chunking``'s chunks.

``BLOCK_Q``/``BLOCK_N``/``KMAX``/``SENTINEL`` are the host packing and
occupancy contract (and what the planner reads); the CUDA launch tiles are
named in the source.  The query tile and each warp's ring of staged rows
sit in the scan's shared memory, so ``d`` is bounded (``MAX_DIM``, and the
card's per-block limit: ``smem_bytes``).
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
GROUP_ROWS = 32             # rows of a scan group (csrc kRows)
WITNESSES = 2               # sampled d2 a (chunk, query) publishes
MIN_CHUNKS = 64             # chunks a query tile: 64 x 2 >= KMAX witnesses
MAX_CHUNKS = 512            # most chunks (csrc kMaxChunks)
SLOTS = 2                   # ring slots a scan warp (csrc kSlots)
SAMPLE_ROWS = 8             # rows a witness samples of a sampled group
SAMPLE_EVERY = 8            # it samples one group in SAMPLE_EVERY
SAMPLE_GROUPS = 128         # and at most this many groups a chunk
MAX_DIM = 4096              # the widest d the wrapper takes
_BLOCKS_PER_SM = 2          # scan blocks an SM (csrc kScanBlocks)
_WARPS = 8                  # warps of a scan block (csrc kWarps)
_TILE = 32                  # features of a staged tile (csrc kDk)


def q_stride(d: int) -> int:
    """Floats between the query tile's rows in shared memory (csrc
    q_stride): d rounded up to 4, plus 4 when that is a multiple of 8."""
    d4 = -(-d // 4) * 4
    return d4 if d4 % 8 else d4 + 4


def smem_bytes(d: int) -> int:
    """Shared memory of one scan block at ``d`` features: the query tile,
    the warps' two-slot rings of 32 rows x 32 features (rows padded to 36
    floats), each slot's 16-byte meta and 32 admit bytes, the queries'
    norms, a count and a flag per query.  The launcher is handed this sum
    and refuses it unless it is the size of ``csrc/fused_scan.cu``'s
    carve-out; the wrapper refuses a d whose sum the card cannot hold."""
    ring = GROUP_ROWS * (_TILE + 4) * 4
    return (BLOCK_Q * q_stride(d) * 4 + _WARPS * SLOTS * (ring + 16 + 32)
            + BLOCK_Q * 4 + 2 * BLOCK_Q * 4)


def chunking(n_qtiles: int, nkeep: int, sms: int) -> int:
    """Chunks of the scan grid over the kept blocks' 32-row groups (chunk
    c of C holds groups [c G / C, (c + 1) G / C) of G): the
    ``_BLOCKS_PER_SM`` blocks an SM holds over all query tiles (one wave
    of equal work; the select's cost follows the candidates, not the
    chunks), at least ``MIN_CHUNKS`` a tile (so that its witnesses can
    number KMAX) and at most ``MAX_CHUNKS``, never more than groups."""
    groups = nkeep * (BLOCK_N // GROUP_ROWS)
    want = max(MIN_CHUNKS, -(-_BLOCKS_PER_SM * sms // n_qtiles))
    return max(1, min(want, MAX_CHUNKS, groups))


def chunk_groups(c: int, chunks: int, nkeep: int) -> Tuple[int, int]:
    """The groups [lo, hi) of chunk ``c`` of ``chunks`` (csrc
    chunk_start)."""
    groups = nkeep * (BLOCK_N // GROUP_ROWS)
    return c * groups // chunks, (c + 1) * groups // chunks


def witness_rows(nkeep: int, chunks: int) -> int:
    """Rows the witnesses of one query tile sample over ``chunks`` chunks
    (``chunking``): SAMPLE_ROWS of one group in SAMPLE_EVERY of each
    chunk, at most SAMPLE_GROUPS groups a chunk — about 1/32 of the
    rows."""
    total = 0
    for c in range(chunks):
        lo, hi = chunk_groups(c, chunks, nkeep)
        total += SAMPLE_ROWS * min(SAMPLE_GROUPS, -(-(hi - lo) // SAMPLE_EVERY))
    return total


def empty_topk(nq: int, device) -> Tuple[torch.Tensor, ...]:
    """(nq, KMAX) results with every slot empty: (+inf, SENTINEL,
    SENTINEL)."""
    sent = torch.full((nq, KMAX), int(SENTINEL), dtype=torch.int32,
                      device=device)
    return (torch.full((nq, KMAX), float("inf"), device=device), sent,
            sent.clone())


def launch_scratch(nq: int, chunks: int, device):
    """The launch's scratch, in the launcher's order: witnesses (nq,
    chunks * WITNESSES) uint32 keys, thresholds (nq,) fp32, each chunk's
    candidate region (d2 and kept rows, (nq, chunks * KMAX)), the
    per-query candidate lists (the same shape) and their lengths (nq,):
    views of one allocation (a call's host cost is mostly its
    allocations and launches)."""
    cap = nq * chunks * KMAX
    shapes = [(nq, chunks * WITNESSES), (nq,), (nq, chunks * KMAX),
              (nq, chunks * KMAX), (nq, chunks * KMAX), (nq, chunks * KMAX),
              (nq,)]
    sizes = [nq * chunks * WITNESSES, nq, cap, cap, cap, cap, nq]
    floats = (1, 2, 4)              # tau, the regions' and lists' d2
    buf = torch.empty(sum(sizes), dtype=torch.int32, device=device)
    return tuple(t.view(shape).view(torch.float32) if i in floats
                 else t.view(shape)
                 for i, (t, shape) in enumerate(zip(buf.split(sizes),
                                                    shapes)))


def launch_out(nq: int, device):
    """The (nq, KMAX) d2, pks and rows a launch writes: views of one
    allocation."""
    buf = torch.empty((3, nq, KMAX), dtype=torch.int32, device=device)
    return buf[0].view(torch.float32), buf[1], buf[2]


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
    smem, limit = smem_bytes(d), build.smem_per_block(q.device)
    if smem > limit:
        raise ValueError(f"fused_scan_topk: d={d} needs {smem} bytes of "
                         f"shared memory a block, more than the {limit} the "
                         f"card allows")
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
    chunks = chunking(nq // BLOCK_Q, nkeep, build.sm_count(dev))
    scratch = launch_scratch(nq, chunks, dev)
    out = launch_out(nq, dev)
    launch = build.launcher("fused_scan")
    err = launch(q.data_ptr(), x.data_ptr(), mask.data_ptr(), pks.data_ptr(),
                 keep.data_ptr(), occ.data_ptr(),
                 *(t.data_ptr() for t in scratch + out), nq, d, mask.shape[1],
                 nkeep, chunks, smem,
                 torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "fused_scan_topk")
    launches.add()
    return out
