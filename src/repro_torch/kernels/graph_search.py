"""Batched beam search over a packed CSR graph: the hand-written CUDA
kernel (``csrc/graph_search.cu``) that replaces the JAX package's Pallas
``graph_search_topk``, and its wrapper.

Per query: seed from every entry row, ``hops`` hops of expanding the
traversal beam's neighbour lists, the fresh rows merged into the
unfiltered traversal beam and the mask-admitting result beam by (d2, pk).
Returns the result beam and the visited bitmask (n / 32 int32 words per
query), whose popcount is the rows-gathered statistic.  The kernel expands
only the rows new to the beam and drops fresh rows that can enter neither
beam, which changes no output (``csrc/graph_search.cu``).

One launch a call.  A staged tile holds 256 fresh rows, or fewer when
the lists of a large capacity leave no room (``tile_rows``): every shape
the graph path reaches (beam <= 128, d <= 4096, capacity <= 8,192) fits a
block on sm_90.  The visited
words live in the block's shared memory when they fit beside the rest of
its layout (``visited_path``), else in the output tensor in global
memory; the kernel writes every word either way.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import build, ref

launches = build.LaunchCount()

# csrc/graph_search.cu's layout constants (the tests hold them to it)
TILE_ROWS = (256, 128, 64, 32)   # rows a staged tile may hold
STAGE_STRIDE = 68    # kXs: a staged row's floats (64 features + 4)
SLOTS = 2            # kSlots: staged tiles in flight
HEADER = 4           # kHeader: words of the counts
GROUP = 32           # sorted survivors a warp holds (the least capacity)


def capacity(beam: int, r_deg: int, n_ent: int) -> int:
    """Fresh rows (and so survivors) one hop or the seed may hold: the
    power of two, at least one ``GROUP``, the kernel sizes its lists to
    (the sort's width)."""
    cap = GROUP
    while cap < max(beam * r_deg, n_ent):
        cap *= 2
    return cap


def smem_bytes(d: int, beam: int, cap: int, vis_words: int = 0,
               tile_rows: int = TILE_ROWS[0]) -> int:
    """Shared memory of one block, all dynamic: the staged tiles, the
    counts, the query (d rounded up to 4), the survivor records (4 words
    each), the traversal and result beams twice (d2, pk, row), the rows
    that entered the traversal beam, the fresh rows, and ``vis_words``
    visited words (0 on the global-memory path)."""
    return 4 * (SLOTS * tile_rows * STAGE_STRIDE + HEADER + -(-d // 4) * 4
                + 5 * cap + 13 * beam + vis_words)


# The rules below take ``limit``, the shared memory a block may use on the
# device (``build.smem_per_block``), which the wrapper reads once a call.

def tile_rows(d: int, beam: int, cap: int, limit: int) -> int:
    """Rows of a staged tile: the most of ``TILE_ROWS`` whose layout fits
    ``limit`` bytes (the fewest when none does, which the wrapper then
    refuses)."""
    return next((t for t in TILE_ROWS
                 if smem_bytes(d, beam, cap, 0, t) <= limit), TILE_ROWS[-1])


def visited_path(n: int, d: int, beam: int, r_deg: int, n_ent: int,
                 limit: int) -> str:
    """Where the kernel keeps a query's n / 32 visited words: ``shared``
    when the block's layout with them fits ``limit`` bytes, else
    ``global`` (the output tensor)."""
    return "shared" if max_shared_rows(d, beam, r_deg, n_ent,
                                       limit) >= n else "global"


def max_shared_rows(d: int, beam: int, r_deg: int, n_ent: int,
                    limit: int) -> int:
    """The most rows (a multiple of 32) whose visited words the kernel
    keeps in shared memory at this shape (0: none)."""
    cap = capacity(beam, r_deg, n_ent)
    spare = limit - smem_bytes(d, beam, cap, 0,
                               tile_rows(d, beam, cap, limit))
    return max(0, spare // 4) * 32


def graph_search_topk(q: torch.Tensor, x: torch.Tensor,
                      neighbors: torch.Tensor, entries: torch.Tensor,
                      mask: torch.Tensor, pks: torch.Tensor, beam: int,
                      hops: int) -> Tuple[torch.Tensor, ...]:
    """q (nq, d) fp32; x (n, d) fp32 with n a multiple of 32; neighbors
    (n, R) int32 in row space, -1 padded; entries (1, E) int32 seed rows,
    SENTINEL padded; mask (nq, n) uint8; pks (1, n) int32; all on one
    device.  Returns ((nq, beam) fp32 d2 ascending, (nq, beam) int32 pks,
    (nq, beam) int32 rows, (nq, n / 32) int32 visited bitmask); empty
    result slots hold (+inf, SENTINEL, SENTINEL).

    A CUDA tensor launches the kernel; a CPU tensor takes the plain
    version ``ref.graph_search_topk_ref``."""
    nq, d = q.shape
    n, r_deg = neighbors.shape
    if x.shape != (n, d) or n % 32 or mask.shape != (nq, n) \
            or pks.shape != (1, n) or entries.dim() != 2 \
            or entries.shape[0] != 1 or beam < 0 or hops < 0:
        raise ValueError(f"graph_search_topk shapes q {tuple(q.shape)}, x "
                         f"{tuple(x.shape)}, neighbors "
                         f"{tuple(neighbors.shape)}, mask "
                         f"{tuple(mask.shape)}")
    if (q.dtype, x.dtype, neighbors.dtype, entries.dtype, mask.dtype,
            pks.dtype) != (torch.float32, torch.float32, torch.int32,
                           torch.int32, torch.uint8, torch.int32):
        raise TypeError("graph_search_topk dtypes")
    if len({t.device for t in (q, x, neighbors, entries, mask, pks)}) != 1:
        raise ValueError("graph_search_topk operands on different devices")
    n_ent = entries.shape[1]
    cap = capacity(beam, r_deg, n_ent)
    limit = build.smem_per_block(q.device)
    rows = tile_rows(d, beam, cap, limit)
    shared = visited_path(n, d, beam, r_deg, n_ent, limit) == "shared"
    smem = smem_bytes(d, beam, cap, n // 32 if shared else 0, rows)
    if smem > limit:
        raise ValueError(f"graph_search_topk: beam {beam} x R {r_deg} "
                         f"needs {smem} bytes of shared memory, a block "
                         f"may use {limit}")
    if q.device.type == "cpu":
        return ref.graph_search_topk_ref(q, x, neighbors, entries, mask,
                                         pks, beam, hops)
    if q.device.type != "cuda":
        raise ValueError(f"graph_search_topk has no kernel for {q.device}")
    dev = q.device
    out_d = torch.empty((nq, beam), dtype=torch.float32, device=dev)
    out_p = torch.empty((nq, beam), dtype=torch.int32, device=dev)
    out_r = torch.empty((nq, beam), dtype=torch.int32, device=dev)
    vis = torch.empty((nq, n // 32), dtype=torch.int32, device=dev)
    if nq == 0:
        return out_d, out_p, out_r, vis
    q, x, neighbors = q.contiguous(), x.contiguous(), neighbors.contiguous()
    entries, mask, pks = (entries.contiguous(), mask.contiguous(),
                          pks.contiguous())
    launch = build.launcher("graph_search")
    err = launch(q.data_ptr(), x.data_ptr(), neighbors.data_ptr(),
                 entries.data_ptr(), mask.data_ptr(), pks.data_ptr(),
                 out_d.data_ptr(), out_p.data_ptr(), out_r.data_ptr(),
                 vis.data_ptr(), nq, d, n, r_deg, n_ent, beam, hops, cap,
                 rows, int(shared), smem, torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "graph_search_topk")
    launches.add()
    return out_d, out_p, out_r, vis
