"""Batched beam search over a packed CSR graph: the hand-written CUDA
kernel (``csrc/graph_search.cu``) that replaces the JAX package's Pallas
``graph_search_topk``, and its wrapper.

Per query: seed from every entry row, ``hops`` hops of expanding the whole
traversal beam's neighbour lists, the fresh rows merged into the
unfiltered traversal beam and the mask-admitting result beam by (d2, pk).
Returns the result beam and the visited bitmask (n / 32 int32 words per
query), whose popcount is the rows-gathered statistic.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import build, ref

launches = build.LaunchCount()


def capacity(beam: int, r_deg: int, n_ent: int) -> int:
    """Fresh rows one hop (or the seed) may add: the power of two the
    kernel sizes its shared candidate lists to."""
    cap = 1
    while cap < max(beam * r_deg, n_ent, 1):
        cap *= 2
    return cap


def smem_bytes(d: int, beam: int, cap: int) -> int:
    """Dynamic shared memory of one block: the query, the traversal,
    result and merge-output beams (d2, pk, row each) and the fresh-row
    lists (d2, pk, row, sort key, admitted-flag prefix)."""
    return 4 * (d + 9 * beam + 5 * cap + 1)


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
    smem = smem_bytes(d, beam, cap)
    limit = build.smem_per_block(q.device)
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
    vis = torch.zeros((nq, n // 32), dtype=torch.int32, device=dev)
    if nq == 0 or beam == 0:
        return out_d, out_p, out_r, vis
    q, x, neighbors = q.contiguous(), x.contiguous(), neighbors.contiguous()
    entries, mask, pks = (entries.contiguous(), mask.contiguous(),
                          pks.contiguous())
    launch = build.launcher("graph_search")
    err = launch(q.data_ptr(), x.data_ptr(), neighbors.data_ptr(),
                 entries.data_ptr(), mask.data_ptr(), pks.data_ptr(),
                 out_d.data_ptr(), out_p.data_ptr(), out_r.data_ptr(),
                 vis.data_ptr(), nq, d, n, r_deg, n_ent, beam, hops, cap,
                 smem, torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "graph_search_topk")
    launches.add()
    return out_d, out_p, out_r, vis
