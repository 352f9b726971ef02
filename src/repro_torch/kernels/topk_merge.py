"""Top-k merges: the hand-written CUDA kernels (``csrc/topk_merge.cu``)
that replace the JAX package's Pallas ``batched_topk_merge`` (the
cross-shard merge of a query batch) and ``topk_merge`` (one (s, kk) list),
and their wrappers.  Each kernel has its own launch count.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import build, ref

batched_launches = build.LaunchCount()   # batched_topk_merge
launches = build.LaunchCount()           # topk_merge


def _smem_bytes(c: int, per_row: int, device) -> int:
    """Dynamic shared memory for staging ``c`` candidates of ``per_row``
    bytes, or 0 when they do not fit a block (the kernel then reads them
    from global memory)."""
    need = c * per_row
    return need if need <= build.smem_per_block(device) - 1024 else 0


def batched_topk_merge(dists: torch.Tensor, ids: torch.Tensor, k: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """dists (nq, s, kk) fp32, ids (nq, s, kk) int32 on one device ->
    ((nq, k) fp32, (nq, k) int32): per query the k smallest candidates in
    (score, id) order; pad empty slots with (+inf, SENTINEL), and slots
    past the candidates come back so.  A CUDA tensor launches the kernel;
    a CPU tensor takes the plain version ``ref.batched_topk_merge_ref``."""
    if dists.dim() != 3 or ids.shape != dists.shape or k < 0:
        raise ValueError(f"batched_topk_merge shapes {tuple(dists.shape)}, "
                         f"{tuple(ids.shape)}, k={k}")
    if dists.dtype != torch.float32 or ids.dtype != torch.int32:
        raise TypeError("batched_topk_merge takes fp32 scores, int32 ids")
    if dists.device != ids.device:
        raise ValueError("batched_topk_merge operands on different devices")
    if dists.device.type == "cpu":
        return ref.batched_topk_merge_ref(dists, ids, k)
    if dists.device.type != "cuda":
        raise ValueError(f"batched_topk_merge has no kernel for "
                         f"{dists.device}")
    nq, s, kk = dists.shape
    dev = dists.device
    out_d = torch.empty((nq, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((nq, k), dtype=torch.int32, device=dev)
    if nq == 0 or k == 0:
        return out_d, out_i
    if s * kk == 0:
        return out_d.fill_(float("inf")), out_i.fill_(int(ref.SENTINEL))
    dists, ids = dists.contiguous(), ids.contiguous()
    launch = build.launcher("topk_merge", "batched_topk_merge_launch")
    err = launch(dists.data_ptr(), ids.data_ptr(), out_d.data_ptr(),
                 out_i.data_ptr(), nq, s * kk, k,
                 _smem_bytes(s * kk, 8, dev),
                 torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "batched_topk_merge")
    batched_launches.add()
    return out_d, out_i


def topk_merge(dists: torch.Tensor, ids: torch.Tensor, k: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """dists (s, kk) fp32, ids (s, kk) int32 or int64 on one device, 0 <= k
    <= s * kk -> ((k,) fp32, (k,) ids' dtype): the k smallest distances,
    ties broken by flattened position.  A CUDA tensor launches the kernel;
    a CPU tensor takes the plain version ``ref.topk_merge_ref``."""
    if dists.dim() != 2 or ids.shape != dists.shape \
            or not 0 <= k <= dists.numel():
        raise ValueError(f"topk_merge shapes {tuple(dists.shape)}, "
                         f"{tuple(ids.shape)}, k={k}")
    if dists.dtype != torch.float32 or ids.dtype not in (torch.int32,
                                                         torch.int64):
        raise TypeError("topk_merge takes fp32 distances, int32/int64 ids")
    if dists.device != ids.device:
        raise ValueError("topk_merge operands on different devices")
    if dists.device.type == "cpu":
        return ref.topk_merge_ref(dists, ids, k)
    if dists.device.type != "cuda":
        raise ValueError(f"topk_merge has no kernel for {dists.device}")
    dev = dists.device
    out_d = torch.empty((k,), dtype=torch.float32, device=dev)
    out_i = torch.empty((k,), dtype=ids.dtype, device=dev)
    if k == 0:
        return out_d, out_i
    dists, ids = dists.contiguous(), ids.contiguous()
    c = dists.numel()
    launch = build.launcher("topk_merge", "topk_merge_launch")
    err = launch(dists.data_ptr(), ids.data_ptr(), out_d.data_ptr(),
                 out_i.data_ptr(), c, k, ids.element_size(),
                 _smem_bytes(c, 4, dev),
                 torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "topk_merge")
    launches.add()
    return out_d, out_i
