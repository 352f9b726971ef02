"""Squared-L2 distance matrix: the hand-written CUDA kernel
(``csrc/ivf_scan.cu``) that replaces the JAX package's Pallas
``ivf_scan``, and its wrapper.

``BLOCK_Q``/``BLOCK_N`` are the host padding contract ``ops.l2_distances``
keeps (queries to 8-row tiles, rows to 512-row blocks, padded with 1e30);
the CUDA launch tiles are named in the source.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref

BLOCK_Q = 8          # query rows per tile (host padding contract)
BLOCK_N = 512        # posting vectors per tile (host padding contract)

launches = build.LaunchCount()


def ivf_scan(q: torch.Tensor, vecs: torch.Tensor) -> torch.Tensor:
    """q (nq, d), vecs (n, d) fp32 on one device -> (nq, n) fp32 squared-L2
    distances.  A CUDA tensor launches the kernel; a CPU tensor takes the
    plain version ``ref.ivf_scan_ref``."""
    if q.dim() != 2 or vecs.dim() != 2 or q.shape[1] != vecs.shape[1]:
        raise ValueError(f"ivf_scan shapes {tuple(q.shape)} x "
                         f"{tuple(vecs.shape)}")
    if q.dtype != torch.float32 or vecs.dtype != torch.float32:
        raise TypeError("ivf_scan takes fp32 operands")
    if q.device != vecs.device:
        raise ValueError("ivf_scan operands on different devices")
    if q.device.type == "cpu":
        return ref.ivf_scan_ref(q, vecs)
    if q.device.type != "cuda":
        raise ValueError(f"ivf_scan has no kernel for {q.device}")
    q, vecs = q.contiguous(), vecs.contiguous()
    nq, d = q.shape
    n = vecs.shape[0]
    out = torch.empty((nq, n), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out
    launch = build.launcher("ivf_scan")
    err = launch(q.data_ptr(), vecs.data_ptr(), out.data_ptr(), nq, n, d,
                 torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "ivf_scan")
    launches.add()
    return out
