"""Fused multi-predicate range filter -> int8 bitmap: the hand-written
CUDA kernel (``csrc/bitmap_filter.cu``) that replaces the JAX package's
Pallas ``bitmap_filter``, and its wrapper.

CUDA rather than Triton: the kernel is a dozen lines of grid-stride loop,
and the ``nvcc`` + ``ctypes`` route builds it in seconds beside the other
two kernels with no second toolchain on the main path.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref

# analysis: allow[kernel/tile-constants] host padding contract of the
# mask-filter tile, kept equal to the JAX package's (int8 rows)
BLOCK_N = 1024

launches = build.LaunchCount()
_BLOCKS_PER_SM = 16         # grid-stride cap


def bitmap_filter(cols: torch.Tensor, bounds: torch.Tensor) -> torch.Tensor:
    """cols (n, c) fp32; bounds (c, 2) fp32 -> (n,) int8 mask (1 where
    every lo <= col <= hi holds).  A CUDA tensor launches the kernel; a
    CPU tensor takes the plain version ``ref.bitmap_filter_ref``."""
    if cols.dim() != 2 or bounds.shape != (cols.shape[1], 2):
        raise ValueError(f"bitmap_filter shapes {tuple(cols.shape)}, "
                         f"{tuple(bounds.shape)}")
    if cols.dtype != torch.float32 or bounds.dtype != torch.float32:
        raise TypeError("bitmap_filter takes fp32 columns and bounds")
    if cols.device != bounds.device:
        raise ValueError("bitmap_filter operands on different devices")
    if cols.device.type == "cpu":
        return ref.bitmap_filter_ref(cols, bounds).to(torch.int8)
    if cols.device.type != "cuda":
        raise ValueError(f"bitmap_filter has no kernel for {cols.device}")
    cols, bounds = cols.contiguous(), bounds.contiguous()
    n, c = cols.shape
    out = torch.empty((n,), dtype=torch.int8, device=cols.device)
    if out.numel() == 0:
        return out
    launch = build.launcher("bitmap_filter")
    err = launch(cols.data_ptr(), bounds.data_ptr(), out.data_ptr(), n, c,
                 build.sm_count(cols.device) * _BLOCKS_PER_SM,
                 torch.cuda.current_stream(cols.device).cuda_stream)
    build.check(err, "bitmap_filter")
    launches.add()
    return out
