"""Fused multi-predicate range filter -> int8 bitmap: the hand-written
CUDA kernels (``csrc/bitmap_filter.cu``) that replace the JAX package's
Pallas ``bitmap_filter``, and their wrappers: ``bitmap_filter`` over a
column tile, and ``bitmap_filter_blocks`` over a list of blocks of a
segment's Z-ordered points held on the card (the spatial index's range
probe, one launch where the reference launches once per block).

CUDA rather than Triton: each kernel is a dozen lines of loop, and the
``nvcc`` + ``ctypes`` route builds them in seconds beside the other
kernels with no second toolchain on the main path.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref

# analysis: allow[kernel/tile-constants] host padding contract of the
# mask-filter tile, kept equal to the JAX package's (int8 rows)
BLOCK_N = 1024

# launches of either entry point: the kernels of csrc/bitmap_filter.cu
launches = build.LaunchCount()
# launches of ``bitmap_filter_blocks`` alone (each also counts above)
blocks_launches = build.LaunchCount()
_BLOCKS_PER_SM = 16         # grid-stride cap


def _check_common(name: str, tensors, cols, bounds) -> None:
    if cols.dim() != 2 or bounds.shape != (cols.shape[1], 2):
        raise ValueError(f"{name} shapes {tuple(cols.shape)}, "
                         f"{tuple(bounds.shape)}")
    if cols.dtype != torch.float32 or bounds.dtype != torch.float32:
        raise TypeError(f"{name} takes fp32 columns and bounds")
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f"{name} operands on different devices")
    if cols.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} has no kernel for {cols.device}")


def bitmap_filter(cols: torch.Tensor, bounds: torch.Tensor) -> torch.Tensor:
    """cols (n, c) fp32; bounds (c, 2) fp32 -> (n,) int8 mask (1 where
    every lo <= col <= hi holds).  A CUDA tensor launches the kernel; a
    CPU tensor takes the plain version ``ref.bitmap_filter_ref``."""
    _check_common("bitmap_filter", (cols, bounds), cols, bounds)
    if cols.device.type == "cpu":
        return ref.bitmap_filter_ref(cols, bounds).to(torch.int8)
    cols, bounds = cols.contiguous(), bounds.contiguous()
    n, c = cols.shape
    out = torch.empty((n,), dtype=torch.int8, device=cols.device)
    if out.numel() == 0:
        return out
    launch = build.launcher("bitmap_filter", "bitmap_filter_launch")
    err = launch(cols.data_ptr(), bounds.data_ptr(), out.data_ptr(), n, c,
                 build.sm_count(cols.device) * _BLOCKS_PER_SM,
                 torch.cuda.current_stream(cols.device).cuda_stream)
    build.check(err, "bitmap_filter")
    launches.add()
    return out


def bitmap_filter_blocks(cols: torch.Tensor, rows: torch.Tensor,
                         blocks: torch.Tensor, bounds: torch.Tensor,
                         n_out: int, block_rows: int) -> torch.Tensor:
    """cols (n, c) fp32 and rows (n,) int32: a segment's points in index
    order and each one's segment row; blocks (nb,) int32 ids of
    ``block_rows``-point blocks; bounds (c, 2) fp32 -> (n_out,) int8 mask,
    1 at rows[i] for every point i of a listed block with every
    lo <= col <= hi.  Block ids outside [0, ceil(n / block_rows)) and row
    ids outside [0, n_out) are skipped.  A CUDA tensor zeroes the mask and
    launches the kernel once for the whole list; a CPU tensor takes the
    plain version ``ref.bitmap_filter_blocks_ref``."""
    _check_common("bitmap_filter_blocks", (cols, rows, blocks, bounds),
                  cols, bounds)
    if rows.shape != (cols.shape[0],) or blocks.dim() != 1:
        raise ValueError(f"bitmap_filter_blocks shapes rows "
                         f"{tuple(rows.shape)}, blocks {tuple(blocks.shape)}"
                         f" for {cols.shape[0]} points")
    if rows.dtype != torch.int32 or blocks.dtype != torch.int32:
        raise TypeError("bitmap_filter_blocks takes int32 rows and blocks")
    if block_rows <= 0 or n_out < 0:
        raise ValueError(f"bitmap_filter_blocks block_rows {block_rows}, "
                         f"n_out {n_out}")
    if cols.device.type == "cpu":
        return ref.bitmap_filter_blocks_ref(cols, rows, blocks, bounds, n_out,
                                            block_rows).to(torch.int8)
    cols, rows, blocks, bounds = (t.contiguous() for t in
                                  (cols, rows, blocks, bounds))
    n, c = cols.shape
    out = torch.zeros((n_out,), dtype=torch.int8, device=cols.device)
    if n == 0 or n_out == 0 or blocks.numel() == 0:
        return out
    launch = build.launcher("bitmap_filter", "bitmap_filter_blocks_launch")
    err = launch(cols.data_ptr(), rows.data_ptr(), blocks.data_ptr(),
                 bounds.data_ptr(), out.data_ptr(), n, blocks.numel(), c,
                 block_rows, n_out,
                 build.sm_count(cols.device) * _BLOCKS_PER_SM,
                 torch.cuda.current_stream(cols.device).cuda_stream)
    build.check(err, "bitmap_filter_blocks")
    launches.add()
    blocks_launches.add()
    return out
