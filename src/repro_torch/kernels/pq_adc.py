"""Single-query PQ asymmetric distance (ADC): the hand-written CUDA kernel
(``csrc/pq_adc.cu``) that replaces the JAX package's Pallas ``pq_adc``,
and its wrapper.

``out[i] = sum_j lut[j, codes[i, j]]`` in fp32, summed over j in order.
``BLOCK_N`` is the host padding contract ``ops.pq_adc_distances`` keeps
(code rows padded to a bucketed multiple of it); the kernel itself walks
rows grid-stride.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref
# the host padding contract: ops pads code rows to a multiple of it
from repro_torch.kernels.fused_scan import BLOCK_N  # noqa: F401
from repro_torch.kernels.quantized_scan import N_CODES

launches = build.LaunchCount()


def pq_adc(codes: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    """codes (n, m) uint8; lut (m, 256) fp32, on one device -> (n,) fp32.
    A CUDA tensor launches the kernel; a CPU tensor takes the plain
    version ``ref.pq_adc_ref``."""
    if codes.dim() != 2 or lut.shape != (codes.shape[1], N_CODES):
        raise ValueError(f"pq_adc shapes codes {tuple(codes.shape)}, lut "
                         f"{tuple(lut.shape)}")
    if codes.dtype != torch.uint8 or lut.dtype != torch.float32:
        raise TypeError("pq_adc takes uint8 codes and an fp32 LUT")
    if codes.device != lut.device:
        raise ValueError("pq_adc operands on different devices")
    limit = build.smem_per_block(lut.device)
    if lut.numel() * 4 > limit:
        raise ValueError(f"pq_adc: an (m={codes.shape[1]}, 256) LUT does "
                         f"not fit the {limit} bytes of shared memory a "
                         f"block may use")
    if codes.device.type == "cpu":
        return ref.pq_adc_ref(codes, lut)
    if codes.device.type != "cuda":
        raise ValueError(f"pq_adc has no kernel for {codes.device}")
    codes, lut = codes.contiguous(), lut.contiguous()
    n, m = codes.shape
    out = torch.empty((n,), dtype=torch.float32, device=codes.device)
    if n == 0:
        return out
    launch = build.launcher("pq_adc")
    err = launch(codes.data_ptr(), lut.data_ptr(), out.data_ptr(), n, m,
                 torch.cuda.current_stream(codes.device).cuda_stream)
    build.check(err, "pq_adc")
    launches.add()
    return out
