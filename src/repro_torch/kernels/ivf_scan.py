"""Squared-L2 distance matrix: the hand-written CUDA kernel
(``csrc/ivf_scan.cu``) that replaces the JAX package's Pallas
``ivf_scan``, and its wrapper.

``BLOCK_Q``/``BLOCK_N`` are the host padding contract ``ops.l2_distances``
keeps (queries to 8-row tiles, rows to 512-row blocks, padded with 1e30);
the CUDA launch tiles are named in the source.  The kernel has three
launch paths with the same arithmetic, chosen by ``launch_path``:
``skinny`` for at most ``SKINNY_MAX_Q`` query rows (one thread a row of x,
bound by the bytes of x), and for the rest ``wide`` (128 x 64 register
tiles, bound by fp32 operations) or ``wide-64`` (64 x 64 tiles), whichever
leaves fewer tile rows on the busiest SM.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref

BLOCK_Q = 8          # query rows per tile (host padding contract)
BLOCK_N = 512        # posting vectors per tile (host padding contract)

SKINNY_MAX_Q = 8             # most query rows the skinny path takes
SKINNY_SMEM = 48 * 1024      # most shared memory (its queries) it takes
_K_SLICE = 16                # features per k-slice (csrc kBK)
_TILE_N = 64                 # x rows of a wide tile (csrc kBN)
PATHS = {"wide": 0, "skinny": 1, "wide-64": 2}   # the launcher's codes

launches = build.LaunchCount()


def skinny_smem(nq: int, d: int) -> int:
    """Shared memory of a skinny block: the queries, each padded to a
    multiple of 16 features (``csrc/ivf_scan.cu``'s skinny_smem)."""
    return nq * (-(-d // _K_SLICE) * _K_SLICE) * 4


def launch_path(nq: int, n: int, d: int, sms: int = 132) -> str:
    """The kernel's launch path for ``nq`` queries against ``n`` rows of
    ``d`` features on a card of ``sms`` SMs: ``skinny`` when the queries
    fit it; else the wide tiling (128 or 64 query rows a tile) that leaves
    the busiest SM less work: its tile rows, one tile after another, a
    64-row tile's counted 15 % dearer (it reads shared memory more per
    FMA: 1.14-1.15x the time of 128-row tiles at 16,384 x 512 and 2,048 x
    2,048 on an H100)."""
    if 0 < nq <= SKINNY_MAX_Q and skinny_smem(nq, d) <= SKINNY_SMEM:
        return "skinny"
    cols = -(-n // _TILE_N)

    def load(rows):
        return -(-(-(-nq // rows) * cols) // sms) * rows
    return "wide" if 20 * load(128) <= 23 * load(64) else "wide-64"


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
    path = launch_path(nq, n, d, build.sm_count(q.device))
    launch = build.launcher("ivf_scan")
    err = launch(q.data_ptr(), vecs.data_ptr(), out.data_ptr(), nq, n, d,
                 PATHS[path], SKINNY_SMEM,
                 torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "ivf_scan")
    launches.add()
    return out
