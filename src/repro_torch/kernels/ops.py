"""Device dispatch for the main path's kernels, with numpy-friendly padding.

Every op takes a ``device`` and defaults to the card:
  * ``cuda`` — mirrors the JAX package's Pallas branch: every non-empty
               call pads as that branch does and launches the hand-written
               CUDA kernel (``kernels/csrc``), with no host shortcut;
  * ``cpu``  — mirrors the JAX package's default backend: host numpy below
               ``HOST_FLOP_CUTOFF`` (bitwise the same arithmetic) and the
               plain PyTorch version (``ref.py``) above it.
With no card and no ``device="cpu"`` the ops raise; they never carry on
quietly on the CPU.  Dispatch accounting (launches, bytes handed back to
the host, shape-cache misses) is charged exactly as the JAX package
charges it, so ``ExecStats`` compare one to one.

The host-side engine calls these for all per-segment compute: distance
scans, PQ ADC, predicate bitmaps, the fused exact and quantized scan ->
top-k, the graph beam search and the top-k merges.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Tuple, Union

import numpy as np
import torch

from repro_torch.kernels import bitmap_filter as bf_kernel
from repro_torch.kernels import fused_scan as fs_kernel
from repro_torch.kernels import graph_search as gs_kernel
from repro_torch.kernels import ivf_scan as ivf_kernel
from repro_torch.kernels import pq_adc as pq_kernel
from repro_torch.kernels import quantized_scan as qs_kernel
from repro_torch.kernels import ref
from repro_torch.kernels import topk_merge as tk_kernel
from repro_torch.obs import REGISTRY

Device = Union[str, torch.device]


def resolve_device(device: Device = "cuda") -> torch.device:
    """The ``torch.device`` an entry point runs on.  Raises when the card
    is asked for (the default) and none is present."""
    dev = torch.device(device)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the host")
    return dev


# ---------------------------------------------------------------------------
# dispatch accounting
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class KernelStats:
    """Per-THREAD dispatch counters (monotonic; consumers diff
    ``stats_snapshot()`` values around a region of interest).  Thread-
    local so a background flush/compaction worker's index-build kernel
    dispatches are never attributed to the query thread it races.

    launches       — op dispatches.  The host numpy fast path under
                     ``HOST_FLOP_CUTOFF`` counts too: at production scale
                     the cutoff vanishes and every dispatch is a device
                     launch, so ratios stay machine-independent.
    bytes_to_host  — bytes of results handed back to the host engine
                     (device->host traffic when a device backend is
                     active).  Operand upload is not counted.
    shape_misses   — first sighting of a (op, bucketed shape) pair, i.e.
                     compile-cache misses caused by ``_bucket``-padded
                     ragged inputs in the JAX package (the shape-cache
                     itself is process-wide).
    """
    launches: int = 0
    bytes_to_host: int = 0
    shape_misses: int = 0
    # high-water marks already published to the metrics registry; the
    # per-dispatch mirror batches (see flush_registry_counters) so the
    # hot path pays an int compare instead of a Counter lock
    reg_launches: int = 0
    reg_bytes: int = 0
    reg_misses: int = 0


_tls = threading.local()
_seen_shapes: set = set()
# the shape cache is process-global while the counters are per-thread;
# guard membership+insert so concurrent first-seens from a query thread
# and the flush worker don't corrupt the set
_seen_lock = threading.Lock()


def thread_stats() -> KernelStats:
    """The calling thread's dispatch counters."""
    stats = getattr(_tls, "stats", None)
    if stats is None:
        stats = _tls.stats = KernelStats()
    return stats


def stats_snapshot() -> Tuple[int, int, int]:
    s = thread_stats()
    return (s.launches, s.bytes_to_host, s.shape_misses)


_reg_counters = None
_reg_generation = -1


def _registry_counters():
    """Process-wide mirrors of the per-thread counters in the metrics
    registry.  Object refs are cached (re-fetched only when
    ``REGISTRY.reset()`` bumps its generation), so the per-dispatch
    cost is an int compare plus three ``Counter.inc`` calls."""
    global _reg_counters, _reg_generation
    if _reg_counters is None or _reg_generation != REGISTRY.generation:
        _reg_generation = REGISTRY.generation
        _reg_counters = (REGISTRY.counter("kernels.launches"),
                         REGISTRY.counter("kernels.bytes_to_host"),
                         REGISTRY.counter("kernels.jit_shape_misses"))
    return _reg_counters


REG_FLUSH_EVERY = 64    # dispatches between registry-mirror flushes


def flush_registry_counters() -> None:
    """Publish the calling thread's pending dispatch deltas to the
    metrics registry.  Runs every ``REG_FLUSH_EVERY`` dispatches and at
    query-batch boundaries (``Executor._observe_query``), keeping the
    registry's Counter lock off the per-dispatch path."""
    s = thread_stats()
    launches, byts, misses = _registry_counters()
    if s.launches != s.reg_launches:
        launches.inc(s.launches - s.reg_launches)
        s.reg_launches = s.launches
    if s.bytes_to_host != s.reg_bytes:
        byts.inc(s.bytes_to_host - s.reg_bytes)
        s.reg_bytes = s.bytes_to_host
    if s.shape_misses != s.reg_misses:
        misses.inc(s.shape_misses - s.reg_misses)
        s.reg_misses = s.shape_misses


def _dispatched(out_bytes: int, tag: str = None, shape: Tuple = (),
                count: int = 1) -> None:
    """Record ``count`` op dispatches of ``out_bytes`` in all; with a
    ``tag`` also track the shape cache (host-path calls pass no tag —
    numpy has no shape cache)."""
    if count == 0:
        return
    s = thread_stats()
    s.launches += count
    s.bytes_to_host += int(out_bytes)
    if s.launches - s.reg_launches >= REG_FLUSH_EVERY:
        flush_registry_counters()
    if tag is not None:
        key = (tag,) + tuple(shape)
        with _seen_lock:
            fresh = key not in _seen_shapes
            if fresh:
                _seen_shapes.add(key)
        if fresh:
            s.shape_misses += 1


def _pad_to(x: np.ndarray, mult: int, axis: int, value=0.0) -> np.ndarray:
    n = x.shape[axis]
    pad = (-n) % mult
    if pad == 0:
        return x
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, pad)
    return np.pad(x, widths, constant_values=value)


def _bucket(n: int, floor: int = 128) -> int:
    """Round up to the next power-of-two bucket (>= floor): bounds the
    number of distinct shapes from ragged posting lists to O(log n)."""
    b = floor
    while b < n:
        b *= 2
    return b


def _pad_bucket(x: np.ndarray, axis: int, value=0.0,
                floor: int = 128) -> np.ndarray:
    n = x.shape[axis]
    b = _bucket(n, floor)
    if b == n:
        return x
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, b - n)
    return np.pad(x, widths, constant_values=value)


def _pad_codes(codes: np.ndarray, block: int,
               bucket: bool = True) -> np.ndarray:
    """THE one place PQ code matrices get padded for device dispatch: row
    pad to a ``block`` multiple (code 0 in the pad rows — masked or sliced
    off by every consumer), optionally bucket-padded to a power of two.
    Shared by both ``pq_adc_distances`` paths so ``stats_snapshot()``
    charges code-block padding identically whichever ran.  Codes stay
    uint8: the kernels read m bytes a row."""
    cp = _pad_to(np.asarray(codes, np.uint8), block, 0)
    return _pad_bucket(cp, 0, floor=block) if bucket else cp


def _on(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """Upload a host array (a CPU device shares its memory)."""
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


def _host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


# ---------------------------------------------------------------------------
# distance scans
# ---------------------------------------------------------------------------

# Below this many MACs the JAX package's default backend runs the op on the
# host; the CPU device keeps that rule (it fixes the rounding the bitwise
# fused-vs-staged contracts rest on).  The card has no such shortcut.
HOST_FLOP_CUTOFF = 4_000_000


def _l2_host(q: np.ndarray, x: np.ndarray) -> np.ndarray:
    """Host numpy squared-L2 with BATCH-SHAPE-INDEPENDENT rounding.

    The difference form ``((x - q)**2).sum(-1)`` computes every output
    element from exactly its own (q_i, x_j) pair — numpy pairwise-sums
    the d axis per element — so a row's distance is bitwise identical
    whatever it is batched with.  The BLAS-backed ``qn - 2 q@x.T + xn``
    expansion does NOT have this property: gemm picks differently-rounded
    micro-kernels by operand shape and row position, so the same row
    scored in two batch layouts could differ by ~1 ulp.  That invariant is
    what makes fused-vs-staged, NRA-refinement-vs-scan results bitwise
    comparable — and the difference form also never goes negative (no
    cancellation).  Only used below HOST_FLOP_CUTOFF, so the (nq, n, d)
    temporary is bounded at ~16 MB."""
    diff = x[None, :, :] - q[:, None, :]
    return (diff * diff).sum(axis=-1)


def l2_distances(q: np.ndarray, x: np.ndarray,
                 device: Device = "cuda") -> np.ndarray:
    """Squared L2: q (nq, d), x (n, d) -> (nq, n) fp32."""
    dev = resolve_device(device)
    q = np.asarray(q, np.float32)
    x = np.asarray(x, np.float32)
    if len(x) == 0:
        return np.zeros((len(q), 0), np.float32)
    if dev.type == "cuda":
        return _l2_kernel(q, x, dev)
    if q.shape[0] * x.shape[0] * x.shape[1] < HOST_FLOP_CUTOFF:
        out = _l2_host(q, x)
        _dispatched(out.nbytes)
        return out
    qp = _pad_bucket(q, 0, floor=8)
    xp = _pad_bucket(x, 0)
    out = ref.ivf_scan_ref(torch.from_numpy(qp), torch.from_numpy(xp)).numpy()
    _dispatched(out.nbytes, "ivf_scan.ref", qp.shape + xp.shape)
    return out[:len(q), :len(x)]


def _l2_kernel(q: np.ndarray, x: np.ndarray, dev: torch.device
               ) -> np.ndarray:
    """The card's path (the JAX package's Pallas branch): pad queries to
    BLOCK_Q rows and x to a bucketed BLOCK_N multiple with 1e30 rows, one
    kernel launch.  On a CPU ``dev`` the wrapper takes its plain version,
    which is how the CPU tests reach this host-side logic."""
    qp = _pad_to(q, ivf_kernel.BLOCK_Q, 0)
    xp = _pad_bucket(_pad_to(x, ivf_kernel.BLOCK_N, 0, value=1e30),
                     0, value=1e30, floor=ivf_kernel.BLOCK_N)
    out = _host(ivf_kernel.ivf_scan(_on(qp, dev), _on(xp, dev)))
    _dispatched(out.nbytes, "ivf_scan.cuda", qp.shape + xp.shape)
    return out[:len(q), :len(x)]


def assign_nearest(x: np.ndarray, centroids: np.ndarray,
                   chunk: int = 16384, device: Device = "cuda") -> np.ndarray:
    """argmin over centroids per row (chunked for memory)."""
    out = np.empty(len(x), np.int64)
    for i in range(0, len(x), chunk):
        d = l2_distances(x[i:i + chunk], centroids, device=device)
        out[i:i + chunk] = np.argmin(d, axis=1)
    return out


def block_topk(q: np.ndarray, vecs: np.ndarray, k: int,
               device: Device = "cuda") -> Tuple[np.ndarray, np.ndarray]:
    """Top-k nearest of q among vecs -> (dists sorted, indices)."""
    d = l2_distances(q[None, :], vecs, device=device)[0]
    k = min(k, len(d))
    idx = np.argpartition(d, k - 1)[:k]
    # (score, row) comparator: ties break by row index, deterministic
    # regardless of argpartition's arbitrary intra-tie order
    order = np.lexsort((idx, d[idx]))
    return d[idx][order], idx[order]


# ---------------------------------------------------------------------------
# PQ ADC
# ---------------------------------------------------------------------------

def pq_adc_distances(q: np.ndarray, codes: np.ndarray,
                     codebooks: np.ndarray,
                     device: Device = "cuda") -> np.ndarray:
    """q (d,); codes (n, m) uint8; codebooks (m, 256, dsub) -> (n,) fp32."""
    dev = resolve_device(device)
    m, n_codes, dsub = codebooks.shape
    qs = q.reshape(m, dsub)
    # LUT: distance from q's subvector to every codeword (host numpy, as
    # the JAX package computes it: a torch reduction over dsub would sum
    # in another order)
    lut = ((codebooks - qs[:, None, :]) ** 2).sum(axis=2)   # (m, 256)
    if len(codes) == 0:
        return np.zeros((0,), np.float32)
    if dev.type == "cuda":
        return _pq_adc_kernel(codes, lut, dev)
    if codes.size < HOST_FLOP_CUTOFF:
        out = np.take_along_axis(
            lut.T, codes.astype(np.int64), axis=0).sum(axis=1) \
            .astype(np.float32)
        _dispatched(out.nbytes)
        return out
    cp = _pad_codes(codes, pq_kernel.BLOCK_N)
    out = ref.pq_adc_ref(torch.from_numpy(cp),
                         torch.from_numpy(np.asarray(lut, np.float32))
                         ).numpy()
    _dispatched(out.nbytes, "pq_adc.ref", cp.shape)
    return out[:len(codes)]


def _pq_adc_kernel(codes: np.ndarray, lut: np.ndarray, dev: torch.device
                   ) -> np.ndarray:
    """The card's path (the JAX package's Pallas branch): the code matrix
    padded as ``_pad_codes`` pads it, one kernel launch (the plain version
    on a CPU ``dev``)."""
    cp = _pad_codes(codes, pq_kernel.BLOCK_N)
    out = _host(pq_kernel.pq_adc(_on(cp, dev),
                                 _on(np.asarray(lut, np.float32), dev)))
    _dispatched(out.nbytes, "pq_adc.cuda", cp.shape)
    return out[:len(codes)]


# ---------------------------------------------------------------------------
# predicate bitmaps
# ---------------------------------------------------------------------------

def range_bitmap(cols: np.ndarray, bounds: np.ndarray,
                 device: Device = "cuda") -> np.ndarray:
    """cols (n, c) fp32; bounds (c, 2) -> (n,) bool (AND of range preds)."""
    dev = resolve_device(device)
    cols = np.asarray(cols, np.float32)
    bounds = np.asarray(bounds, np.float32)
    if len(cols) == 0:
        return np.zeros((0,), bool)
    if dev.type == "cuda":
        return _bitmap_kernel(cols, bounds, dev)
    if cols.size < HOST_FLOP_CUTOFF:
        out = np.all((cols >= bounds[:, 0][None])
                     & (cols <= bounds[:, 1][None]), axis=1)
        _dispatched(out.nbytes)
        return out
    cp = _pad_bucket(cols, 0, value=np.inf)
    out = ref.bitmap_filter_ref(torch.from_numpy(cp),
                                torch.from_numpy(bounds)).numpy()
    _dispatched(out.nbytes, "bitmap.ref", cp.shape)
    return out[:len(cols)]


def _bitmap_kernel(cols: np.ndarray, bounds: np.ndarray, dev: torch.device
                   ) -> np.ndarray:
    """The card's path: pad rows to a bucketed BLOCK_N multiple with +inf,
    one kernel launch (the plain version on a CPU ``dev``)."""
    cp = _pad_bucket(_pad_to(cols, bf_kernel.BLOCK_N, 0, value=np.inf),
                     0, value=np.inf, floor=bf_kernel.BLOCK_N)
    out = _host(bf_kernel.bitmap_filter(_on(cp, dev), _on(bounds, dev)))
    _dispatched(out.nbytes, "bitmap.cuda", cp.shape)
    return out[:len(cols)].astype(bool)


def _rect_bounds(rect) -> np.ndarray:
    """rect (xmin, ymin, xmax, ymax) -> fp32 bounds (2, 2) [lo, hi]."""
    r = np.asarray(rect, np.float32)
    return np.stack([[r[0], r[2]], [r[1], r[3]]])


def rect_filter(points: np.ndarray, rect,
                device: Device = "cuda") -> np.ndarray:
    """points (n, 2); rect (xmin, ymin, xmax, ymax) -> (n,) bool."""
    return range_bitmap(np.asarray(points, np.float32), _rect_bounds(rect),
                        device=device)


def rect_filter_blocks(points: torch.Tensor, rows: torch.Tensor,
                       blocks: np.ndarray, rect, n_rows: int,
                       block_rows: int, device: Device = "cuda"
                       ) -> np.ndarray:
    """The spatial index's range probe: points (n, 2) fp32 and rows (n,)
    int32, a segment's Z-ordered points and each one's segment row, held
    on ``device``; blocks (nb,) the ``block_rows``-point blocks whose zone
    maps overlap rect -> host (n_rows,) bool over segment rows, True where
    a listed point lies inside rect (inclusive; NaN fails).  On the card
    one kernel launch for the whole list (``bitmap_filter_blocks``), on
    the CPU its plain version.

    Accounting, the stated exception to one dispatch per device launch:
    ``ExecStats`` count the reference's dispatches, and the JAX package's
    ``ZOrderIndex.bitmap`` calls ``rect_filter`` once per listed block.  So
    this op charges, for each listed block, what ``range_bitmap`` charges
    for that block on the same device: on the CPU one dispatch of the
    block's row count in bytes and no shape tag (the host numpy path); on
    the card one dispatch of BLOCK_N bytes under the ("bitmap.cuda",
    BLOCK_N, 2) shape key (the Pallas branch's padding).  The card's own
    launches are counted in ``bitmap_filter.launches``."""
    dev = resolve_device(device)
    blocks = np.asarray(blocks, np.int64)
    if dev.type == "cuda":
        return _rect_blocks_kernel(points, rows, blocks, rect, n_rows,
                                   block_rows, dev)
    mask = _rect_blocks(points, rows, blocks, rect, n_rows, block_rows, dev)
    n = points.shape[0]
    block_bytes = np.minimum(n - blocks * block_rows, block_rows)
    _dispatched(int(block_bytes.sum()), count=len(blocks))
    return mask


def _rect_blocks_kernel(points: torch.Tensor, rows: torch.Tensor,
                        blocks: np.ndarray, rect, n_rows: int,
                        block_rows: int, dev: torch.device) -> np.ndarray:
    """The card's path: one ``bitmap_filter_blocks`` launch (the plain
    version on a CPU ``dev``), charged as the Pallas branch charges one
    ``range_bitmap`` call per listed block."""
    mask = _rect_blocks(points, rows, blocks, rect, n_rows, block_rows, dev)
    _dispatched(len(blocks) * bf_kernel.BLOCK_N, "bitmap.cuda",
                (bf_kernel.BLOCK_N, 2), count=len(blocks))
    return mask


def _rect_blocks(points: torch.Tensor, rows: torch.Tensor,
                 blocks: np.ndarray, rect, n_rows: int, block_rows: int,
                 dev: torch.device) -> np.ndarray:
    """Upload the block list and the bounds, run ``bitmap_filter_blocks``
    and bring the mask back to the host."""
    if not len(blocks):
        return np.zeros(n_rows, bool)
    out = bf_kernel.bitmap_filter_blocks(
        points, rows, _on(blocks.astype(np.int32), dev), _on(
            _rect_bounds(rect), dev), n_rows, block_rows)
    return _host(out).view(bool)


# ---------------------------------------------------------------------------
# fused masked scan -> top-k (packed cross-segment path)
# ---------------------------------------------------------------------------

def _packed_pks(pks, n: int, dev: torch.device) -> torch.Tensor:
    """Packed pks as an int32 device tensor with rows padded to a BLOCK_N
    multiple (SENTINEL pks); a tensor (a pack's) is taken as it is."""
    if isinstance(pks, torch.Tensor):
        return pks.to(dev)
    rows = -(-n // fs_kernel.BLOCK_N) * fs_kernel.BLOCK_N
    pkp = np.full(rows, int(fs_kernel.SENTINEL), np.int64)
    pkp[:n] = np.asarray(pks, np.int64)[:n]
    return _on(pkp.astype(np.int32), dev)


def _as_packed(x, pks, n: int, dev: torch.device
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The packed column as device tensors with rows padded to a BLOCK_N
    multiple (zero rows, SENTINEL pks).  ``core.segment.pack_segments``
    already holds them so on the store's device; host arrays (tests) are
    uploaded here."""
    if isinstance(x, torch.Tensor):
        return x.to(dev), _packed_pks(pks, n, dev)
    rows = -(-n // fs_kernel.BLOCK_N) * fs_kernel.BLOCK_N
    xp = np.zeros((rows, np.shape(x)[1]), np.float32)
    xp[:n] = np.asarray(x, np.float32)[:n]
    return _on(xp, dev), _packed_pks(pks, n, dev)


def _as_host(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def fused_scan_topk(q: np.ndarray, x, mask: np.ndarray, pks, k: int,
                    device: Device = "cuda"
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Fused filter-aware scan -> per-query top-k over a packed matrix.

    q (nq, d) queries; x (>= n, d) packed vectors (all visible segments
    concatenated; rows past n are padding); mask (nq, n) bool predicate
    bitmap; pks (>= n,) primary keys (< 2^31: the device tie-break key).
    ``x`` and ``pks`` may be host arrays or the tensors ``pack_segments``
    keeps on the store's device.  Returns (d2 (nq, k) fp32 squared-L2
    ascending, rows (nq, k) int64 row indices into ``x``; -1 marks slots
    beyond the query's candidate count).  Ties break by (distance, pk) —
    the host merge's lexsort comparator.

    On the CPU this SIMULATES the fused kernel as the JAX package's default
    backend does: the staged path's distance arithmetic at this size
    (numpy below ``HOST_FLOP_CUTOFF``, the plain PyTorch scan above) and
    the host merge's (sqrt-distance, pk) comparator exactly, so fused and
    staged results are bitwise equal.  On the card the kernel compares
    squared distances (a monotone transform — same rows except where f32
    sqrt rounds two distinct squared distances together).

    ONE dispatch for the whole batch, whatever the segment or predicate
    count.  Host-side prep on the card: rows are tiled into BLOCK_N
    blocks; the ids of blocks some query admits go to the kernel, which
    reads the device-resident column through them (no compacted copy of
    ``x``), with a per-(query-tile, kept block) occupancy grid so it skips
    tiles that are empty for a query tile.
    """
    dev = resolve_device(device)
    q = np.asarray(q, np.float32)
    mask = np.ascontiguousarray(mask, bool)
    nq, n = mask.shape
    k = int(min(k, fs_kernel.KMAX))
    empty = (np.full((nq, k), np.inf, np.float32),
             np.full((nq, k), -1, np.int64))
    if n == 0 or k == 0 or not mask.any():
        return empty
    if dev.type == "cpu":
        # simulated fused kernel: ONE counted dispatch, with the exact
        # arithmetic the staged path uses at this size and the host
        # merge's (score, pk) comparator
        xh = np.asarray(_as_host(x)[:n], np.float32)
        if q.shape[0] * n * xh.shape[1] < HOST_FLOP_CUTOFF:
            d2 = _l2_host(q, xh)
            shape_tag = None
        else:
            qp = _pad_bucket(q, 0, floor=8)
            xp = _pad_bucket(xh, 0)
            d2 = ref.ivf_scan_ref(torch.from_numpy(qp), torch.from_numpy(xp)
                                  ).numpy()[:nq, :n]
            shape_tag = qp.shape + xp.shape
        s = np.where(mask, np.sqrt(np.maximum(d2, 0),
                                   dtype=np.float32), np.inf)
        pks64 = np.asarray(_as_host(pks)[:n], np.int64)
        out_d = np.full((nq, k), np.inf, np.float32)
        out_r = np.full((nq, k), -1, np.int64)
        for qi in range(nq):
            order = np.lexsort((pks64, s[qi]))[:k]
            order = order[np.isfinite(s[qi][order])]
            out_d[qi, :len(order)] = d2[qi][order]
            out_r[qi, :len(order)] = order
        _dispatched(out_d.nbytes + out_r.nbytes,
                    None if shape_tag is None else "fused_scan.ref",
                    shape_tag or ())
        return out_d, out_r
    return _fused_kernel(q, x, mask, pks, k, dev)


def _blocks_and_bitmap(mask: np.ndarray, dev: torch.device):
    """The host prep both packed kernels share: the ids of the BLOCK_N-row
    blocks some query admits (host), the per-(query tile, kept block)
    occupancy grid and the bitmap with queries padded to BLOCK_Q tiles
    (both on ``dev``)."""
    nq, n = mask.shape
    BQ, BN = fs_kernel.BLOCK_Q, fs_kernel.BLOCK_N
    blk = np.logical_or.reduceat(mask, np.arange(0, n, BN), axis=1)
    keep = np.nonzero(blk.any(axis=0))[0]
    nq_p = -(-nq // BQ) * BQ
    occ = _pad_to(blk[:, keep], BQ, 0, value=False) \
        .reshape(nq_p // BQ, BQ, len(keep)).any(axis=1).astype(np.int32)
    mt = torch.zeros((nq_p, n), dtype=torch.uint8, device=dev)
    mt[:nq] = _on(mask.view(np.uint8), dev)
    return keep, _on(keep.astype(np.int32), dev), _on(occ, dev), mt


def _kept_rows(idx: np.ndarray, keep: np.ndarray) -> np.ndarray:
    """Kernel row ids (kept-block positions) -> rows of the packed matrix,
    SENTINEL slots -> -1, as the JAX package's Pallas branch maps them."""
    BN = fs_kernel.BLOCK_N
    safe = np.minimum(idx, len(keep) * BN - 1)
    rows = keep[safe // BN] * BN + safe % BN
    return np.where(idx == int(fs_kernel.SENTINEL), -1, rows
                    ).astype(np.int64)


def fused_kernel_args(q: np.ndarray, x, mask: np.ndarray, pks,
                      dev: torch.device):
    """The packed kernel's inputs on ``dev`` for one batch, and the kept
    block ids on the host: queries padded to BLOCK_Q tiles, the bitmap
    (rows padded with zeros), the packed column and pks, the ids of the
    blocks some query admits, and the per-(query tile, kept block)
    occupancy grid."""
    xt, pkt = _as_packed(x, pks, mask.shape[1], dev)
    keep, keep_t, occ_t, mt = _blocks_and_bitmap(mask, dev)
    return (_on(_pad_to(q, fs_kernel.BLOCK_Q, 0), dev), xt, mt, pkt,
            keep_t, occ_t), keep


def _fused_kernel(q: np.ndarray, x, mask: np.ndarray, pks, k: int,
                  dev: torch.device) -> Tuple[np.ndarray, np.ndarray]:
    """The card's path (the JAX package's Pallas branch, without its host
    compaction): kept block ids + occupancy grid + the bitmap go up, one
    kernel launch reads the device-resident column through the ids, and
    (nq, KMAX) results come back (the plain version on a CPU ``dev``)."""
    nq = len(mask)
    BN = fs_kernel.BLOCK_N
    args, keep = fused_kernel_args(q, x, mask, pks, dev)
    d2, _, idx = fs_kernel.fused_scan_topk(*args)
    d2, idx = _host(d2), _host(idx)
    # the JAX package's Pallas branch compacts kept blocks into a
    # power-of-two bucket: its shape key is kept so the cache accounting
    # matches
    nb_pad = _bucket(len(keep), floor=1)
    _dispatched(d2.nbytes + 2 * idx.nbytes, "fused_scan.cuda",
                tuple(args[0].shape) + (nb_pad * BN, args[1].shape[1]))
    # map kept-block row ids back to rows of the caller's x
    return d2[:nq, :k], _kept_rows(idx[:nq, :k], keep)


# ---------------------------------------------------------------------------
# fused quantized (PQ ADC) scan -> top-k' (candidate generation)
# ---------------------------------------------------------------------------

def adc_lut(q: np.ndarray, codebooks: np.ndarray) -> np.ndarray:
    """Per-query ADC tables: q (nq, d); codebooks (m, 256, dsub) ->
    (nq, m, 256) fp32 with lut[q, j, c] = ||q_sub_j - codebook_j[c]||^2.
    Computed once per launch in host numpy, as the JAX package computes
    it (a torch reduction over dsub would sum in another order and move
    ADC values, and with them survivor sets at ties, by an ulp)."""
    nq, d = q.shape
    m, _, dsub = codebooks.shape
    qs = np.asarray(q, np.float32).reshape(nq, m, dsub)
    diff = codebooks[None, :, :, :] - qs[:, :, None, :]
    return (diff * diff).sum(axis=3).astype(np.float32)


def _as_packed_codes(codes, pks, n: int, dev: torch.device
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The packed codes and pks as device tensors with rows padded to a
    BLOCK_N multiple (code 0, SENTINEL pks).  ``core.segment``'s packs
    already hold them so on the store's device; host arrays (tests) are
    uploaded here."""
    ct = codes.to(dev) if isinstance(codes, torch.Tensor) else _on(
        _pad_codes(np.asarray(codes)[:n], fs_kernel.BLOCK_N, bucket=False),
        dev)
    return ct, _packed_pks(pks, n, dev)


def quantized_scan_topk(q: np.ndarray, codes, codebooks: np.ndarray,
                        mask: np.ndarray, pks, k: int,
                        device: Device = "cuda"
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Fused PQ-ADC candidate generation over a packed code matrix.

    q (nq, d) queries; codes (>= n, m) uint8 packed PQ codes (row-aligned
    with the fp32 superbatch; rows past n are padding); codebooks
    (m, 256, dsub) shared books; mask (nq, n) bool; pks (>= n,) primary
    keys.  ``codes`` and ``pks`` may be host arrays or the tensors
    ``core.segment``'s packs keep on the store's device.  Returns (adc
    (nq, k) fp32 ADC distances ascending, rows (nq, k) int64 row indices
    into the packed matrix; -1 beyond a query's candidate count).  Ties
    break by (adc, pk) so survivor sets are deterministic.

    ADC distances are approximate: callers re-rank the survivors exactly
    via ``fused_scan_topk`` with the survivor mask.

    On the CPU this SIMULATES the fused kernel as the JAX package's
    default backend does (host numpy gather in j order, one counted
    dispatch).  On the card the host prep mirrors ``fused_scan_topk``: the
    ids of the blocks some query admits and the occupancy grid go up, one
    kernel launch reads the device-resident codes through the ids (m
    bytes a row instead of 4*d)."""
    dev = resolve_device(device)
    q = np.asarray(q, np.float32)
    mask = np.ascontiguousarray(mask, bool)
    nq, n = mask.shape
    k = int(min(k, fs_kernel.KMAX))
    empty = (np.full((nq, k), np.inf, np.float32),
             np.full((nq, k), -1, np.int64))
    if n == 0 or k == 0 or not mask.any():
        return empty
    lut = adc_lut(q, codebooks)                     # (nq, m, 256)
    if dev.type == "cuda":
        return _quantized_kernel(lut, codes, mask, pks, k, dev)
    # simulated fused ADC kernel: ONE counted dispatch; same gather
    # arithmetic and (adc, pk) comparator as the device kernel
    codes64 = np.asarray(_as_host(codes)[:n]).astype(np.int64)
    adc = np.zeros((nq, n), np.float32)
    for j in range(codes64.shape[1]):
        adc += lut[:, j, :][:, codes64[:, j]]
    s = np.where(mask, adc, np.inf)
    pks64 = np.asarray(_as_host(pks)[:n], np.int64)
    out_d = np.full((nq, k), np.inf, np.float32)
    out_r = np.full((nq, k), -1, np.int64)
    for qi in range(nq):
        order = np.lexsort((pks64, s[qi]))[:k]
        order = order[np.isfinite(s[qi][order])]
        out_d[qi, :len(order)] = s[qi][order]
        out_r[qi, :len(order)] = order
    _dispatched(out_d.nbytes + out_r.nbytes)
    return out_d, out_r


def quantized_kernel_args(lut: np.ndarray, codes, mask: np.ndarray, pks,
                          dev: torch.device):
    """The quantized kernel's inputs on ``dev`` for one batch, and the kept
    block ids on the host: the LUTs flattened to (nq, m * 256) and padded
    to BLOCK_Q tiles, the packed codes and pks, the bitmap, the kept block
    ids and the occupancy grid (``fused_kernel_args``' prep over codes)."""
    nq, m, _ = lut.shape
    ct, pkt = _as_packed_codes(codes, pks, mask.shape[1], dev)
    keep, keep_t, occ_t, mt = _blocks_and_bitmap(mask, dev)
    lutf = _pad_to(lut.reshape(nq, m * qs_kernel.N_CODES),
                   fs_kernel.BLOCK_Q, 0)
    return (_on(lutf, dev), ct, mt, pkt, keep_t, occ_t), keep


def _quantized_kernel(lut: np.ndarray, codes, mask: np.ndarray, pks,
                      k: int, dev: torch.device
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """The card's path (the JAX package's Pallas branch, without its host
    compaction): one kernel launch over the device-resident codes, (nq,
    KMAX) results back (the plain version on a CPU ``dev``).  Nothing
    admitted: nothing dispatched, as in the Pallas branch."""
    nq = len(mask)
    if not mask.any():
        return (np.full((nq, k), np.inf, np.float32),
                np.full((nq, k), -1, np.int64))
    args, keep = quantized_kernel_args(lut, codes, mask, pks, dev)
    adc, _, idx = qs_kernel.quantized_scan_topk(*args)
    adc, idx = _host(adc), _host(idx)
    # the Pallas branch's shape key: the padded LUTs and the kept blocks
    # compacted into a power-of-two bucket
    nb_pad = _bucket(len(keep), floor=1)
    _dispatched(adc.nbytes + 2 * idx.nbytes, "quantized_scan.cuda",
                tuple(args[0].shape) + (nb_pad * fs_kernel.BLOCK_N,
                                        args[1].shape[1]))
    return adc[:nq, :k], _kept_rows(idx[:nq, :k], keep)


# ---------------------------------------------------------------------------
# graph beam search -> top-beam (candidate generation)
# ---------------------------------------------------------------------------

def _graph_host(q, x, nbr, ent, mask, pks64, beam, hops):
    """Host numpy beam search: same hop/dedup/comparator structure as the
    kernel, per query (the JAX package's host path, as it is: its merges
    order by (d2, pk, row)).  Candidate COVERAGE can differ from the
    device paths by float ulps at the beam margin; the operator layer's
    exact re-rank normalizes scores either way."""
    nq, n = len(q), len(x)
    out_d = np.full((nq, beam), np.inf, np.float32)
    out_r = np.full((nq, beam), -1, np.int64)
    gathered = np.zeros(nq, np.int64)
    for qi in range(nq):
        qv = q[qi]
        visited = np.zeros(n, bool)
        visited[ent] = True
        diff = x[ent] - qv
        bd = (diff * diff).sum(axis=1).astype(np.float32)
        bi = ent.copy()
        adm = mask[qi][bi]
        res_d, res_i = [bd[adm]], [bi[adm]]
        order = np.lexsort((bi, pks64[bi], bd))[:beam]
        bd, bi = bd[order], bi[order]
        for _ in range(hops):
            cand = nbr[bi].ravel()
            cand = np.unique(cand[cand >= 0])
            cand = cand[~visited[cand]]
            if not len(cand):
                break
            visited[cand] = True
            diff = x[cand] - qv
            cd = (diff * diff).sum(axis=1).astype(np.float32)
            adm = mask[qi][cand]
            res_d.append(cd[adm])
            res_i.append(cand[adm])
            md = np.concatenate([bd, cd])
            mi = np.concatenate([bi, cand])
            order = np.lexsort((mi, pks64[mi], md))[:beam]
            bd, bi = md[order], mi[order]
        gathered[qi] = int(visited.sum())
        rd = np.concatenate(res_d)
        ri = np.concatenate(res_i)
        order = np.lexsort((ri, pks64[ri], rd))[:beam]
        out_d[qi, :len(order)] = rd[order]
        out_r[qi, :len(order)] = ri[order]
    _dispatched(out_d.nbytes + out_r.nbytes)
    return out_d, out_r, gathered


def _graph_padded(q, nbr, ent, mask, pks64, npad: int):
    """The JAX package's device-branch padding to ``npad`` rows (all -1
    adjacency, unreachable; SENTINEL pks; no bitmap bit), the entries
    bucketed with SENTINEL, queries to BLOCK_Q tiles.  Returns (qp, nbp,
    ep, mq, pk32)."""
    BQ = fs_kernel.BLOCK_Q
    sent = int(fs_kernel.SENTINEL)
    n = len(nbr)
    nbp = np.full((npad, nbr.shape[1]), -1, np.int32)
    nbp[:n] = nbr
    mp = np.zeros((len(q), npad), np.uint8)
    mp[:, :n] = mask
    pkp = np.full(npad, sent, np.int64)
    pkp[:n] = pks64
    ep = np.full((1, _bucket(len(ent), floor=8)), sent, np.int32)
    ep[0, :len(ent)] = ent
    return (_pad_to(q, BQ, 0), nbp, ep, _pad_to(mp, BQ, 0),
            pkp.astype(np.int32)[None, :])


def _graph_rows(n: int) -> int:
    """The JAX package's padded row count: a bucketed BLOCK_N multiple."""
    BN = fs_kernel.BLOCK_N
    return _bucket(-(-n // BN) * BN, floor=BN)


def _graph_result(d2, ids, vis, nq: int, vis_bytes: int, tag: str,
                  shape: Tuple):
    """The device branch's epilogue: (nq, beam) d2, rows (SENTINEL ->
    -1) and the visited bitmask's popcount per query, with the dispatch
    charged as the JAX package charges it (its bitmask has ``vis_bytes``
    for the nq queries)."""
    sent = int(fs_kernel.SENTINEL)
    d2, ids, vis = d2[:nq], ids[:nq], vis[:nq]
    _dispatched(d2.nbytes + ids.nbytes + vis_bytes, tag, shape)
    rows = np.where(ids == sent, -1, ids).astype(np.int64)
    gathered = np.unpackbits(
        np.ascontiguousarray(vis).view(np.uint8), axis=1).sum(
            axis=1).astype(np.int64)
    return d2, rows, gathered


def graph_search_topk(q: np.ndarray, x, neighbors: np.ndarray,
                      entries: np.ndarray, mask: np.ndarray, pks,
                      beam: int, hops: int, device: Device = "cuda"
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Graph-index candidate generation over a packed CSR superbatch.

    q (nq, d) queries; x (>= n, d) packed vectors (a host array or the
    tensor ``pack_segments`` keeps on the store's device; rows past n are
    padding); neighbors (n, R) int32 CSR adjacency in packed row space
    (-1 out-degree padding); entries (e,) seed rows (the per-segment
    medoids and FPS entries); mask (nq, n) bool predicate bitmap; pks
    (>= n,) primary keys.  Returns (d2 (nq, beam) fp32 squared-L2
    ascending, rows (nq, beam) int64 packed row ids, -1 beyond a query's
    candidate count, gathered (nq,) int64 count of rows whose vectors the
    walk touched: the popcount of the visited words).  Ties break by
    (distance, pk) like every scan kernel.

    Distances are exact but coverage is approximate: callers re-rank the
    survivors through ``fused_scan_topk`` with the survivor mask.

    On the CPU: host numpy below ``HOST_FLOP_CUTOFF`` (the JAX package's
    host path), the plain version above it over the device branch's
    padding.  On the card: that padding (the packed column stays where it
    is; the adjacency, bitmap and entries go up) and one kernel launch."""
    dev = resolve_device(device)
    q = np.asarray(q, np.float32)
    nbr = np.asarray(neighbors, np.int32)
    mask = np.asarray(mask, bool)
    nq, n = len(q), len(nbr)
    beam = int(min(beam, fs_kernel.KMAX))
    hops = int(hops)
    empty = (np.full((nq, beam), np.inf, np.float32),
             np.full((nq, beam), -1, np.int64),
             np.zeros(nq, np.int64))
    ent = np.asarray(entries, np.int64).ravel()
    ent = ent[(ent >= 0) & (ent < n)]
    if n == 0 or beam == 0 or len(ent) == 0 or not mask.any():
        return empty
    pks64 = np.asarray(_as_host(pks)[:n], np.int64).ravel()
    if dev.type == "cuda":
        return _graph_kernel(q, x, nbr, ent, mask, pks64, beam, hops, dev)
    xh = np.asarray(_as_host(x)[:n], np.float32)
    work = nq * (hops * beam * nbr.shape[1] + len(ent)) * xh.shape[1]
    if work < HOST_FLOP_CUTOFF:
        return _graph_host(q, xh, nbr, ent, mask, pks64, beam, hops)
    npad = _graph_rows(n)
    xp = np.zeros((npad, xh.shape[1]), np.float32)
    xp[:n] = xh
    qp, nbp, ep, mq, pk32 = _graph_padded(q, nbr, ent, mask, pks64, npad)
    d2, _, ids, vis = (t.numpy() for t in ref.graph_search_topk_ref(
        *(torch.from_numpy(a) for a in (qp, xp, nbp, ep, mq, pk32)),
        beam, hops))
    return _graph_result(d2, ids, vis, nq, nq * (npad // 32) * 4,
                         "graph_search.ref", qp.shape + xp.shape
                         + (beam, hops))


def _graph_kernel(q: np.ndarray, x, nbr: np.ndarray, ent: np.ndarray,
                  mask: np.ndarray, pks64: np.ndarray, beam: int, hops: int,
                  dev: torch.device):
    """The card's path (the JAX package's Pallas branch): its padding of
    queries, adjacency, bitmap, pks and entries, one kernel launch.  The
    packed column stays where ``pack_segments`` put it: its rows are a
    BLOCK_N multiple >= n, fewer than the bucketed count when n is not a
    power-of-two multiple, which changes nothing but the number of
    all-zero visited words (pad rows are unreachable).  Charged with the
    Pallas branch's shape key and bytes.  On a CPU ``dev`` the wrapper
    takes its plain version."""
    n, d = len(nbr), int(np.shape(x)[1])
    npad = _graph_rows(n)
    if isinstance(x, torch.Tensor):
        xt = x.to(dev)
    else:
        xt = torch.zeros((npad, d), dtype=torch.float32, device=dev)
        xt[:n] = _on(np.asarray(x, np.float32)[:n], dev)
    qp, nbp, ep, mq, pk32 = _graph_padded(q, nbr, ent, mask, pks64,
                                          xt.shape[0])
    nbt, ept, mqt, pkt = (_on(a, dev) for a in (nbp, ep, mq, pk32))
    d2, _, ids, vis = gs_kernel.graph_search_topk(
        _on(qp, dev), xt, nbt, ept, mqt, pkt, beam, hops)
    return _graph_result(_host(d2), _host(ids), _host(vis), len(q),
                         len(q) * (npad // 32) * 4, "graph_search.cuda",
                         qp.shape + (npad, d) + (beam, hops))


# ---------------------------------------------------------------------------
# top-k merge
# ---------------------------------------------------------------------------

def merge_topk_batch(scores: np.ndarray, ids: np.ndarray, k: int,
                     device: Device = "cuda"
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Cross-shard top-k merge for a query batch (the sharded read path's
    combine step).

    scores (nq, s, kk) fp32 and ids (nq, s, kk) int64 hold each query's s
    per-shard candidate lists; empty slots carry score=+inf (their id is
    ignored).  Returns ((nq, k) fp32, (nq, k) int64) in ascending
    (score, id) order, with id=-1 marking slots beyond a query's candidate
    count.  ONE dispatch for the whole batch.

    On the CPU: the JAX package's default backend, the exact host merge
    (``lexsort((id, score))``).  On the card: its Pallas branch, one
    launch of the batched merge kernel; only the (nq, k) winners come back.
    The kernel's tie-break key is int32, so ids outside [0, 2^31-1) take
    the exact host merge instead, as the JAX package routes them."""
    dev = resolve_device(device)
    scores = np.asarray(scores, np.float32)
    ids64 = np.asarray(ids, np.int64)
    nq, s, kk = scores.shape
    k = int(min(k, s * kk))
    out_d = np.full((nq, k), np.inf, np.float32)
    out_i = np.full((nq, k), -1, np.int64)
    if k == 0 or nq == 0:
        return out_d, out_i
    if dev.type == "cuda":
        sentinel = int(fs_kernel.SENTINEL)
        real = ids64[np.isfinite(scores)]
        if not len(real) or (int(real.min()) >= 0
                             and int(real.max()) < sentinel):
            return _merge_kernel(scores, ids64, k, dev)
    flat_d = scores.reshape(nq, -1)
    flat_i = ids64.reshape(nq, -1)
    for qi in range(nq):
        order = np.lexsort((flat_i[qi], flat_d[qi]))[:k]
        order = order[np.isfinite(flat_d[qi][order])]
        out_d[qi, :len(order)] = flat_d[qi][order]
        out_i[qi, :len(order)] = flat_i[qi][order]
    _dispatched(out_d.nbytes + out_i.nbytes, "topk_merge_batch.ref",
                scores.shape + (k,))
    return out_d, out_i


def _merge_kernel(scores: np.ndarray, ids64: np.ndarray, k: int,
                  dev: torch.device) -> Tuple[np.ndarray, np.ndarray]:
    """The card's path (the JAX package's Pallas branch): ids of empty
    slots become SENTINEL, one launch, the (nq, k) winners come back (the
    plain version on a CPU ``dev``)."""
    sentinel = int(fs_kernel.SENTINEL)
    idp = np.where(np.isfinite(scores), ids64, sentinel).astype(np.int32)
    d, i = tk_kernel.batched_topk_merge(_on(scores, dev), _on(idp, dev), k)
    d, i = _host(d), _host(i).astype(np.int64)
    _dispatched(d.nbytes + i.nbytes, "topk_merge_batch.pallas",
                scores.shape + (k,))
    return d, np.where(np.isfinite(d), i, -1)


def merge_topk(dists: np.ndarray, ids: np.ndarray, k: int,
               device: Device = "cuda") -> Tuple[np.ndarray, np.ndarray]:
    """Merge S per-segment top-k lists (s, kk) -> global (k,): the k
    smallest distances, ties broken by flattened position.  On the CPU the
    plain version (the JAX package's default backend runs its oracle); on
    the card one launch of the single-list merge kernel."""
    dev = resolve_device(device)
    dists = np.asarray(dists, np.float32)
    ids = np.asarray(ids, np.int64)
    k = min(k, dists.size)
    if k == 0:
        return np.zeros((0,), np.float32), np.zeros((0,), np.int64)
    d, i = tk_kernel.topk_merge(_on(dists, dev), _on(ids, dev), k)
    d, i = _host(d), _host(i)
    tag = "topk_merge.pallas" if dev.type == "cuda" else "topk_merge.ref"
    # the JAX package hands its ids back as int32 (no x64): its byte count
    _dispatched(d.nbytes + d.size * 4, tag, dists.shape + (k,))
    return d, i
