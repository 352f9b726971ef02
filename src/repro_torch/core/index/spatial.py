"""Z-order spatial index (paper §2.1 SPATIAL_INDEX_TYPE 'local'/'hybrid').

Per-segment component: rows sorted by 32-bit Morton code (16 bits per
axis over the segment's bounding box), with per-block zone maps (bbox per
block). Range queries prune blocks by bbox overlap then exact-filter via
the bitmap kernel; distance iterators implement incremental nearest
neighbour (Hjaltason & Samet) over block bounding boxes — a correct
globally-sorted stream for NRA.

'hybrid' adds the global level: the store-wide fence map from segment
bboxes handled by core.index.global_index.
"""
from __future__ import annotations

import heapq
import threading
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.index.base import SecondaryIndex, SortedAccess
from repro_torch.core.types import BLOCK_ROWS
from repro_torch.kernels import ops as kops


def morton_codes(xy: np.ndarray, bbox: Tuple[float, float, float, float]
                 ) -> np.ndarray:
    """Interleave 16-bit quantized x/y into 32-bit Morton codes."""
    xmin, ymin, xmax, ymax = bbox
    sx = (xmax - xmin) or 1.0
    sy = (ymax - ymin) or 1.0
    qx = np.clip(((xy[:, 0] - xmin) / sx * 65535), 0, 65535).astype(np.uint32)
    qy = np.clip(((xy[:, 1] - ymin) / sy * 65535), 0, 65535).astype(np.uint32)

    def spread(v):
        v = (v | (v << 8)) & np.uint32(0x00FF00FF)
        v = (v | (v << 4)) & np.uint32(0x0F0F0F0F)
        v = (v | (v << 2)) & np.uint32(0x33333333)
        v = (v | (v << 1)) & np.uint32(0x55555555)
        return v

    return (spread(qx) | (spread(qy) << np.uint32(1))).astype(np.uint32)


def _block_bboxes(points: np.ndarray) -> np.ndarray:
    """Per-block (xmin, ymin, xmax, ymax) zone maps, vectorized via
    ``reduceat`` over BLOCK_ROWS strides (no per-block Python loop)."""
    n = len(points)
    if n == 0:
        return np.zeros((0, 4), np.float32)
    starts = np.arange(0, n, BLOCK_ROWS)
    mins = np.minimum.reduceat(points, starts, axis=0)
    maxs = np.maximum.reduceat(points, starts, axis=0)
    return np.concatenate([mins, maxs], axis=1).astype(np.float32)


# query threads share an index's device copy (the sharded fan-out, the
# background flush worker's compactions beside a query): the check and the
# upload happen under one lock, as the segment pack cache's do
_device_lock = threading.Lock()


class ZOrderIndex(SecondaryIndex):
    kind = "zorder"

    def __init__(self):
        self.rows: Optional[np.ndarray] = None      # row ids in z order
        self.points: Optional[np.ndarray] = None    # (n, 2) in z order
        self.block_bbox: Optional[np.ndarray] = None  # (nb, 4)
        self.bbox = (0.0, 0.0, 1.0, 1.0)
        # (device, points (n, 2) fp32, rows (n,) int32) on the device the
        # range probe last ran on; dropped wherever ``points`` is set
        self._on_device: Optional[Tuple[torch.device, torch.Tensor,
                                        torch.Tensor]] = None

    def build(self, segment, column) -> None:
        pts = np.asarray(segment.columns[column.name], np.float32)
        self._on_device = None
        if len(pts) == 0:
            self.rows = np.zeros((0,), np.int64)
            self.points = pts.reshape(0, 2)
            self.block_bbox = np.zeros((0, 4), np.float32)
            return
        self.bbox = (float(pts[:, 0].min()), float(pts[:, 1].min()),
                     float(pts[:, 0].max()), float(pts[:, 1].max()))
        z = morton_codes(pts, self.bbox)
        order = np.argsort(z, kind="stable")
        self.rows = order.astype(np.int64)
        self.points = pts[order]
        self.block_bbox = _block_bboxes(self.points)

    def merge(self, parts, merged_seg, column, row_maps) -> None:
        """Z-order array merge: gather the surviving (row, point) pairs
        from the parts' already-materialized z-ordered arrays, re-quantize
        under the union bounding box, and re-sort the codes — the raw
        column is never re-read and the zone maps rebuild via reduceat."""
        self._on_device = None
        pts_list, rows_list = [], []
        for part, rmap in zip(parts, row_maps):
            if part.rows is None or not len(part.rows):
                continue
            new_rows = rmap[part.rows]
            keep = new_rows >= 0
            pts_list.append(part.points[keep])
            rows_list.append(new_rows[keep])
        if not pts_list:
            self.rows = np.zeros((0,), np.int64)
            self.points = np.zeros((0, 2), np.float32)
            self.block_bbox = np.zeros((0, 4), np.float32)
            return
        pts = np.concatenate(pts_list)
        rows = np.concatenate(rows_list)
        self.bbox = (float(pts[:, 0].min()), float(pts[:, 1].min()),
                     float(pts[:, 0].max()), float(pts[:, 1].max()))
        z = morton_codes(pts, self.bbox)
        order = np.argsort(z, kind="stable")
        self.rows = rows[order].astype(np.int64)
        self.points = pts[order]
        self.block_bbox = _block_bboxes(self.points)

    def to_arrays(self):
        return {"rows": np.asarray(self.rows, np.int64),
                "points": np.asarray(self.points, np.float32),
                "block_bbox": np.asarray(self.block_bbox, np.float32),
                "bbox": np.asarray(self.bbox, np.float64)}

    def from_arrays(self, arrays, segment, column) -> None:
        self._on_device = None
        self.rows = np.asarray(arrays["rows"], np.int64)
        self.points = np.asarray(arrays["points"], np.float32)
        self.block_bbox = np.asarray(arrays["block_bbox"], np.float32)
        self.bbox = tuple(float(v) for v in arrays["bbox"])

    # --------------------------------------------------------------- range
    def _overlapping_blocks(self, rect) -> np.ndarray:
        if self.block_bbox is None or len(self.block_bbox) == 0:
            return np.zeros((0,), np.int64)
        xmin, ymin, xmax, ymax = rect
        bb = self.block_bbox
        hit = ~((bb[:, 2] < xmin) | (bb[:, 0] > xmax)
                | (bb[:, 3] < ymin) | (bb[:, 1] > ymax))
        return np.nonzero(hit)[0]

    def device_arrays(self, device) -> Tuple[torch.Tensor, torch.Tensor]:
        """The Z-ordered points (n, 2) fp32 and their segment rows (n,)
        int32 on ``device``: uploaded at the first range probe there and
        kept until the index is rebuilt (``build``, ``merge``,
        ``from_arrays``)."""
        device = torch.device(device)
        with _device_lock:
            held = self._on_device
            if held is None or held[0] != device:
                pts = torch.from_numpy(np.ascontiguousarray(
                    self.points, np.float32)).to(device)
                rows = torch.from_numpy(np.asarray(
                    self.rows, np.int32)).to(device)
                held = self._on_device = (device, pts, rows)
            return held[1], held[2]

    def bitmap(self, segment, predicate) -> np.ndarray:
        """Rows inside ``predicate.rect``: one device launch over every
        block whose zone map overlaps it."""
        blocks = self._overlapping_blocks(predicate.rect)
        self.last_blocks_read = len(blocks)
        dev = kops.resolve_device(self.device)
        pts, rows = self.device_arrays(dev)
        return kops.rect_filter_blocks(pts, rows, blocks, predicate.rect,
                                       segment.n_rows, BLOCK_ROWS,
                                       device=dev)

    def selectivity(self, segment, predicate) -> float:
        if segment.n_rows == 0:
            return 0.0
        xmin, ymin, xmax, ymax = predicate.rect
        bxmin, bymin, bxmax, bymax = self.bbox
        area_q = max(0.0, min(xmax, bxmax) - max(xmin, bxmin)) * \
            max(0.0, min(ymax, bymax) - max(ymin, bymin))
        area_b = max((bxmax - bxmin) * (bymax - bymin), 1e-12)
        return min(1.0, area_q / area_b)

    def probe_cost_blocks(self, segment, predicate) -> float:
        return max(1.0, len(self._overlapping_blocks(predicate.rect)))

    # ------------------------------------------------------------ distance
    def iterator(self, segment, query) -> "ZOrderSortedAccess":
        return ZOrderSortedAccess(self, np.asarray(query, np.float32))


def _bbox_min_dist(p: np.ndarray, bb: np.ndarray) -> np.ndarray:
    dx = np.maximum(np.maximum(bb[:, 0] - p[0], p[0] - bb[:, 2]), 0.0)
    dy = np.maximum(np.maximum(bb[:, 1] - p[1], p[1] - bb[:, 3]), 0.0)
    return np.sqrt(dx * dx + dy * dy)


class ZOrderSortedAccess(SortedAccess):
    """Exact incremental-NN: a heap over (block lower bound | row exact
    distance); a row is emitted only once its distance is <= every
    remaining block's lower bound => globally sorted output."""

    def __init__(self, index: ZOrderIndex, point: np.ndarray,
                 block_out: int = 256):
        self.idx = index
        self.p = point
        self.block_out = block_out
        self.blocks_read = 0
        self._heap: List[Tuple[float, int, str, Any]] = []
        self._count = 0
        if index.block_bbox is not None and len(index.block_bbox):
            lbs = _bbox_min_dist(point, index.block_bbox)
            for b, lb in enumerate(lbs):
                self._push(float(lb), "block", b)

    def _push(self, d, kind, payload):
        self._count += 1
        heapq.heappush(self._heap, (d, self._count, kind, payload))

    def next_block(self):
        out_d, out_r = [], []
        while self._heap and len(out_d) < self.block_out:
            d, _, kind, payload = heapq.heappop(self._heap)
            if kind == "row":
                out_d.append(d)
                out_r.append(payload)
                continue
            b = payload
            sl = slice(b * BLOCK_ROWS, min((b + 1) * BLOCK_ROWS,
                                           len(self.idx.points)))
            self.blocks_read += 1
            pts = self.idx.points[sl]
            dist = np.sqrt(((pts - self.p) ** 2).sum(axis=1))
            for dd, rr in zip(dist, self.idx.rows[sl]):
                self._push(float(dd), "row", int(rr))
        if not out_d:
            return None
        return np.asarray(out_d, np.float32), np.asarray(out_r, np.int64)
