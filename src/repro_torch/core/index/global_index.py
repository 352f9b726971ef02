"""Global (in-RAM) index level: maps value ranges -> per-segment index
blocks (paper §4: "The global index, organized as a multi-level tree, maps
secondary value ranges to SST index blocks. This design enables efficient
SST file pruning and direct query routing").

One GlobalIndex per indexed column; entries are per-segment summaries
(zone maps: scalar min/max, spatial bbox, vector centroid cloud radius,
text term Bloom-ish set). ``prune`` returns only the segments whose
summary intersects the predicate — segments never touched never cost I/O.
"""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np

from repro_torch.core.types import ColumnType


class GlobalIndex:
    def __init__(self, column):
        self.column = column
        # seg_id -> summary
        self.summaries: Dict[int, Any] = {}

    # ---------------------------------------------------------- maintain
    def add_segment(self, segment) -> None:
        name = self.column.name
        ct = self.column.ctype
        if ct == ColumnType.SCALAR:
            v = np.asarray(segment.columns[name], np.float64)
            self.summaries[segment.seg_id] = (float(v.min()), float(v.max())) \
                if len(v) else (np.inf, -np.inf)
        elif ct == ColumnType.SPATIAL:
            p = np.asarray(segment.columns[name], np.float32)
            self.summaries[segment.seg_id] = (
                (float(p[:, 0].min()), float(p[:, 1].min()),
                 float(p[:, 0].max()), float(p[:, 1].max()))
                if len(p) else (np.inf, np.inf, -np.inf, -np.inf))
        elif ct == ColumnType.VECTOR:
            idx = segment.indexes.get(name)
            cents = getattr(idx, "centroids", None)
            self.summaries[segment.seg_id] = cents
        elif ct == ColumnType.TEXT:
            idx = segment.indexes.get(name)
            terms = set(getattr(idx, "postings", {}).keys())
            self.summaries[segment.seg_id] = terms

    def drop_segment(self, seg_id: int) -> None:
        self.summaries.pop(seg_id, None)

    # ------------------------------------------------------------- prune
    def prune(self, segments, predicate) -> List:
        """Segments possibly containing matches for ``predicate``."""
        from repro_torch.core import query as q
        out = []
        for seg in segments:
            s = self.summaries.get(seg.seg_id)
            if s is None:
                out.append(seg)          # no summary: cannot prune
                continue
            if isinstance(predicate, q.Range):
                lo, hi = s
                if not (predicate.hi < lo or predicate.lo > hi):
                    out.append(seg)
            elif isinstance(predicate, q.GeoWithin):
                xmin, ymin, xmax, ymax = s
                qx0, qy0, qx1, qy1 = predicate.rect
                if not (qx1 < xmin or qx0 > xmax or qy1 < ymin or qy0 > ymax):
                    out.append(seg)
            elif isinstance(predicate, q.TextContains):
                if predicate.term.lower() in s:
                    out.append(seg)
            elif isinstance(predicate, q.VectorRange):
                cents = s
                if cents is None or len(cents) == 0:
                    out.append(seg)
                    continue
                d2 = ((cents - predicate.q[None, :]) ** 2).sum(1)
                # conservative: centroid within thresh + cloud slack;
                # compared in squared form — no sqrt on the prune path
                lim = predicate.thresh * 2.0 + 1.0
                if float(d2.min()) <= lim * lim:
                    out.append(seg)
            else:
                out.append(seg)
        return out


class GlobalIndexSet:
    """All global indexes of a store; kept in sync on flush/compaction."""

    def __init__(self, schema):
        self.schema = schema
        self.by_col: Dict[str, GlobalIndex] = {
            c.name: GlobalIndex(c) for c in schema.indexed_columns}

    def on_new_segment(self, segment) -> None:
        for gi in self.by_col.values():
            gi.add_segment(segment)

    def on_drop_segment(self, seg_id: int) -> None:
        for gi in self.by_col.values():
            gi.drop_segment(seg_id)

    def prune(self, segments, predicate) -> List:
        col = getattr(predicate, "col", None)
        gi = self.by_col.get(col)
        if gi is None:
            return list(segments)
        return gi.prune(segments, predicate)
