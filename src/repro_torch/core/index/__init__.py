"""Unified secondary index framework (paper §4)."""
from __future__ import annotations

from repro_torch.core.index.base import (  # noqa: F401
    ExactSortedAccess, MergedSortedAccess, SecondaryIndex, SortedAccess)
from repro_torch.core.index.global_index import GlobalIndex, GlobalIndexSet  # noqa: F401
from repro_torch.core.index.graph import GraphIndex, PackedGraph, pack_graphs  # noqa: F401
from repro_torch.core.index.ivf import IVFIndex
from repro_torch.core.index.scalar import ScalarIndex
from repro_torch.core.index.spatial import ZOrderIndex
from repro_torch.core.index.text import InvertedTextIndex
from repro_torch.core.types import Column, IndexKind


def default_index_factory(column: Column):
    """Map a column's declared index kind to its implementation."""
    k = column.index
    if k == IndexKind.BTREE:
        return ScalarIndex()
    if k == IndexKind.IVF:
        return IVFIndex()
    if k == IndexKind.PQIVF:
        return IVFIndex(use_pq=True)
    if k == IndexKind.GRAPH:
        return GraphIndex()
    if k == IndexKind.ZORDER:
        return ZOrderIndex()
    if k == IndexKind.INVERTED:
        return InvertedTextIndex()
    return None
