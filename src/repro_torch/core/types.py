"""Schema and multimodal column types for the ARCADE store.

ARCADE supports relational (SCALAR), VECTOR (with declared dimension),
SPATIAL (2-d points), TEXT, and BLOB columns (paper §2.1). Row batches are
columnar dicts of numpy arrays (TEXT/BLOB as object arrays); the storage
layer is host-orchestrated, per-segment compute runs through the port's
CUDA kernels.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Dict, List, Optional, Sequence

import numpy as np


class ColumnType(enum.Enum):
    SCALAR = "scalar"       # int/float relational attribute
    VECTOR = "vector"       # embedding, fixed dim
    SPATIAL = "spatial"     # 2-d point (x, y)
    TEXT = "text"           # tokenizable string
    BLOB = "blob"           # opaque bytes (images/videos); not indexed


class IndexKind(enum.Enum):
    NONE = "none"
    BTREE = "btree"         # sorted scalar secondary index
    IVF = "ivf"             # vector inverted-file index
    PQIVF = "pqivf"         # IVF with product quantization
    GRAPH = "graph"         # Vamana-style CSR proximity graph
    ZORDER = "zorder"       # spatial (local per-segment; 'hybrid' adds global)
    INVERTED = "inverted"   # text inverted index


@dataclasses.dataclass(frozen=True)
class Column:
    name: str
    ctype: ColumnType
    dim: int = 0                      # VECTOR_DIMENSION for vector columns
    index: IndexKind = IndexKind.NONE
    spatial_index_type: str = "hybrid"  # 'local' | 'hybrid' (paper §2.1)

    def __post_init__(self):
        if self.ctype == ColumnType.VECTOR and self.dim <= 0:
            raise ValueError(f"vector column {self.name} needs dim > 0")


@dataclasses.dataclass(frozen=True)
class Schema:
    columns: Sequence[Column]

    def __post_init__(self):
        names = [c.name for c in self.columns]
        if len(set(names)) != len(names):
            raise ValueError("duplicate column names")

    def col(self, name: str) -> Column:
        for c in self.columns:
            if c.name == name:
                return c
        raise KeyError(name)

    @property
    def indexed_columns(self) -> List[Column]:
        return [c for c in self.columns if c.index != IndexKind.NONE]


def validate_batch(schema: Schema, batch: Dict[str, np.ndarray],
                   n: Optional[int] = None) -> int:
    """Check a columnar batch against the schema; returns row count."""
    for c in schema.columns:
        if c.name not in batch:
            raise ValueError(f"missing column {c.name}")
        arr = batch[c.name]
        rows = len(arr)
        if n is None:
            n = rows
        elif rows != n:
            raise ValueError(f"column {c.name} has {rows} rows, want {n}")
        if c.ctype == ColumnType.VECTOR:
            arr = np.asarray(arr)
            if arr.ndim != 2 or arr.shape[1] != c.dim:
                raise ValueError(f"vector column {c.name}: shape {arr.shape}"
                                 f" want (*, {c.dim})")
        elif c.ctype == ColumnType.SPATIAL:
            arr = np.asarray(arr)
            if arr.ndim != 2 or arr.shape[1] != 2:
                raise ValueError(f"spatial column {c.name}: shape {arr.shape}")
    return int(n or 0)


BLOCK_ROWS = 128   # rows per block — the read unit (HBM->VMEM tile height)
