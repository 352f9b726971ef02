"""EXPLAIN ANALYZE: annotate a plan's operator tree with actuals.

The executors run the query under ``trace.force_tracing()`` inside a
private root span; every operator records a span named
``operator:<NodeName>`` whose attributes mirror its ``ExecStats``
charges exactly (``rows``/``bytes``/``blocks``) plus the rows it
produced (``out_rows``).  This module aggregates those spans by operator
name and renders the EXPLAIN tree with an ``(actual time=... rows=...
drift=...)`` suffix per node — ``drift`` is the actual/estimated row
ratio where the planner attached an ``est_rows`` estimate.

Keying by *name* is sound because one query's pipeline instantiates each
operator once (per-conjunct probe nodes under ``BitmapUnion`` execute
inside the union's single span); sharded plans disambiguate repeated
subtrees by nesting operator spans under per-shard ``shard`` spans and
switching the actuals table at each ``Shard`` EXPLAIN node.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional

from .trace import Span

SPAN_PREFIX = "operator:"

_ZERO = {"count": 0, "time_s": 0.0, "rows": 0, "bytes": 0,
         "blocks": 0.0, "out_rows": 0}


def actuals_from(root: Span) -> Dict[str, Dict[str, Any]]:
    """Aggregate ``operator:*`` spans under ``root`` by operator name."""
    out: Dict[str, Dict[str, Any]] = {}
    for sp in root.walk():
        if not sp.name.startswith(SPAN_PREFIX):
            continue
        d = out.setdefault(sp.name[len(SPAN_PREFIX):], dict(_ZERO))
        d["count"] += 1
        d["time_s"] += sp.dur
        for key in ("rows", "bytes", "blocks", "out_rows"):
            d[key] += sp.attrs.get(key, 0)
    return out


def shard_actuals(root: Span) -> Dict[int, Dict[str, Dict[str, Any]]]:
    """Per-shard actuals tables, keyed by the ``shard=i`` span attr.
    Each table carries a synthetic ``Shard`` entry holding the whole
    shard span's duration (annotates the ``Shard`` EXPLAIN node)."""
    out: Dict[int, Dict[str, Dict[str, Any]]] = {}
    for sp in root.walk():
        if sp.name != "shard":
            continue
        table = actuals_from(sp)
        entry = dict(_ZERO)
        entry.update(count=1, time_s=sp.dur)
        table["Shard"] = entry
        out[int(sp.attrs.get("shard", len(out)))] = table
    return out


def fmt_bytes(n: int) -> str:
    if n < 10_000:
        return f"{n}B"
    if n < 10_000_000:
        return f"{n / 1024:.1f}KB"
    return f"{n / (1024 * 1024):.1f}MB"


def make_annotator(actuals: Dict[str, Dict[str, Any]],
                   per_shard: Optional[
                       Dict[int, Dict[str, Dict[str, Any]]]] = None
                   ) -> Callable:
    """Annotation callback for ``PhysicalOp.explain(annotate=...)``.

    EXPLAIN renders depth-first, so a stateful cursor can switch the
    actuals table as it enters each ``Shard`` subtree: the i-th Shard
    node it meets reads shard i's table (``_ShardSubplan`` details are
    built in shard order)."""
    state = {"table": actuals, "next_shard": 0}

    def annotate(node) -> str:
        if node.name == "Shard" and per_shard is not None:
            state["table"] = per_shard.get(state["next_shard"], {})
            state["next_shard"] += 1
        a = state["table"].get(node.name)
        if a is None:
            return " (actual -)"
        parts = [f"time={a['time_s'] * 1e3:.3f}ms"]
        rows = a["out_rows"] or a["rows"]
        parts.append(f"rows={rows}")
        if a["bytes"]:
            parts.append(f"bytes={fmt_bytes(a['bytes'])}")
        if a["blocks"]:
            parts.append(f"blocks={a['blocks']:.0f}")
        est = float(getattr(node, "est_rows", 0.0) or 0.0)
        parts.append(f"drift={rows / est:.2f}x" if est > 0 else "drift=-")
        return " (actual " + " ".join(parts) + ")"

    return annotate


@dataclasses.dataclass
class Analyzed:
    """EXPLAIN ANALYZE output: the annotated tree plus the execution's
    results / stats / span tree (results are bitwise-identical to a
    normal ``execute`` — analyze only observes)."""
    text: str
    results: List
    stats: Any
    span: Span
    actuals: Dict[str, Dict[str, Any]]
    per_shard: Optional[Dict[int, Dict[str, Dict[str, Any]]]] = None

    def __str__(self) -> str:
        return self.text
