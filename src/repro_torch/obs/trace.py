"""Low-overhead span tracer: a contextvar-parented span tree per
execution flow, with ring-buffer retention of finished root spans.

Design constraints:

  * tracing defaults OFF and the disabled path must stay within the
    benchmarked <=2% overhead budget — ``span()`` is one module-global
    check plus a shared no-op context manager, no allocation;
  * spans nest by contextvar, so operator spans land under their query
    span on the query thread while a background flush worker's spans
    root independently (contextvars are per-thread by construction);
  * finished ROOT spans are retained in a bounded deque; exports are
    Chrome trace-event JSON (load in Perfetto / chrome://tracing) and a
    human-readable indented tree.

Call sites open spans with ``with span("flush") as sp:`` — the
with-statement guarantees the span closes on exceptions (machine-checked
by the ``obs/span-closed`` analysis rule).  ``sp.set(rows=...)``
attaches attributes; on the disabled path ``sp`` is the no-op singleton
and ``set`` discards everything.
"""
from __future__ import annotations

import contextlib
import contextvars
import json
import threading
import time
from collections import deque
from typing import Any, Dict, Iterator, List, Optional

_EPOCH = time.perf_counter()


class Span:
    """One finished (or in-flight) span: name, start offset from the
    tracer epoch, duration, attributes, children."""

    __slots__ = ("name", "t0", "dur", "attrs", "children")
    live = True

    def __init__(self, name: str, attrs: Optional[Dict[str, Any]] = None):
        self.name = name
        self.t0 = 0.0
        self.dur = 0.0
        self.attrs: Dict[str, Any] = attrs if attrs is not None else {}
        self.children: List["Span"] = []

    def set(self, **attrs: Any) -> "Span":
        self.attrs.update(attrs)
        return self

    def add(self, key: str, delta: Any) -> None:
        """Accumulate a numeric attribute (kernel-launch style counts)."""
        self.attrs[key] = self.attrs.get(key, 0) + delta

    # ---------------------------------------------------------- traversal
    def walk(self) -> Iterator["Span"]:
        yield self
        for c in self.children:
            yield from c.walk()

    def tree(self, indent: int = 0) -> str:
        """Human-readable dump: name, duration, attrs, nested children."""
        pad = "  " * indent
        at = ""
        if self.attrs:
            at = " {" + ", ".join(f"{k}={v}"
                                  for k, v in sorted(self.attrs.items())) \
                + "}"
        lines = [f"{pad}{self.name} {self.dur * 1e3:.3f}ms{at}"]
        for c in self.children:
            lines.append(c.tree(indent + 1))
        return "\n".join(lines)


class _NullSpan:
    """Shared no-op span for the disabled path: ``with span(...)`` costs
    two trivial method calls and ``sp.set(...)`` discards its kwargs."""

    __slots__ = ()
    live = False
    name = ""
    dur = 0.0
    attrs: Dict[str, Any] = {}
    children: List[Span] = []

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc: Any) -> bool:
        return False

    def set(self, **attrs: Any) -> "_NullSpan":
        return self

    def add(self, key: str, delta: Any) -> None:
        pass


NULL_SPAN = _NullSpan()

_current: contextvars.ContextVar[Optional[Span]] = \
    contextvars.ContextVar("repro_obs_span", default=None)


class Tracer:
    """Process-wide retention of finished root spans (bounded)."""

    def __init__(self, maxlen: int = 256):
        self._lock = threading.Lock()
        self.roots: deque = deque(maxlen=maxlen)

    def retain(self, root: Span) -> None:
        with self._lock:
            self.roots.append(root)

    def clear(self) -> None:
        with self._lock:
            self.roots.clear()

    def snapshot(self) -> List[Span]:
        with self._lock:
            return list(self.roots)

    # ------------------------------------------------------------ exports
    def chrome_trace(self) -> str:
        """Chrome trace-event JSON ("X" complete events, microseconds) —
        loadable in Perfetto / chrome://tracing."""
        events = []
        for root in self.snapshot():
            for sp in root.walk():
                events.append({
                    "name": sp.name, "ph": "X", "pid": 0, "tid": 0,
                    "ts": round(sp.t0 * 1e6, 3),
                    "dur": round(sp.dur * 1e6, 3),
                    "args": {k: (v if isinstance(v, (int, float, str, bool))
                                 else repr(v))
                             for k, v in sp.attrs.items()},
                })
        return json.dumps({"traceEvents": events,
                           "displayTimeUnit": "ms"})

    def tree(self) -> str:
        return "\n".join(root.tree() for root in self.snapshot())


TRACER = Tracer()

_enabled = False


def enabled() -> bool:
    return _enabled


def set_tracing(on: bool) -> None:
    """Flip the process-wide tracing switch (default off)."""
    global _enabled
    _enabled = bool(on)


@contextlib.contextmanager
def force_tracing() -> Iterator[None]:
    """Enable tracing for a block and restore the prior state — the
    EXPLAIN ANALYZE path uses this so one query traces regardless of the
    global default."""
    global _enabled
    prev = _enabled
    _enabled = True
    try:
        yield
    finally:
        _enabled = prev


class _SpanCtx:
    """Live context manager returned by ``span()`` when tracing is on."""

    __slots__ = ("node", "token")

    def __init__(self, name: str, attrs: Dict[str, Any]):
        self.node = Span(name, attrs)
        self.token: Optional[contextvars.Token] = None

    def __enter__(self) -> Span:
        self.token = _current.set(self.node)
        self.node.t0 = time.perf_counter() - _EPOCH
        return self.node

    def __exit__(self, *exc: Any) -> bool:
        node = self.node
        node.dur = time.perf_counter() - _EPOCH - node.t0
        _current.reset(self.token)
        parent = _current.get()
        if parent is None:
            TRACER.retain(node)
        else:
            parent.children.append(node)
        return False


def span(name: str, **attrs: Any):
    """Open a span: ``with span("operator:FusedScanTopK") as sp: ...``.
    A shared no-op when tracing is disabled."""
    if not _enabled:
        return NULL_SPAN
    return _SpanCtx(name, attrs)


def current_span() -> Optional[Span]:
    """The innermost open span on this flow (None when untraced)."""
    if not _enabled:
        return None
    return _current.get()


def record_span(name: str, duration: float, **attrs: Any) -> Optional[Span]:
    """Attach an already-measured span (generator drains accumulate time
    across ``next()`` windows, then record once at exhaustion)."""
    if not _enabled:
        return None
    node = Span(name, attrs)
    node.t0 = time.perf_counter() - _EPOCH - duration
    node.dur = duration
    parent = _current.get()
    if parent is None:
        TRACER.retain(node)
    else:
        parent.children.append(node)
    return node
