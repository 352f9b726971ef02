"""Threshold-based slow-query log.

When a query's wall latency crosses the configured threshold, the
executor records an entry holding the latency, the plan description,
and — when tracing was on for that query — the captured span tree.
Retention is a bounded ring buffer; the threshold defaults to ``None``
(disabled) so the hot path is a single comparison against ``None``.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

from .trace import Span


class SlowQueryLog:
    def __init__(self, maxlen: int = 128):
        self._lock = threading.Lock()
        self.threshold_s: Optional[float] = None
        self.entries: deque = deque(maxlen=maxlen)

    def configure(self, threshold_s: Optional[float],
                  maxlen: Optional[int] = None) -> None:
        with self._lock:
            self.threshold_s = threshold_s
            if maxlen is not None:
                self.entries = deque(self.entries, maxlen=maxlen)

    def maybe_record(self, latency_s: float, plan: str,
                     span: Optional[Span] = None,
                     **extra: Any) -> bool:
        """Record iff enabled and over threshold; returns True if kept."""
        thr = self.threshold_s
        if thr is None or latency_s < thr:
            return False
        entry = {"ts": time.time(), "latency_s": latency_s, "plan": plan,
                 "span_tree": span.tree() if span is not None else None}
        entry.update(extra)
        with self._lock:
            self.entries.append(entry)
        return True

    def snapshot(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self.entries)

    def clear(self) -> None:
        with self._lock:
            self.entries.clear()


SLOW_LOG = SlowQueryLog()
