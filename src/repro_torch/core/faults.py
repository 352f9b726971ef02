"""Fault-injection harness for crash-recovery testing.

A ``FaultInjector`` is armed with one named crash point (see
``CRASH_POINTS``); durability code calls ``faults.crash("...")`` at each
point and the injector raises ``InjectedCrash`` when its armed point is
reached.  After the first fire the injector is *poisoned*: every later
``crash()`` call raises too, so a store that "crashed" in one thread
cannot keep publishing durable state from another (the background flush
worker dies at its next crash point instead of finishing the flush the
simulated process crash should have interrupted).

Stores hold a ``faults`` attribute defaulting to the shared no-op
``NO_FAULTS`` injector; tests wire a fresh armed injector into one store
(``LSMStore.set_faults``) and drive writes until it fires, then abandon
the instance and recover from disk — the file system is left exactly as
a process kill at that point would leave it (including deliberately torn
WAL records and half-written segment files at the write-side points).
"""
from __future__ import annotations

from typing import Optional

# every named crash point the durability layer exposes, in write-path
# order — the crash-recovery matrix in tests/test_durability.py kills at
# each one
CRASH_POINTS = (
    "wal.append",              # torn record: half the bytes hit the log
    "wal.commit",              # record written, fdatasync never runs
    "flush.segment-file",      # torn segment temp file mid-write
    "flush.before-publish",    # segment durable, manifest still old
    "manifest.publish",        # manifest temp written, rename never runs
    "manifest.after-rename",   # new manifest live, dir fsync/GC skipped
    "compact.before-publish",  # merged segment durable, manifest old
    "compact.after-publish",   # manifest swapped, inputs not yet deleted
)


class InjectedCrash(RuntimeError):
    """Raised at an armed crash point; simulates the process dying."""


class FaultInjector:
    """Single-shot crash-point trigger.

    ``arm(point, after=N)`` fires on the N+1-th time ``point`` is
    reached.  ``fired`` records the point that actually fired (tests in
    background-flush mode poll it, because the crash raises on the
    worker thread, not under the writer's ``put``)."""

    def __init__(self) -> None:
        self._point: Optional[str] = None
        self._countdown = 0
        self.fired: Optional[str] = None

    def arm(self, point: str, after: int = 0) -> "FaultInjector":
        if point not in CRASH_POINTS:
            raise ValueError(f"unknown crash point {point!r}")
        self._point = point
        self._countdown = int(after)
        return self

    @property
    def crashed(self) -> bool:
        return self.fired is not None

    def should_crash(self, point: str) -> bool:
        """True when ``point`` must crash now (poisoned or armed with an
        exhausted countdown).  Does not raise — the WAL uses it to tear
        a record mid-write before raising itself."""
        if self.fired is not None:
            return True
        if point != self._point:
            return False
        if self._countdown > 0:
            self._countdown -= 1
            return False
        return True

    def crash(self, point: str) -> None:
        """Raise ``InjectedCrash`` when armed for ``point`` (or already
        poisoned); otherwise a no-op on the hot path."""
        if self.should_crash(point):
            self.fired = self.fired or point
            raise InjectedCrash(f"injected crash at {point}")


# shared disarmed injector: ``should_crash`` is always False, so the
# production path pays one attribute load + compare per crash point
NO_FAULTS = FaultInjector()
