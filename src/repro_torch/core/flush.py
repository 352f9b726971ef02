"""Pipelined flush/compaction scheduling (paper §3-§4: secondary indexes
are maintained at flush/compaction time — never on the write critical
path).

The ``FlushScheduler`` decouples ingest from segment building: puts land
in the *active* memtable; when it reaches the flush threshold it is
*sealed* (an O(1) pointer swap) and queued.  Sealed memtables stay fully
readable (``LSMStore.memtable_arrays`` concatenates sealed + active) until
a worker turns them into level-0 segments and size-tiered compaction runs
— so index construction cost never blocks a ``put``.

Three operating modes:

  inline       (pipeline=False, default) — every write drains the queue
               synchronously; behavior is identical to the classic
               flush-on-put LSM write path (what the tests exercise).
  pipelined    (pipeline=True) — work queues up; tests/drivers call
               ``drain()`` deterministically.  Backpressure: when more
               than ``max_sealed`` memtables are waiting, the writer
               self-drains one work unit per put (a *write stall*,
               counted in ``metrics['stalls']``).
  background   (pipeline=True, background=True) — a daemon worker thread
               drains the queue; the writer blocks on the stall condition
               instead of self-draining.  Benchmark-oriented: concurrent
               reads during background flushing are not synchronized.
"""
from __future__ import annotations

import threading
from typing import List, Optional

from repro_torch.core.faults import InjectedCrash
from repro_torch.obs import REGISTRY


class FlushScheduler:
    def __init__(self, store):
        self.store = store
        cfg = store.cfg
        self.pipeline = bool(cfg.pipeline)
        self.max_sealed = max(1, int(cfg.max_sealed))
        self._cv: Optional[threading.Condition] = None
        self._worker: Optional[threading.Thread] = None
        self._stop = False
        self._busy = False           # worker is mid-step outside the lock
        if self.pipeline and cfg.background:
            self._cv = threading.Condition()
            self._worker = threading.Thread(
                target=self._run_worker, name="lsm-flush", daemon=True)
            self._worker.start()

    # ----------------------------------------------------------- write side
    def on_write(self) -> None:
        """Called by the store after every put/delete lands in the active
        memtable: seal at threshold, then either drain inline (classic
        mode) or apply backpressure (pipelined modes)."""
        store = self.store
        cfg = store.cfg
        mtab = store.memtable
        if len(mtab) >= cfg.flush_rows or (
                cfg.flush_bytes > 0
                and mtab.approx_bytes >= cfg.flush_bytes):
            store.seal()
        if not self.pipeline:
            self.drain()
            return
        if self._cv is not None:
            with self._cv:
                self._cv.notify_all()
                while len(store.sealed) > self.max_sealed:
                    store.metrics["stalls"] += 1
                    REGISTRY.inc("lsm.stalls")
                    self._cv.wait(timeout=0.05)
        else:
            # deterministic backpressure: the writer pays one unit of
            # background work per put while compaction debt is high
            while len(store.sealed) > self.max_sealed:
                store.metrics["stalls"] += 1
                REGISTRY.inc("lsm.stalls")
                if not self.step():
                    break

    # ------------------------------------------------------------ work queue
    def work_available(self) -> bool:
        return bool(self.store.sealed) or \
            self.store._compactable_level() is not None

    def step(self):
        """Process one unit of background work: flush the oldest sealed
        memtable, else merge one full tier.  Returns the new Segment for
        a flush, True for a compaction, False when idle."""
        store = self.store
        if store.sealed:
            return store._flush_sealed()
        level = store._compactable_level()
        if level is not None:
            store._compact_level(level)
            return True
        return False

    def drain(self) -> List:
        """Deterministically run the queue dry; returns the segments
        flushed by this call (in flush order)."""
        if self._cv is not None:
            # background mode: wake the worker and wait for quiescence —
            # including a step in flight (work_available() is briefly
            # false while the worker mutates the store outside the lock)
            with self._cv:
                self._cv.notify_all()
                while self.work_available() or self._busy:
                    self._cv.wait(timeout=0.05)
            return []
        segs = []
        while True:
            r = self.step()
            if r is False:
                return segs
            if r is not True:
                segs.append(r)

    # ------------------------------------------------------------ background
    def _run_worker(self) -> None:
        while True:
            with self._cv:
                while not self.work_available() and not self._stop:
                    self._cv.wait(timeout=0.05)
                if self._stop and not self.work_available():
                    return
                self._busy = True
            try:
                self.step()
            except InjectedCrash:
                # fault-injection harness: the simulated process died at
                # a crash point — the worker thread dies with it (a real
                # kill would take every thread), leaving the on-disk
                # state exactly as the crash left it
                with self._cv:
                    self._busy = False
                    self._cv.notify_all()
                return
            finally:
                with self._cv:
                    self._busy = False
                    self._cv.notify_all()

    def close(self) -> None:
        """Stop the background worker after finishing queued work."""
        if self._cv is None:
            return
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        self._worker.join(timeout=10.0)
