"""Per-store manifest: the atomic commit point for durable state.

A store directory looks like::

    <root>/
      manifest-<gen>.json      # generation-numbered store state
      segments/seg-<id>.npz    # columnar segment files (core/segment.py)
      wal/wal-<seqno>.log      # rotated WAL files (core/wal.py)

The manifest is the only coordination point: a segment file exists
*durably* the moment the manifest that references it is renamed into
place. Publish protocol (classic write-temp/fsync/rename, matching
Arc's segment registration in SNIPPETS.md):

    1. write ``manifest-<gen+1>.json.tmp``, flush + fsync the file
    2. ``os.replace`` tmp -> ``manifest-<gen+1>.json``  (atomic)
    3. fsync the directory (the rename itself becomes durable)
    4. delete generations older than the previous one

A crash anywhere before step 2 leaves the previous manifest intact and
at most a tmp/orphan segment file behind; a crash between 2 and 3 can
lose the *new* generation on some filesystems but never the old one.
Recovery loads the highest parseable generation and garbage-collects
segment files it does not reference (orphans from crashed flushes).

State carried per generation: schema, segment list (file, level,
row count, max seqno), the durable seqno frontier (max seqno captured
in any flushed segment — WAL replay starts past it), writer counters
(next seqno / unique-pk stats) and the PQ codebook assignment per
column so quantized residence survives restart.

The port's stores do not write this layout yet (durability is ROADMAP
queue 1, item 6); the schema codec and ``atomic_write_json`` are the
reference's, byte for byte.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.core.faults import NO_FAULTS, FaultInjector
from repro_torch.core.types import Column, ColumnType, IndexKind, Schema

MANIFEST_PREFIX = "manifest-"
SEGMENTS_DIR = "segments"
WAL_DIR = "wal"
FORMAT_VERSION = 1


def schema_to_json(schema: Schema) -> List[Dict[str, Any]]:
    return [{"name": c.name, "ctype": c.ctype.name, "dim": c.dim,
             "index": c.index.name,
             "spatial_index_type": c.spatial_index_type}
            for c in schema.columns]


def schema_from_json(cols: List[Dict[str, Any]]) -> Schema:
    return Schema([Column(c["name"], ColumnType[c["ctype"]],
                          dim=c["dim"], index=IndexKind[c["index"]],
                          spatial_index_type=c["spatial_index_type"])
                   for c in cols])


def fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def atomic_write_json(path: str, obj: Any) -> None:
    """Durable small-file write: temp + fsync + atomic rename + dir
    fsync. Used for the facade's db.json as well as manifests."""
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f, indent=1, sort_keys=True)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    fsync_dir(os.path.dirname(path) or ".")


class StoreDir:
    """Layout + manifest publish/load for one store's directory."""

    def __init__(self, root: str):
        self.root = root
        self.segments_dir = os.path.join(root, SEGMENTS_DIR)
        self.wal_dir = os.path.join(root, WAL_DIR)
        os.makedirs(self.segments_dir, exist_ok=True)
        os.makedirs(self.wal_dir, exist_ok=True)
        self.generation = self._latest_generation()

    # ------------------------------------------------------------ paths
    def segment_path(self, seg_id: int) -> str:
        return os.path.join(self.segments_dir, f"seg-{seg_id:08d}.npz")

    def _manifest_path(self, gen: int) -> str:
        return os.path.join(self.root, f"{MANIFEST_PREFIX}{gen:08d}.json")

    def _generations(self) -> List[int]:
        out = []
        for name in os.listdir(self.root):
            if name.startswith(MANIFEST_PREFIX) and name.endswith(".json"):
                out.append(int(name[len(MANIFEST_PREFIX):-5]))
        return sorted(out)

    def _latest_generation(self) -> int:
        gens = self._generations()
        return gens[-1] if gens else 0

    # ---------------------------------------------------------- publish
    def publish(self, state: Dict[str, Any],
                faults: FaultInjector = NO_FAULTS) -> int:
        """Atomically commit ``state`` as the next generation; returns
        the new generation number. Crash points bracket the rename so
        the recovery matrix can land on either side of the commit."""
        gen = self.generation + 1
        state = dict(state, version=FORMAT_VERSION, generation=gen)
        final = self._manifest_path(gen)
        tmp = final + ".tmp"
        with open(tmp, "w") as f:
            json.dump(state, f, indent=1, sort_keys=True)
            f.flush()
            os.fsync(f.fileno())
        faults.crash("manifest.publish")
        os.replace(tmp, final)
        faults.crash("manifest.after-rename")
        fsync_dir(self.root)
        self.generation = gen
        # keep the previous generation as a safety net, drop the rest
        for old in self._generations():
            if old < gen - 1:
                try:
                    os.remove(self._manifest_path(old))
                except OSError:
                    pass
        return gen

    # ------------------------------------------------------------- load
    def load_latest(self) -> Optional[Dict[str, Any]]:
        """Highest parseable generation (a crash between fsync(file) and
        dir-fsync can leave a truncated or missing newest file — fall
        back one generation rather than fail)."""
        for gen in reversed(self._generations()):
            try:
                with open(self._manifest_path(gen)) as f:
                    state = json.load(f)
            except (OSError, json.JSONDecodeError):
                continue
            self.generation = gen
            return state
        return None

    # --------------------------------------------------------------- gc
    def gc_orphans(self, live_files: List[str]) -> List[str]:
        """Remove segment files (and stale tmps) not referenced by the
        loaded manifest — debris from flushes/compactions that crashed
        before their publish. Returns removed names."""
        live = set(live_files)
        removed = []
        for name in sorted(os.listdir(self.segments_dir)):
            if name in live:
                continue
            try:
                os.remove(os.path.join(self.segments_dir, name))
                removed.append(name)
            except OSError:
                pass
        for name in os.listdir(self.root):
            if name.endswith(".json.tmp"):
                try:
                    os.remove(os.path.join(self.root, name))
                except OSError:
                    pass
        return removed


def segment_entry(seg) -> Dict[str, Any]:
    """Manifest record for one flushed segment."""
    return {"file": f"seg-{seg.seg_id:08d}.npz", "seg_id": int(seg.seg_id),
            "level": int(seg.level), "n_rows": int(seg.n_rows),
            "max_seqno": int(seg.seqno.max()) if seg.n_rows else -1}
