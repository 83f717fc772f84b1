"""Sharded pseudo-label record store.

The port's own copy of the JAX package's ``data/pseudo_store.py``; a store
either package writes, the other reads, byte for byte:

* a store is a directory of ``shard-AAAAA-of-BBBBB.pdrec`` files;
* each shard is a sequence of length-prefixed records
  ``[u32 magic][u32 len][payload]`` (little-endian ``<II``) where payload is
  a dict pickled with protocol 4 (``image_id`` key required, RLE masks
  stored as compact dicts from ``utils/rle.py``);
* every shard has a sidecar ``.idx`` (image_id -> (offset, length), pickled
  with protocol 4) for O(1) random access and fast startup;
* writers are append-only and crash-safe: on reopen the shard tail is
  scanned, a trailing partial record is truncated, and writing resumes;
* partitioning is by shard: N processes each own one shard.
"""

from __future__ import annotations

import os
import pickle
import struct
from typing import Any, Dict, Iterator, List, Optional

__all__ = ["ShardWriter", "PseudoLabelStore", "shard_name",
           "mark_shard_complete", "store_complete"]

_MAGIC = 0x5044524B  # "PDRK"
_HEADER = struct.Struct("<II")


def shard_name(index: int, total: int) -> str:
    return f"shard-{index:05d}-of-{total:05d}.pdrec"


def _idx_path(shard_path: str) -> str:
    return shard_path + ".idx"


def mark_shard_complete(store_dir: str, shard_index: int, num_shards: int):
    """Atomically drop a per-shard completion marker.

    Producer stages call this when their shard's input list is exhausted.
    Downstream continuous consumers (``dcrf --watch``) use ``store_complete``
    to decide when no more records can arrive — the explicit-protocol
    replacement for the reference's dCRF workers that poll forever
    (continuously_postprocess_dcrf.py:121-127) and are killed by hand.
    """
    marker = os.path.join(
        store_dir, shard_name(shard_index, num_shards) + ".done")
    tmp = marker + ".tmp"
    open(tmp, "wb").close()
    os.replace(tmp, marker)


def store_complete(store_dir: str) -> bool:
    """True iff some shard total N has all N completion markers present."""
    if not os.path.isdir(store_dir):
        return False
    totals: Dict[int, set] = {}
    for n in os.listdir(store_dir):
        if not n.endswith(".pdrec.done"):
            continue
        try:
            stem = n[: -len(".pdrec.done")]  # shard-AAAAA-of-BBBBB
            _, idx, _, total = stem.split("-")
            totals.setdefault(int(total), set()).add(int(idx))
        except ValueError:
            continue
    return any(len(done) >= total for total, done in totals.items())


def _scan_shard(path: str, truncate: bool = False) -> Dict[str, tuple]:
    """Rebuild the index by scanning.

    ``truncate=True`` (the owning ShardWriter reopening after a crash) also
    removes a trailing partial record so appends resume from a clean tail.
    Readers must NOT truncate: a concurrent producer may be mid-append to
    this shard (the ``dcrf --watch`` job shape), and a reader truncating its
    in-flight record would corrupt the store. Readers just ignore the tail.
    """
    index: Dict[str, tuple] = {}
    size = os.path.getsize(path)
    with open(path, "r+b" if truncate else "rb") as f:
        offset = 0
        while offset + _HEADER.size <= size:
            f.seek(offset)
            magic, length = _HEADER.unpack(f.read(_HEADER.size))
            if magic != _MAGIC or offset + _HEADER.size + length > size:
                break  # partial/corrupt tail
            payload = f.read(length)
            try:
                record = pickle.loads(payload)
            except Exception:
                break
            index[record["image_id"]] = (offset, _HEADER.size + length)
            offset += _HEADER.size + length
        if truncate and offset < size:
            f.truncate(offset)
    return index


class ShardWriter:
    """Append-only writer for one shard; idempotent across restarts."""

    def __init__(self, store_dir: str, shard_index: int, num_shards: int):
        os.makedirs(store_dir, exist_ok=True)
        self.path = os.path.join(store_dir, shard_name(shard_index, num_shards))
        # A resumed producer invalidates any completion claim from a prior
        # finished run: without this, a concurrently launched `dcrf --watch`
        # would see store_complete() immediately, drain the existing records
        # and exit while this run is still appending — silently dropping the
        # late records. Completeness is only asserted by the CURRENT run's
        # mark_shard_complete call.
        stale_marker = self.path + ".done"
        if os.path.exists(stale_marker):
            os.remove(stale_marker)
        if os.path.exists(self.path):
            self._index = _scan_shard(self.path, truncate=True)
        else:
            open(self.path, "wb").close()
            self._index = {}
        self._f = open(self.path, "ab")

    @property
    def written_ids(self):
        return self._index.keys()

    def __contains__(self, image_id: str) -> bool:
        return image_id in self._index

    def write(self, record: Dict[str, Any]) -> bool:
        """Returns False if image_id already present (resume skip)."""
        image_id = record["image_id"]
        if image_id in self._index:
            return False
        payload = pickle.dumps(record, protocol=4)
        offset = self._f.tell()
        self._f.write(_HEADER.pack(_MAGIC, len(payload)))
        self._f.write(payload)
        self._index[image_id] = (offset, _HEADER.size + len(payload))
        return True

    def flush(self):
        self._f.flush()
        with open(_idx_path(self.path) + ".tmp", "wb") as f:
            pickle.dump(self._index, f, protocol=4)
        os.replace(_idx_path(self.path) + ".tmp", _idx_path(self.path))

    def close(self):
        self.flush()
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class PseudoLabelStore:
    """Read view over a store directory (all shards)."""

    def __init__(self, store_dir: str):
        self.store_dir = store_dir
        self._shards: List[str] = sorted(
            os.path.join(store_dir, n)
            for n in os.listdir(store_dir)
            if n.endswith(".pdrec")
        ) if os.path.isdir(store_dir) else []
        self._index: Dict[str, tuple] = {}  # image_id -> (shard_path, offset, length)
        for path in self._shards:
            idx_file = _idx_path(path)
            if os.path.exists(idx_file):
                with open(idx_file, "rb") as f:
                    shard_index = pickle.load(f)
            else:
                shard_index = _scan_shard(path)
            for image_id, (offset, length) in shard_index.items():
                self._index[image_id] = (path, offset, length)

    def __len__(self) -> int:
        return len(self._index)

    def __contains__(self, image_id: str) -> bool:
        return image_id in self._index

    def ids(self):
        return self._index.keys()

    def get(self, image_id: str) -> Optional[Dict[str, Any]]:
        entry = self._index.get(image_id)
        if entry is None:
            return None
        path, offset, length = entry
        with open(path, "rb") as f:
            f.seek(offset + _HEADER.size)
            return pickle.loads(f.read(length - _HEADER.size))

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        for path in self._shards:
            with open(path, "rb") as f:
                data = f.read()
            offset = 0
            while offset + _HEADER.size <= len(data):
                magic, length = _HEADER.unpack_from(data, offset)
                if magic != _MAGIC or offset + _HEADER.size + length > len(data):
                    break
                yield pickle.loads(data[offset + _HEADER.size : offset + _HEADER.size + length])
                offset += _HEADER.size + length
