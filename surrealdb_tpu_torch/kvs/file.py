"""File-backed datastore: MVCC memstore + write-ahead log + snapshot.

Role of the reference's persistent backends (reference: core/src/kvs/
surrealkv/mod.rs, kvs/rocksdb/mod.rs — LSM stores with a WAL) behind the
same trait. Design:

- every commit batch appends ONE length+CRC-framed record batch to
  `<path>.wal` (append-only, O(batch) per commit — replacing the previous
  whole-database rewrite per flush);
- opening loads the `<path>` snapshot then replays intact WAL frames in
  order; a torn tail frame (crash mid-append) is detected by length/CRC and
  discarded, so a kill -9 loses at most transactions that had not finished
  their commit append;
- when the WAL outgrows max(snapshot size, SURREAL_WAL_COMPACT_MIN) the
  committing thread compacts: full snapshot to a temp file, atomic rename,
  WAL truncated.

Durability knob: SURREAL_SYNC_DATA=1 fsyncs the WAL on every commit
(power-loss safety); default is OS-buffered appends (process-crash safety),
matching the reference's default surrealkv configuration.
"""

from __future__ import annotations

import os
import struct
from surrealdb_tpu_torch.utils import locks as _locks
import zlib

from surrealdb_tpu_torch import cnf
from .api import BackendDatastore, BackendTransaction
from .mem import MemDatastore, MemTransaction

MAGIC = b"STPU1\n"
WAL_MAGIC = b"STPUW1\n"

# ---------------------------------------------------------------- versioning
# On-disk format versions (role of the reference's storage version gate +
# migration path, core/src/kvs/version/mod.rs + ds.rs:524): the snapshot
# magic encodes the version; opening an older-but-known version runs the
# registered migrations then rewrites the snapshot at CURRENT_VERSION.
KNOWN_MAGICS = {MAGIC: 1}
CURRENT_VERSION = 1
# {from_version: fn(snapshot_items) -> snapshot_items} — chained upward.
# v1 is the first released format, so the chain is empty today; the gate
# and `surreal upgrade` exist so a v2 change is a registry entry, not a
# breaking release.
MIGRATIONS: dict = {}


def storage_version(path: str) -> int:
    """Version of an on-disk datastore; raises on unrecognized files."""
    with open(path, "rb") as f:
        head = f.read(16)
    for magic, ver in KNOWN_MAGICS.items():
        if head.startswith(magic):
            return ver
    raise ValueError(f"{path} is not a surrealdb_tpu_torch datastore")
_TOMBSTONE = 0xFFFFFFFF


def _frame(writes) -> bytes:
    """Serialize one commit batch: u32 len | u32 crc | records."""
    parts = []
    for k, v in writes.items():
        if v is None:
            parts.append(struct.pack(">II", len(k), _TOMBSTONE))
            parts.append(k)
        else:
            parts.append(struct.pack(">II", len(k), len(v)))
            parts.append(k)
            parts.append(v)
    payload = b"".join(parts)
    return struct.pack(">II", len(payload), zlib.crc32(payload)) + payload


def _iter_frames(data: bytes, start: int):
    """Yield (payload, end_offset) for every intact frame; stops at the
    first torn/corrupt frame."""
    pos = start
    n = len(data)
    while pos + 8 <= n:
        ln, crc = struct.unpack_from(">II", data, pos)
        if pos + 8 + ln > n:
            return  # torn tail: frame body never fully landed
        payload = data[pos + 8 : pos + 8 + ln]
        if zlib.crc32(payload) != crc:
            return  # corrupt frame: discard it and everything after
        pos += 8 + ln
        yield payload, pos


def _iter_records(payload: bytes):
    pos = 0
    n = len(payload)
    while pos + 8 <= n:
        klen, vmark = struct.unpack_from(">II", payload, pos)
        pos += 8
        k = payload[pos : pos + klen]
        pos += klen
        if vmark == _TOMBSTONE:
            yield k, None
        else:
            v = payload[pos : pos + vmark]
            pos += vmark
            yield k, v


class FileDatastore(BackendDatastore):
    def __init__(self, path: str):
        self.path = path
        self.wal_path = path + ".wal"
        self.mem = MemDatastore()
        self._lock = _locks.Lock("kvs.file")
        self._wal_f = None
        self._wal_size = 0
        if os.path.exists(path):
            self._load_snapshot()
        if os.path.exists(self.wal_path):
            self._replay_wal()
        self._open_wal()

    # ------------------------------------------------------------ open
    def _load_snapshot(self) -> None:
        with open(self.path, "rb") as f:
            data = f.read()
        ver = None
        for magic, v in KNOWN_MAGICS.items():
            if data.startswith(magic):
                ver, pos = v, len(magic)
                break
        if ver is None:
            raise ValueError(f"{self.path} is not a surrealdb_tpu_torch datastore")
        n = len(data)
        items = []
        while pos < n:
            if pos + 8 > n:
                raise ValueError(
                    f"{self.path}: truncated snapshot record at byte {pos} "
                    "— run `surreal fix` to repair"
                )
            klen, vlen = struct.unpack_from(">II", data, pos)
            pos += 8
            if pos + klen + vlen > n:
                raise ValueError(
                    f"{self.path}: truncated snapshot record at byte {pos} "
                    "— run `surreal fix` to repair"
                )
            k = data[pos : pos + klen]
            pos += klen
            v = data[pos : pos + vlen]
            pos += vlen
            items.append((k, v))
        while ver < CURRENT_VERSION:
            items = MIGRATIONS[ver](items)
            ver += 1
        keys = []
        for k, v in items:
            self.mem.data[k] = [(0, v)]
            keys.append(k)
        self.mem.sorted_keys.update(keys)

    def _replay_wal(self) -> None:
        with open(self.wal_path, "rb") as f:
            data = f.read()
        if not data.startswith(WAL_MAGIC):
            return  # unrecognized/empty WAL: nothing intact to replay
        good_end = len(WAL_MAGIC)
        mem = self.mem
        new_keys = []
        for payload, end in _iter_frames(data, good_end):
            mem.version += 1
            ver = mem.version
            for k, v in _iter_records(payload):
                chain = mem.data.get(k)
                if chain is None:
                    mem.data[k] = [(ver, v)]
                    new_keys.append(k)
                else:
                    chain.append((ver, v))
            good_end = end
        mem.sorted_keys.update(new_keys)
        if good_end < len(data):
            # torn tail from a crash mid-append: truncate to the intact prefix
            with open(self.wal_path, "r+b") as f:
                f.truncate(good_end)

    def _open_wal(self) -> None:
        if not os.path.exists(self.wal_path):
            with open(self.wal_path, "wb") as f:
                f.write(WAL_MAGIC)
        self._wal_f = open(self.wal_path, "ab")
        self._wal_size = self._wal_f.tell()

    # ------------------------------------------------------------ commit path
    def append_commit(self, writes) -> None:
        """Called by FileTransaction.commit AFTER the mem apply, under the
        datastore lock (WAL frame order == commit version order)."""
        frame = _frame(writes)
        self._wal_f.write(frame)
        self._wal_f.flush()
        if cnf.SYNC_DATA:
            os.fsync(self._wal_f.fileno())
        self._wal_size += len(frame)
        if self._wal_size >= self._compact_threshold():
            self._compact()

    def _compact_threshold(self) -> int:
        try:
            snap = os.path.getsize(self.path)
        except OSError:
            snap = 0
        return max(snap, cnf.WAL_COMPACT_MIN)

    def _compact(self) -> None:
        """Snapshot the live state and truncate the WAL. Runs on the
        committing thread while holding the datastore lock."""
        with self.mem.lock:
            snapshot = [
                (k, chain[-1][1])
                for k, chain in self.mem.data.items()
                if chain[-1][1] is not None
            ]
        tmp = self.path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(MAGIC)
            for k, v in snapshot:
                f.write(struct.pack(">II", len(k), len(v)))
                f.write(k)
                f.write(v)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path)
        self._wal_f.close()
        with open(self.wal_path, "wb") as f:
            f.write(WAL_MAGIC)
            f.flush()
            os.fsync(f.fileno())
        self._open_wal()

    def transaction(self, write: bool) -> BackendTransaction:
        return FileTransaction(self, write)

    def close(self) -> None:
        with self._lock:
            if self._wal_f is not None:
                self._wal_f.flush()
                os.fsync(self._wal_f.fileno())
                self._wal_f.close()
                self._wal_f = None

    def flush(self) -> None:
        with self._lock:
            self._compact()


def repair(path: str) -> dict:
    """`surreal fix` (reference: src/cli/fix.rs): tolerantly re-read a
    possibly-damaged store — keep every intact snapshot record, drop the
    torn tail, replay every intact WAL frame — then rewrite a clean
    snapshot + empty WAL. Returns repair statistics."""
    stats = {"keys": 0, "snapshot_dropped_bytes": 0, "wal_frames": 0, "version": None}
    if not os.path.exists(path):
        raise ValueError(f"{path} does not exist")
    with open(path, "rb") as f:
        data = f.read()
    ver, pos = None, 0
    for magic, v in KNOWN_MAGICS.items():
        if data.startswith(magic):
            ver, pos = v, len(magic)
            break
    if data and ver is None:
        raise ValueError(f"{path} is not a surrealdb_tpu_torch datastore")
    stats["version"] = ver or CURRENT_VERSION
    items = {}
    n = len(data)
    while pos < n:
        if pos + 8 > n:
            break
        klen, vlen = struct.unpack_from(">II", data, pos)
        if pos + 8 + klen + vlen > n:
            break
        k = data[pos + 8 : pos + 8 + klen]
        v = data[pos + 8 + klen : pos + 8 + klen + vlen]
        items[k] = v
        pos += 8 + klen + vlen
    stats["snapshot_dropped_bytes"] = n - pos
    if ver is not None:
        lst = list(items.items())
        while ver < CURRENT_VERSION:
            lst = MIGRATIONS[ver](lst)
            ver += 1
        items = dict(lst)
    wal_path = path + ".wal"
    if os.path.exists(wal_path):
        with open(wal_path, "rb") as f:
            wal = f.read()
        if wal.startswith(WAL_MAGIC):
            for payload, _end in _iter_frames(wal, len(WAL_MAGIC)):
                stats["wal_frames"] += 1
                for k, v in _iter_records(payload):
                    if v is None:
                        items.pop(k, None)
                    else:
                        items[k] = v
    stats["keys"] = len(items)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(MAGIC)
        for k, v in sorted(items.items()):
            f.write(struct.pack(">II", len(k), len(v)))
            f.write(k)
            f.write(v)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    with open(wal_path, "wb") as f:
        f.write(WAL_MAGIC)
        f.flush()
        os.fsync(f.fileno())
    return stats


def upgrade(path: str) -> dict:
    """`surreal upgrade`: migrate an on-disk store to CURRENT_VERSION
    (a no-op rewrite when already current)."""
    before = storage_version(path)
    stats = repair(path)
    stats["from_version"], stats["to_version"] = before, CURRENT_VERSION
    return stats


class FileTransaction(MemTransaction):
    def __init__(self, store: FileDatastore, write: bool):
        super().__init__(store.mem, write)
        self.fstore = store

    def commit(self) -> None:
        writes = dict(self.writes)
        with self.fstore._lock:
            super().commit()  # raises TxConflictError before any WAL append
            if writes:
                self.fstore.append_commit(writes)
