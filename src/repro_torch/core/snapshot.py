"""Checkpoint/restore of live table state — versioned, checksummed, bit-exact.

The port of ``repro.core.snapshot``, writing and reading the same
``WCSNAP1`` format byte for byte::

    WCSNAP1\\n                      # magic line
    {json header}\\n                # version, kind, config, array manifest,
                                    # payload_nbytes, payload_sha256
    <payload>                       # concatenated C-order array bytes

For the open-addressing tables (single-value, and so the counting table
and the hash set; multi-value) the header carries the JAX package's kind,
static-field names in its order, and arrays ``store/keys`` /
``store/values`` (u32, written from the port's bit-identical int32 planes)
and ``count`` (an i32 scalar).  The port has no ``backend`` field: it
writes ``"jax"`` (the JAX engine, whose planes the port's bulk engines
replay) and accepts any backend on restore.  So a file written by
``repro.core.snapshot.save`` restores bit-exact into a port table, a file
written here restores bit-exact into a JAX table, and a JAX ``"jax"``
table and its port twin serialize to the same bytes.

Every validation failure (bad magic, truncated header or payload, sha256
mismatch, wrong version, a missing field) raises :class:`SnapshotError`:
a damaged snapshot never restores into a silently wrong table.  Writes are
atomic (temp file + ``os.replace``).  :class:`SnapshotWriter` is the
async double-buffered writer: ``save`` copies the table to host memory at
once (the caller may then update its tensors in place) and hands
serialization, hashing and disk I/O to a background thread; a newer save
for the same path supersedes a queued one (latest wins).

Registry counters (``obs.registry.REGISTRY``): ``snapshot.saves``,
``snapshot.restores``, ``snapshot.bytes_written``,
``snapshot.saves_superseded``.  Bucket-list snapshots are not ported
(ROADMAP.md queue 1 item 8).
"""

from __future__ import annotations

import hashlib
import json
import os
import threading

import numpy as np

from repro_torch.core import convert
from repro_torch.core import multi_value as mv
from repro_torch.core import single_value as sv
from repro_torch.core.common import to_numpy_u32
from repro_torch.obs.registry import REGISTRY

SNAPSHOT_VERSION = 1
MAGIC = b"WCSNAP1\n"

#: dtypes a snapshot may carry (closed set: restore never eval()s a dtype)
_DTYPES = {"uint32": np.uint32, "int32": np.int32, "uint8": np.uint8,
           "float32": np.float32, "bool": np.bool_}

#: the JAX tables' static fields, in their dataclass order
_STATICS = ("num_rows", "window", "key_words", "value_words", "scheme",
            "layout", "seed", "max_probes", "backend")

#: the ``backend`` the port writes (any is accepted on restore)
BACKEND = "jax"

_KINDS = {"single_value": (sv.SingleValueHashTable, convert.table_from_numpy),
          "multi_value": (mv.MultiValueHashTable,
                          convert.multi_table_from_numpy)}

_ITEM_8 = ("bucket-list snapshots are not ported to repro_torch yet: see "
           "ROADMAP.md queue 1 item 8 (growth, snapshots and telemetry)")


class SnapshotError(ValueError):
    """A snapshot failed validation (torn write, corruption, bad version).

    Raised for *any* payload that cannot be proven intact — restoring a
    damaged snapshot must be loud, never a silently wrong table.
    """


def kind_of(table) -> str:
    """The snapshot kind string of a table (the counting table and the
    hash set are single-value tables, so they snapshot as
    ``single_value``)."""
    for name, (cls, _) in _KINDS.items():
        if type(table) is cls:
            return name
    from repro_torch.core import bucket_list as bl
    if type(table) is bl.BucketListHashTable:
        raise NotImplementedError(_ITEM_8)
    raise TypeError(f"cannot snapshot object of type {type(table).__name__}; "
                    f"supported: {sorted(_KINDS)}")


# ---------------------------------------------------------------------------
# flatten / rebuild
# ---------------------------------------------------------------------------

def _collect(table) -> tuple[dict, list]:
    """(config node, [(name, numpy array)]): host copies, so the table's
    tensors may change as soon as this returns."""
    kind = kind_of(table)
    static = {f: getattr(table, f) for f in _STATICS[:-1]}
    static["backend"] = BACKEND
    arrays = [("store/keys", to_numpy_u32(table.store["keys"])),
              ("store/values", to_numpy_u32(table.store["values"])),
              ("count", np.asarray(table.count, dtype=np.int32))]
    return {"kind": kind, "static": static, "nested": {}}, arrays


def _rebuild(cfg: dict, arrays: dict, device):
    kind = cfg.get("kind")
    if kind == "bucket_list":
        raise NotImplementedError(_ITEM_8)
    if kind not in _KINDS:
        raise SnapshotError(f"unknown table kind {kind!r} "
                            f"(supported: {sorted(_KINDS)})")
    static = cfg.get("static", {})
    for f in _STATICS:
        if f not in static:
            raise SnapshotError(f"snapshot header missing static field "
                                f"{f!r} of {kind}")
    for name in ("store/keys", "store/values", "count"):
        if name not in arrays:
            raise SnapshotError(f"snapshot payload missing array {name!r}")
    sv.check_ported(static["key_words"], static["value_words"],
                    static["scheme"], static["layout"], (0, 1, 2))
    return _KINDS[kind][1](
        arrays["store/keys"], arrays["store/values"], int(arrays["count"]),
        num_rows=static["num_rows"], window=static["window"],
        scheme=static["scheme"], seed=static["seed"],
        max_probes=static["max_probes"], device=device)


# ---------------------------------------------------------------------------
# bytes codec
# ---------------------------------------------------------------------------

def _encode(cfg: dict, arrays: list) -> bytes:
    manifest, chunks, offset = [], [], 0
    for name, arr in arrays:
        raw = np.ascontiguousarray(arr).tobytes()
        manifest.append({"name": name, "dtype": arr.dtype.name,
                         "shape": list(arr.shape), "offset": offset})
        chunks.append(raw)
        offset += len(raw)
    payload = b"".join(chunks)
    header = {"version": SNAPSHOT_VERSION, "kind": cfg["kind"], "config": cfg,
              "arrays": manifest, "payload_nbytes": len(payload),
              "payload_sha256": hashlib.sha256(payload).hexdigest()}
    return MAGIC + json.dumps(header).encode() + b"\n" + payload


def snapshot_bytes(table) -> bytes:
    """Serialize a table to the versioned snapshot byte format."""
    return _encode(*_collect(table))


def _parse(data: bytes) -> tuple[dict, bytes]:
    """Validate the blob end to end; raises SnapshotError on any damage."""
    if not data.startswith(MAGIC):
        raise SnapshotError(
            "not a warpcore snapshot (bad magic; expected a WCSNAP1 file)")
    nl = data.find(b"\n", len(MAGIC))
    if nl < 0:
        raise SnapshotError("torn snapshot: truncated inside the header "
                            "(no header terminator) — refusing to restore")
    try:
        header = json.loads(data[len(MAGIC):nl].decode())
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise SnapshotError(f"corrupted snapshot header ({e}) — refusing "
                            "to restore") from e
    if not isinstance(header, dict):
        raise SnapshotError("corrupted snapshot header (not an object)")
    if header.get("version") != SNAPSHOT_VERSION:
        raise SnapshotError(
            f"unsupported snapshot version {header.get('version')!r} "
            f"(this build reads version {SNAPSHOT_VERSION})")
    payload = data[nl + 1:]
    want = header.get("payload_nbytes")
    if len(payload) != want:
        raise SnapshotError(
            f"torn snapshot: payload is {len(payload)} bytes, header "
            f"promises {want} — truncated or over-long write, refusing to "
            "restore")
    if hashlib.sha256(payload).hexdigest() != header.get("payload_sha256"):
        raise SnapshotError(
            "corrupted snapshot: payload sha256 mismatch (bit rot or torn "
            "concurrent write) — refusing to restore a silently wrong table")
    return header, payload


def restore_bytes(data: bytes, device=None):
    """Rebuild the bit-exact table from snapshot bytes (either package's)
    on ``device`` (None: the CUDA card)."""
    header, payload = _parse(data)
    arrays = {}
    for ent in header.get("arrays", []):
        dt = _DTYPES.get(ent["dtype"])
        if dt is None:
            raise SnapshotError(f"snapshot array {ent['name']!r} has "
                                f"unsupported dtype {ent['dtype']!r}")
        shape = tuple(ent["shape"])
        nbytes = int(np.prod(shape, dtype=np.int64)) * np.dtype(dt).itemsize
        off = ent["offset"]
        if off + nbytes > len(payload):
            raise SnapshotError(f"torn snapshot: array {ent['name']!r} "
                                "extends past the payload")
        arrays[ent["name"]] = np.frombuffer(
            payload[off:off + nbytes], dtype=dt).reshape(shape)
    table = _rebuild(header.get("config", {}), arrays, device)
    REGISTRY.counter("snapshot.restores").inc(1)
    return table


# ---------------------------------------------------------------------------
# file layer (atomic) + async double-buffered writer
# ---------------------------------------------------------------------------

def _atomic_write(path: str, data: bytes) -> None:
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _write(collected, path: str) -> int:
    data = _encode(*collected)
    _atomic_write(path, data)
    REGISTRY.counter("snapshot.saves").inc(1)
    REGISTRY.counter("snapshot.bytes_written").inc(len(data))
    return len(data)


def save(table, path: str) -> int:
    """Snapshot ``table`` to ``path`` atomically; returns bytes written."""
    return _write(_collect(table), path)


def load(path: str, device=None):
    """Restore a table from a snapshot file (see ``restore_bytes``)."""
    try:
        with open(path, "rb") as f:
            data = f.read()
    except FileNotFoundError as e:
        raise SnapshotError(
            f"missing snapshot file {path!r} — torn multi-file checkpoint "
            "or wrong directory") from e
    return restore_bytes(data, device)


class SnapshotWriter:
    """Async double-buffered snapshot writer.

    ``save(table, path)`` copies the table to host memory *synchronously*
    (after it returns the caller may update the table's tensors in place)
    and queues serialization + disk I/O on a background thread.  One write
    is in flight and at most one is queued *per destination path*;
    queueing a newer save for the same path supersedes the queued one,
    while a multi-file checkpoint (one snapshot per shard,
    ``serving.elastic.save``) keeps every distinct file.  Writes are
    atomic, so a crash between saves leaves the last *completed* snapshot
    readable.

    ``flush()`` blocks until everything queued has hit the disk and
    re-raises any background failure; ``close()`` flushes and stops the
    thread.  Usable as a context manager.
    """

    def __init__(self):
        self._cv = threading.Condition()
        self._queued: dict = {}             # path -> host copy
        self._busy = False
        self._stop = False
        self._error: BaseException | None = None
        self._thread = threading.Thread(target=self._worker, daemon=True,
                                        name="snapshot-writer")
        self._thread.start()

    def _worker(self) -> None:
        while True:
            with self._cv:
                while not self._queued and not self._stop:
                    self._cv.wait()
                if not self._queued and self._stop:
                    return
                path = next(iter(self._queued))   # FIFO by insertion order
                collected = self._queued.pop(path)
                self._busy = True
            try:
                _write(collected, path)
            except BaseException as e:          # surfaced on flush/close
                with self._cv:
                    self._error = e
            finally:
                with self._cv:
                    self._busy = False
                    self._cv.notify_all()

    def save(self, table, path: str) -> None:
        """Queue an async snapshot of ``table`` (host copy taken now)."""
        collected = _collect(table)
        with self._cv:
            if self._error is not None:
                err, self._error = self._error, None
                raise err
            if self._stop:
                raise RuntimeError("SnapshotWriter is closed")
            if path in self._queued:
                REGISTRY.counter("snapshot.saves_superseded").inc(1)
                del self._queued[path]        # re-insert at FIFO tail
            self._queued[path] = collected
            self._cv.notify_all()

    def flush(self) -> None:
        """Block until all queued writes are durable; re-raise failures."""
        with self._cv:
            while self._queued or self._busy:
                self._cv.wait()
            if self._error is not None:
                err, self._error = self._error, None
                raise err

    def close(self) -> None:
        self.flush()
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        self._thread.join(timeout=60)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
