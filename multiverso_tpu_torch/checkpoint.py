"""Checkpoint / resume — reference ``ServerTable::Store/Load`` over Streams
(SURVEY.md §5 "Checkpoint / resume", §2.27).

Port of ``multiverso_tpu/checkpoint.py``.  The file format is the JAX
package's, byte for byte: the same magic, CRC framing and pickle
protocol, and every tensor goes to disk as a numpy array (a table's
``store_state`` is already the JAX package's numpy dict).  A checkpoint
written by either package therefore restores in the other.  Trees are
walked by ``util.tree`` over dicts, lists and tuples.

The reference periodically dumps each server table shard through a Stream
and reloads it on restart.  Here a checkpoint is one atomic snapshot of
every registered table (weights + updater state, pulled from device), the
runtime clock, and optional app extras — written through the ``io`` Stream
seam so local/remote backends interchange.

Resume follows the reference's shape: the app re-creates its tables (same
kinds/shapes, same order), then ``restore()`` loads state back into them by
table name.  Several processes: only rank 0 writes; everyone syncs after.
"""

from __future__ import annotations

import json
import os
import pickle
import struct
import threading
import zlib
from typing import Any, Dict, List, Optional, Tuple

from .core import context as core_context
from .fault import RetryPolicy
from .io import StreamFactory
from .log import Log

__all__ = ["save", "restore", "save_pytree", "restore_pytree",
           "place_pytree", "save_pytree_async", "AsyncSave",
           "CheckpointCorrupt", "CheckpointManager"]

# v2 framing: magic + <uint64 body_len, uint32 crc32> + pickle body.
# The CRC turns "killed mid-write" / "bit-rotted storage" into a
# CheckpointCorrupt at restore time instead of a pickle crash (or,
# worse, silently-wrong weights).  v1 files (magic + bare pickle) are
# still readable — only without the integrity check.
_MAGIC = b"MVTPUCKPT2"
_MAGIC_TREE = b"MVTPUTREE2"
_MAGIC_V1 = b"MVTPUCKPT1"
_MAGIC_TREE_V1 = b"MVTPUTREE1"
_HEADER = struct.Struct("<QI")

# Transient-IO retry for every snapshot read/write (docs/
# fault_tolerance.md).  Module attribute so deployments (and the chaos
# suite) can swap the schedule.
IO_RETRY = RetryPolicy(attempts=3, backoff_s=0.05, retry_on=(OSError,))


class CheckpointCorrupt(ValueError):
    """The snapshot file is damaged (truncated, bit-flipped, or not a
    checkpoint at all) — restore refuses to unpickle garbage.  Catchable
    separately so callers (``CheckpointManager.restore_latest``) can
    fall back to the previous good snapshot.

    Constructing one is a flight-recorder trigger
    (docs/observability.md): even when ``restore_latest`` tolerates the
    corruption by falling back, the black box records that a snapshot
    rotted — silent corruption is exactly what a post-mortem needs."""

    def __init__(self, *args: Any) -> None:
        super().__init__(*args)
        try:
            from .ops.flight_recorder import recorder

            recorder.trigger(f"checkpoint_corrupt: "
                             f"{args[0] if args else ''}")
        except Exception:  # the trigger must never mask the corruption
            pass


def _write_snapshot(uri: str, magic: bytes, obj: Any) -> None:
    """THE one framing for every checkpoint file: magic + CRC32-framed
    pickle body, written through an atomic Stream (temp + rename),
    retried on transient IO errors."""
    body = pickle.dumps(obj, protocol=4)
    header = _HEADER.pack(len(body), zlib.crc32(body))

    def write() -> None:
        with StreamFactory.open(uri, "wb", atomic=True) as s:
            s.write(magic)
            s.write(header)
            s.write(body)

    IO_RETRY.run(write)


def _read_snapshot(uri: str, magic: bytes, what: str) -> Any:
    def read() -> bytes:
        with StreamFactory.open(uri, "rb") as s:
            return s.read()

    raw = IO_RETRY.run(read)
    legacy = _MAGIC_V1 if magic == _MAGIC else _MAGIC_TREE_V1
    if raw.startswith(magic):
        off = len(magic)
        if len(raw) < off + _HEADER.size:
            raise CheckpointCorrupt(
                f"{uri}: truncated {what} (header incomplete)")
        body_len, crc = _HEADER.unpack_from(raw, off)
        body = raw[off + _HEADER.size:off + _HEADER.size + body_len]
        if len(body) != body_len:
            raise CheckpointCorrupt(
                f"{uri}: truncated {what} ({len(body)} of {body_len} "
                f"body bytes — killed mid-write?)")
        if zlib.crc32(body) != crc:
            raise CheckpointCorrupt(
                f"{uri}: CRC mismatch in {what} body — storage "
                f"corruption; restore from an earlier snapshot")
    elif raw.startswith(legacy):
        body = raw[len(legacy):]  # pre-CRC file: no integrity check
    else:
        raise CheckpointCorrupt(f"{uri}: not a multiverso_tpu {what}")
    try:
        return pickle.loads(body)
    except Exception as exc:
        raise CheckpointCorrupt(
            f"{uri}: {what} body does not unpickle ({exc}) — corrupt "
            f"file") from exc


def _grouped() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def _rank() -> int:
    """This process's rank: the runtime's; before ``init()`` the process
    group's (a trainer on a mesh needs no runtime), or 0 in a job of one
    process."""
    if core_context.initialized():
        return core_context.get_context().node.rank
    if _grouped():
        import torch.distributed as dist

        return dist.get_rank()
    return 0


def _host_sync(name: str) -> None:
    if core_context.initialized():
        core_context.get_context().host_sync(name)
    elif _grouped():
        import torch.distributed as dist

        dist.barrier()


def _to_host(tree: Any) -> Any:
    """Every tensor leaf as a numpy array the snapshot owns; other leaves
    (scalars, strings, configs) pickle natively and round-trip with
    their own types."""
    import torch

    from .tables.base import host_fetch
    from .util.tree import tree_map

    return tree_map(
        lambda a: host_fetch(a) if isinstance(a, torch.Tensor) else a, tree)


def save_pytree(uri: str, tree: Any) -> None:
    """Snapshot an arbitrary tree of tensors (model params, optimizer
    state — anything that is NOT a registered table) to ``uri``.

    Same write discipline as :func:`save`: tensors materialize to the
    host as numpy arrays, rank 0 writes atomically, every rank syncs
    before returning.  Used by ``TransformerTrainer.save``.  Works
    before ``init()`` too, as a job of one process.
    """
    host_tree = _to_host(tree)
    if _rank() == 0:
        _write_snapshot(uri, _MAGIC_TREE, host_tree)
        Log.info("pytree checkpoint saved: %s", uri)
    _host_sync("mvtpu_pytree_save")


def restore_pytree(uri: str, like: Any = None) -> Any:
    """Load a pytree snapshot (numpy leaves).  With ``like`` (a tree of
    tensors), each loaded leaf becomes a tensor on the device of the
    matching ``like`` leaf, which must have its shape and dtype.

    Several processes: ``save_pytree`` writes on rank 0 only, but EVERY
    rank reads ``uri`` here — the path must resolve on all hosts (shared
    filesystem, or pre-distributed copies), the same broadcast seam
    :func:`restore` documents.

    Trust boundary: pickle body — restore only checkpoints you control
    (same caveat as :func:`restore`).
    """
    host_tree = _read_snapshot(uri, _MAGIC_TREE, "pytree snapshot")
    _host_sync("mvtpu_pytree_restore")
    if like is None:
        return host_tree
    return place_pytree(host_tree, like, uri)


def place_pytree(host_tree: Any, like: Any, source: str = "snapshot") -> Any:
    """A loaded tree of numpy leaves placed like ``like``: each leaf at a
    tensor of ``like`` becomes a tensor on that tensor's device, with its
    shape and dtype (or ``ValueError`` naming the leaf); other leaves
    stay as loaded.  Another structure raises ``ValueError`` naming
    ``source``."""
    import numpy as np
    import torch

    from .tables.base import host_put, numpy_dtype
    from .util.tree import keystr, tree_map_with_path

    class _LeafMismatch(ValueError):
        pass

    def place(path, h, ref):
        if not isinstance(ref, torch.Tensor):
            return h
        h = np.asarray(h)
        want = numpy_dtype(ref.dtype)
        if h.shape != tuple(ref.shape) or h.dtype != want:
            raise _LeafMismatch(
                f"snapshot leaf {keystr(path)} is "
                f"{h.shape}/{h.dtype} but the live tree expects "
                f"{tuple(ref.shape)}/{want} — wrong config/updater for "
                f"this checkpoint?")
        return host_put(h, ref.device)

    try:
        return tree_map_with_path(place, host_tree, like)
    except _LeafMismatch:
        raise
    except Exception as exc:
        raise ValueError(
            f"{source}: snapshot tree structure does not match the live "
            f"tree (different model config or updater?): {exc}") from exc


_STATUS_OK, _STATUS_ERR, _STATUS_PENDING = 0, 1, 2


def _exchange_status(status: int) -> int:
    """All-ranks agreement on the async writer's status — a collective
    (every rank's ``AsyncSave.result()`` calls it).  Rank 0 is the only
    writer, so its status is the one broadcast."""
    from .tables.base import _collective_device, is_multiprocess

    if not is_multiprocess():
        return status
    import torch
    import torch.distributed as dist

    t = torch.tensor([status], dtype=torch.int64,
                     device=_collective_device())
    dist.broadcast(t, src=0)
    return int(t.item())


class AsyncSave:
    """Handle for an in-flight :func:`save_pytree_async` write.

    ``result()`` joins the writer thread, re-raises any IO error, and
    host-syncs every rank — after it returns on all ranks the file is
    durable and safe to restore.  Dropping the handle without calling
    ``result()`` leaves a daemon thread that may still be writing at
    interpreter exit (the atomic temp+rename means a killed write never
    leaves a truncated file at the final path, just no file)."""

    def __init__(self, uri: str, thread: Optional[threading.Thread]):
        self._uri = uri
        self._thread = thread
        self._err: Optional[BaseException] = None

    def done(self) -> bool:
        return self._thread is None or not self._thread.is_alive()

    def result(self, timeout: Optional[float] = None) -> None:
        # Exchange the writer status across hosts BEFORE raising: if
        # rank 0 raised its IO error (or join timeout) here while the
        # other ranks went straight into the rendezvous below, they
        # would block in the barrier forever.  The broadcast is itself
        # a collective, so after it every rank takes the SAME exit:
        # return (file durable), raise the IO error, or raise
        # TimeoutError (write still in flight on rank 0 — the thread
        # keeps running; call result() again to re-join it).  Non-zero
        # ranks have no writer thread; they learn all three outcomes
        # from the broadcast.
        status = _STATUS_OK
        if self._thread is not None:
            self._thread.join(timeout)
            if self._thread.is_alive():
                status = _STATUS_PENDING
            elif self._err is not None:
                status = _STATUS_ERR
        status = _exchange_status(status)
        if status == _STATUS_PENDING:
            raise TimeoutError(
                f"checkpoint write still in flight: {self._uri}")
        if status == _STATUS_ERR:
            if self._err is not None:
                raise self._err
            raise IOError(
                "checkpoint write failed on rank 0 (see its log): "
                f"{self._uri}")
        # Same durability contract as the sync save: every rank agrees
        # the file exists before anyone restores it.
        _host_sync("mvtpu_pytree_async_save")


def save_pytree_async(uri: str, tree: Any) -> AsyncSave:
    """:func:`save_pytree` with the slow half off the critical path.

    The device→host fetch runs synchronously at the call point — it is
    the consistency-critical part (the snapshot is of the params AS OF
    this call) —
    then rank 0's pickle + stream write happens on a background thread
    while training continues.  For the ~seconds a multi-GB write takes,
    the train loop only pays the D2H copy.  Call ``result()`` on the
    returned handle (every rank) before restoring or shutting down.
    """
    host_tree = _to_host(tree)
    if _rank() != 0:
        return AsyncSave(uri, None)

    handle = AsyncSave(uri, None)

    def write():
        try:
            _write_snapshot(uri, _MAGIC_TREE, host_tree)
            Log.info("pytree checkpoint saved (async): %s", uri)
        except BaseException as exc:  # surfaced by result()
            handle._err = exc

    t = threading.Thread(target=write, name="mvtpu-ckpt-write", daemon=True)
    handle._thread = t
    t.start()
    return handle


def save(uri: str, extra: Optional[Dict[str, Any]] = None) -> None:
    """Snapshot all registered tables + clock to ``uri`` (one file).

    Several processes: EVERY process materializes the snapshot (the
    sharded tables gather their blocks, a collective) as in the JAX
    package; only rank 0 writes it.  The snapshot holds each table's
    live region, so it restores at any world size and into the JAX
    package, and each rank of a restore takes its own block.
    The local write goes to a temp file and renames into place, so a
    crash mid-write never leaves a truncated file at the final path.
    """
    ctx = core_context.get_context()
    # Every rank runs it together, as in the JAX package.
    tables_snap = {t.name: t.store_state() for t in ctx.tables()}
    if ctx.node.rank == 0:
        snap = {
            "clock": ctx.clock,
            "extra": extra or {},
            "tables": tables_snap,
        }
        _write_snapshot(uri, _MAGIC, snap)
        Log.info("checkpoint saved: %s (%d tables, clock=%d)",
                 uri, len(snap["tables"]), ctx.clock)
    ctx.host_sync("mvtpu_checkpoint_save")


def restore(uri: str, strict: bool = True) -> Dict[str, Any]:
    """Load a snapshot into the currently registered tables (matched by
    name).  Returns the ``extra`` dict stored at save time.

    ``strict=True`` raises if any registered table has no snapshot entry or
    vice versa (the reference's Load aborts on shard mismatch).

    Trust boundary: the snapshot body is a pickle — restoring a
    checkpoint executes code chosen by whoever wrote the file.  Only
    restore checkpoints from storage you control, exactly as you would
    only load model weights you trust.

    Several processes: every process reads ``uri`` (the reference's HDFS model —
    checkpoint storage is shared); rank-0-only distribution of the bytes
    would need a broadcast seam here.
    """
    ctx = core_context.get_context()
    snap = _read_snapshot(uri, _MAGIC, "checkpoint")

    tables = {t.name: t for t in ctx.tables()}
    missing = set(tables) - set(snap["tables"])
    orphaned = set(snap["tables"]) - set(tables)
    if strict and (missing or orphaned):
        raise ValueError(
            f"checkpoint/table mismatch: tables without snapshot entries "
            f"{sorted(missing)}; snapshot entries without tables "
            f"{sorted(orphaned)} (re-create tables before restore, or pass "
            f"strict=False)")
    for name in set(tables) & set(snap["tables"]):
        t = tables[name]
        # Stale pre-restore BSP buffers must not apply on top of restored
        # weights at the next barrier.
        t.discard_pending()
        t.load_state(snap["tables"][name])
    ctx.clock = int(snap["clock"])
    ctx.host_sync("mvtpu_checkpoint_restore")
    Log.info("checkpoint restored: %s (%d tables, clock=%d)",
             uri, len(snap["tables"]), ctx.clock)
    return snap["extra"]


class CheckpointManager:
    """Rolling snapshots behind an atomic MANIFEST — crash-safe resume.

    ``save_step(step)`` writes one :func:`save` snapshot per call into
    ``directory``, records it in ``MANIFEST.json`` (written atomically,
    AFTER the snapshot is durable), and prunes beyond ``keep`` — so the
    directory always holds N known-good restore points and a torn write
    can never be the only copy.  ``restore_latest()`` walks the manifest
    newest-first and FALLS BACK past corrupt/missing snapshots
    (:class:`CheckpointCorrupt` per file is logged, not fatal) to the
    last good one — a job killed mid-write resumes from the previous
    step instead of dying on a half-written file.

    Several processes: rank 0 owns the manifest and pruning; :func:`save` /
    :func:`restore` carry their own collectives and fences.
    """

    MANIFEST = "MANIFEST.json"

    def __init__(self, directory: str, keep: Optional[int] = None,
                 prefix: str = "step"):
        from . import config

        self.directory = directory
        self.keep = int(config.get("ckpt_keep")) if keep is None else keep
        if self.keep < 1:
            raise ValueError(f"keep must be >= 1, got {self.keep}")
        self.prefix = prefix
        os.makedirs(directory, exist_ok=True)

    # -- manifest ----------------------------------------------------------
    def _manifest_path(self) -> str:
        return os.path.join(self.directory, self.MANIFEST)

    def _entries(self) -> List[Dict[str, Any]]:
        """Manifest entries, oldest first.  A damaged/absent manifest is
        rebuilt from the snapshot files on disk (the manifest is an
        index, never the only source of truth)."""
        try:
            with StreamFactory.open(self._manifest_path(), "rb") as s:
                entries = json.loads(s.read().decode("utf-8"))
            if isinstance(entries, list):
                return entries
        except (OSError, ValueError):
            pass
        entries = []
        try:
            names = sorted(os.listdir(self.directory))
        except OSError:
            return entries
        for name in names:
            if name.startswith(f"{self.prefix}_") and name.endswith(".ckpt"):
                try:
                    step = int(name[len(self.prefix) + 1:-len(".ckpt")])
                except ValueError:
                    continue
                entries.append({"step": step, "file": name})
        entries.sort(key=lambda e: e["step"])
        return entries

    def _write_manifest(self, entries: List[Dict[str, Any]]) -> None:
        def write() -> None:
            with StreamFactory.open(self._manifest_path(), "wb",
                                    atomic=True) as s:
                s.write(json.dumps(entries).encode("utf-8"))

        IO_RETRY.run(write)

    def steps(self) -> List[int]:
        return [int(e["step"]) for e in self._entries()]

    def _uri(self, name: str) -> str:
        return os.path.join(self.directory, name)

    # -- save / restore ----------------------------------------------------
    def save_step(self, step: int,
                  extra: Optional[Dict[str, Any]] = None) -> str:
        """Snapshot all tables as snapshot ``step``; returns its path."""
        ctx = core_context.get_context()
        name = f"{self.prefix}_{step:010d}.ckpt"
        uri = self._uri(name)
        merged = dict(extra or {})
        merged["__step__"] = step
        save(uri, extra=merged)  # collective; durable after this returns
        if ctx.node.rank == 0:
            entries = [e for e in self._entries() if e["file"] != name]
            entries.append({"step": step, "file": name})
            entries.sort(key=lambda e: e["step"])
            pruned, entries = entries[:-self.keep], entries[-self.keep:]
            # Manifest first (atomic rename): from this instant the new
            # snapshot is the restore point; only THEN drop old files.
            self._write_manifest(entries)
            for e in pruned:
                try:
                    os.unlink(self._uri(e["file"]))
                except OSError:
                    pass  # e.g. non-local scheme; stale files are benign
        ctx.host_sync("mvtpu_ckpt_manager_save")
        return uri

    def restore_latest(self, strict: bool = True) -> Tuple[int, Dict[str, Any]]:
        """Restore the newest GOOD snapshot; returns ``(step, extra)``.

        Corrupt or missing snapshots are skipped (with an error log) in
        favor of the previous entry; raises :class:`CheckpointCorrupt`
        only when no snapshot in the manifest restores.
        """
        entries = self._entries()
        for e in reversed(entries):
            uri = self._uri(e["file"])
            try:
                extra = restore(uri, strict=strict)
            except (CheckpointCorrupt, OSError) as exc:
                Log.error("CheckpointManager: snapshot %s unusable (%s); "
                          "falling back to the previous one", uri, exc)
                continue
            step = int(extra.pop("__step__", e["step"]))
            Log.info("CheckpointManager: resumed from step %d (%s)",
                     step, uri)
            return step, extra
        raise CheckpointCorrupt(
            f"{self.directory}: no restorable snapshot among "
            f"{[e['file'] for e in entries]}")
