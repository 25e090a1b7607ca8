"""Table base class — the port of ``multiverso_tpu/tables/base.py``.

Reference (SURVEY.md §2.10, ``table_interface.h``): a table is a
worker-side stub (``WorkerTable::{Get,Add,Partition,Wait,Notify}``) plus
server-side shards (``ServerTable::{ProcessGet,ProcessAdd,Store,Load}``)
connected by request/reply messages.

PyTorch redesign: **the worker/server split disappears into device
memory.**  A table owns

- ``_data``  — a ``torch.Tensor`` on the context's device (the "server
  shard"),
- ``_state`` — the updater's state tensors, shaped like ``_data``,

and two execution paths:

- the *eager parity path* — ``get()``/``add()`` with host arrays, matching
  the reference C-API semantics (used by the bindings and the ported apps);
- the *fused path* — ``raw_value()``/``raw_assign()`` handing the tensors
  to a training step so Get/Add/update run on the device with no host hop.

An apply is the functional updater call (``(w, state, delta, opt) ->
(w', state')``, fresh tensors) under ``_lock``, which then swaps
``_data``/``_state`` — where the JAX package runs a jitted apply that
donates the old buffers.

Sync (BSP) vs async (ASP) semantic mapping (SURVEY.md §7 hard-parts):
``sync=False`` (ASP default) applies every ``add`` immediately.
``sync=True`` (BSP) buffers adds for the current clock; ``flush()`` —
triggered by ``barrier()``, i.e. the clock boundary — aggregates and
applies them in one updater call, exactly the reference sync-server
behavior of holding replies until all adds for clock *t* arrive.

Several processes (a ``torch.distributed`` group of W ranks): the
dense tables (array, matrix, sparse matrix) are **sharded** — each rank
holds one contiguous block of ``_data`` and of every state tensor on its
own device (``self.shard``, a ``parallel.sharding.TableShard``), as the
JAX package shards them over its table mesh.  Eager ops are lockstep
collectives: a dense add is a ``reduce_scatter`` of the padded delta
after which each rank applies the updater to its own block (the
reference server's ``ProcessAdd`` on its shard); a whole-table read is an
``all_gather`` of the blocks trimmed to the live region (the JAX
package's ``process_allgather``).  Every ``get()`` then returns what the
JAX package's global array holds after the same adds.
"""

from __future__ import annotations

import threading
from typing import Any, Optional

import numpy as np
import torch

from .. import config, dashboard, fault, metrics, tracing
from ..core import context as core_context
from ..parallel.sharding import is_multiprocess
from ..updaters import AddOption, get_updater

__all__ = ["Table", "host_fetch", "host_put", "is_multiprocess",
           "bucket_size", "multihost_sum", "multihost_allgather_list",
           "shard_allgather", "shard_reduce_scatter", "device_sum"]


def bucket_size(k: int, floor: int = 8) -> int:
    """Round ``k`` up to a power-of-two bucket (shape-stable collectives:
    a few padded gather shapes instead of one per length)."""
    b = floor
    while b < k:
        b *= 2
    return b


def torch_dtype(dtype: Any) -> torch.dtype:
    """The torch dtype of a numpy dtype (or name)."""
    return torch.from_numpy(np.empty(0, dtype=np.dtype(dtype))).dtype


def numpy_dtype(dtype: Any) -> np.dtype:
    """A table dtype given as a numpy dtype, a name or a torch dtype, as
    the numpy dtype the host paths coerce with."""
    if isinstance(dtype, torch.dtype):
        try:
            return torch.empty(0, dtype=dtype).numpy().dtype
        except TypeError:
            raise ValueError(
                f"table dtype {dtype} has no numpy equivalent; the host "
                f"paths coerce deltas with numpy") from None
    return np.dtype(dtype)


def host_fetch(arr: torch.Tensor) -> np.ndarray:
    """Device->host materialization: a numpy array the caller owns.

    On a CPU tensor ``Tensor.numpy()`` is a view of the table's own
    storage, so the CPU case copies — a caller mutating what it got must
    never corrupt the table (``jax.device_get`` never aliases either).
    A copy of this process's tensor only: a sharded table's whole value
    is ``Table._fetch`` (a collective).
    """
    t = arr.detach()
    out = t.cpu().numpy()
    return out.copy() if t.device.type == "cpu" else out


def _collective_device() -> torch.device:
    """Where a collective's buffers must live for the group's backend."""
    import torch.distributed as dist

    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def shard_allgather(local: torch.Tensor, shard) -> torch.Tensor:
    """Every rank's block of a sharded tensor, in rank order along dim 0
    (``shard.padded`` rows), on the collective device (a collective).
    Under gloo a card's block is staged through the host."""
    import torch.distributed as dist

    dev = _collective_device()
    send = local.detach().to(dev).contiguous()
    out = torch.empty((shard.padded,) + tuple(send.shape[1:]),
                      dtype=send.dtype, device=dev)
    dist.all_gather_into_tensor(out, send)
    return out


def shard_reduce_scatter(padded: np.ndarray, shard,
                         device: torch.device) -> torch.Tensor:
    """This rank's block of the sum over ranks of each rank's padded host
    array (``shard.padded`` rows), on ``device`` (a collective)."""
    import torch.distributed as dist

    dev = _collective_device()
    send = torch.from_numpy(np.ascontiguousarray(padded)).to(dev)
    out = torch.empty((shard.size,) + tuple(send.shape[1:]),
                      dtype=send.dtype, device=dev)
    dist.reduce_scatter_tensor(out, send, op=dist.ReduceOp.SUM)
    return out.to(device)


def device_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum over ranks of a tensor, on its own device (a collective;
    staged through the host under gloo).  ``t`` is left as it was."""
    import torch.distributed as dist

    x = t.detach().to(_collective_device(), copy=True)
    dist.all_reduce(x, op=dist.ReduceOp.SUM)
    return x.to(t.device)


def multihost_sum(host_delta: np.ndarray) -> np.ndarray:
    """Sum per-process host arrays across processes (collective): every
    process gets the identical sum (a sharded matrix's row read sums the
    ranks' owner-filled buffers with it).  In one process this is the
    identity; under several every process MUST call it in lockstep.
    """
    if not is_multiprocess():
        return host_delta
    import torch.distributed as dist

    t = torch.from_numpy(np.array(host_delta, copy=True)).to(
        _collective_device())
    dist.all_reduce(t, op=dist.ReduceOp.SUM)
    return host_fetch(t)


def multihost_allgather_list(arr: np.ndarray):
    """Allgather variable-length per-rank arrays; returns one array per rank.

    THE one spelling of the "size probe + pad + gather" collective every
    table-layer multi-process path uses (a second divergent spelling that
    skipped the probe on some rank would deadlock the job).  Two rounds:
    a length probe so ranks agree on one padded gather shape, then the
    payload.  ``arr`` is per-rank [k_r, ...]; the result list holds each
    rank's trimmed contribution in rank order.  Collective: every process
    must call it together (even with ``k_r == 0``).
    """
    if not is_multiprocess():
        return [arr]
    import torch.distributed as dist

    dev = _collective_device()
    world = dist.get_world_size()
    n = arr.shape[0]
    mine = torch.tensor([n], dtype=torch.int64, device=dev)
    lens_t = [torch.zeros_like(mine) for _ in range(world)]
    dist.all_gather(lens_t, mine)
    lens = [int(x.item()) for x in lens_t]
    b = bucket_size(max(max(lens), 1))
    padded = np.zeros((b,) + arr.shape[1:], dtype=arr.dtype)
    padded[:n] = arr
    send = torch.from_numpy(padded).to(dev)
    parts = [torch.empty_like(send) for _ in range(world)]
    dist.all_gather(parts, send)
    return [host_fetch(parts[r])[: lens[r]] for r in range(world)]


def host_put(host: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host->device placement: a tensor of its own on ``device`` (a copy
    even on the CPU, so the table never aliases the caller's array)."""
    host = np.asarray(host)
    if not host.flags.writeable:
        host = host.copy()
    return torch.from_numpy(host).to(device, copy=True)


class Table:
    """Common lifecycle: registration, updater selection, BSP buffering."""

    kind = "table"

    # Serve-layer version buckets (docs/serving.md): row/key applies
    # stamp only their bucket, so reads of untouched buckets can keep
    # hitting the cache across unrelated adds.  Must match the native
    # plane's ServerTable::kVersionBuckets.
    SERVE_BUCKETS = 64

    def __init__(self, name: Optional[str] = None,
                 updater_type: Optional[str] = None,
                 sync: Optional[bool] = None,
                 default_option: Optional[AddOption] = None,
                 staleness: int = 0,
                 serve_cache: Optional[int] = None,
                 max_staleness: Optional[int] = None):
        ctx = core_context.get_context()
        self._ctx = ctx
        if updater_type is None:
            updater_type = ctx.updater_type
        self.updater = get_updater(updater_type)
        self.updater_type = updater_type
        self.sync = ctx.sync if sync is None else bool(sync)
        self.staleness = int(staleness)
        if self.staleness < 0:
            raise ValueError(f"staleness must be >= 0, got {staleness}")
        if self.staleness and not self.sync:
            raise ValueError(
                "staleness (SSP) requires a sync=True table — ASP has no "
                "clock to be stale against")
        # SSP deferral queue: (clock, apply_fn) flushes waiting out their
        # staleness bound (see _ssp_defer).
        self._stale_queue: list = []
        self.default_option = default_option or AddOption()
        self.table_id = ctx.register_table(self)
        self.name = name or f"{self.kind}_{self.table_id}"
        # Names key checkpoints; a silent duplicate would drop state on save.
        for other in ctx.tables():
            if other is not self and other.name == self.name:
                # Leave no half-constructed table behind: barrier()/shutdown
                # iterate the registry and would touch it.
                ctx.unregister_table(self.table_id)
                raise ValueError(
                    f"duplicate table name '{self.name}' (held by another "
                    f"{other.kind} table); pass a unique name=")
        self._lock = threading.Lock()
        self._compressor = None  # lazy OneBitCompressor (error feedback)
        self._closed = False
        # --- serve layer (docs/serving.md): versioned read cache -----------
        # The "server version" of a table is its local apply counter;
        # eager applies are lockstep collectives under several
        # processes, so the counter advances IDENTICALLY on every rank
        # and cached whole-table reads stay collective-safe (all ranks
        # hit or all miss together).  Arm via -serve_cache_entries (or
        # the serve_cache= kwarg); max_staleness is a VERSION distance
        # (0 = cached reads never stale), NOT the SSP clock staleness=.
        self._serve_version = 0
        self._serve_buckets = None              # lazily [SERVE_BUCKETS]
        self._serve_ver_lock = threading.Lock()
        # Fleet routing epoch last adopted (docs/replication.md): a
        # promotion/join flip voids the serve cache via note_routing_epoch.
        self._routing_epoch = 0
        self._serve_staleness = int(
            config.get("max_staleness") if max_staleness is None
            else max_staleness)
        if self._serve_staleness < 0:
            raise ValueError(
                f"max_staleness must be >= 0, got {self._serve_staleness}")
        # --- workload plane (docs/observability.md) ---------------------
        # Mirror of the native server's hot-key/load accounting: a
        # space-saving top-K + count-min tracker fed by the eager
        # get/add paths, so the port reports the same shapes the native
        # "hotkeys" OpsQuery kind serves.
        if bool(config.get("hotkey_enabled")):
            from ..sketch import WorkloadTracker

            self._workload = WorkloadTracker(
                topk=int(config.get("hotkey_topk")),
                buckets=self.SERVE_BUCKETS)
        else:
            self._workload = None
        entries = int(config.get("serve_cache_entries")
                      if serve_cache is None else serve_cache)
        # Row-granular cache arm (docs/embedding.md): per-id reads cache
        # INDIVIDUAL rows/keys instead of whole id-set tuples, so a hot
        # row keeps hitting across different id sets.  Rides the same
        # VersionedLRUCache; -serve_row_cache=false reverts to id-set
        # entries.
        self._serve_row_cache = bool(config.get("serve_row_cache"))
        if entries > 0:
            from ..serve import Coalescer, VersionedLRUCache

            self._serve_cache = VersionedLRUCache(entries)
            self._serve_coalescer = Coalescer(
                window_s=float(config.get("coalesce_window_us")) * 1e-6,
                max_batch=int(config.get("serve_max_batch")))
        else:
            self._serve_cache = None
            self._serve_coalescer = None

    def _set_dtype(self, dtype: Any) -> None:
        """``dtype`` stays a numpy dtype (the host paths coerce with it);
        ``torch_dtype`` beside it is what the device tensors hold."""
        self.dtype = numpy_dtype(dtype)
        self.torch_dtype = torch_dtype(self.dtype)

    def _apply(self, delta: torch.Tensor, option) -> None:
        """The one device apply: the functional updater under ``_lock``,
        then the swap.  A concurrent eager add must never read a
        half-swapped (data, state) pair."""
        opt = option or self.default_option
        with self._lock:
            data, state = self.updater.apply_dense(self._data, self._state,
                                                   delta, opt)
            if data.data_ptr() == delta.data_ptr():
                # An updater may return the delta itself (assign): the
                # table must not alias a tensor its caller still holds.
                data = data.clone()
            self._data, self._state = data, tuple(state)
        self._serve_bump()

    def _on_device(self, d: torch.Tensor) -> torch.Tensor:
        """A device delta moved and cast to the table's device and dtype."""
        return d.to(device=self.device, dtype=self.torch_dtype)

    def _apply_dense_padded(self, delta, option, *,
                            presummed: bool = False) -> None:
        """Shared eager dense-apply: pad to the shards, ship, update.

        Used by the dense ``add`` paths.  One process: the delta has the
        table's shape and ships whole.  Sharded: the delta pads to
        ``shard.padded`` rows, and a ``reduce_scatter`` hands each rank
        the sum over ranks of its own block, which its updater applies.
        ``presummed`` marks a delta already merged across ranks (the
        compressed path): each rank takes its block of it, with no sum.
        """
        host = np.ascontiguousarray(delta, dtype=self.dtype)
        sh = self.shard
        if not sh.sharded:
            self._apply(host_put(host, self.device), option)
            return
        if presummed:
            local = host_put(sh.block(host, self.dtype, host.shape[1:]),
                             self.device)
        else:
            if host.shape[0] != sh.padded:
                padded = np.zeros((sh.padded,) + host.shape[1:],
                                  dtype=self.dtype)
                padded[:host.shape[0]] = host
                host = padded
            local = shard_reduce_scatter(host, sh, self.device)
        self._apply(local, option)

    def _fetch(self, t: torch.Tensor) -> np.ndarray:
        """A table tensor (``_data`` or a state slot) whole on the host,
        padding included: this process's copy, or under sharding the
        ``all_gather`` of every rank's block (a collective)."""
        if not self.shard.sharded:
            return host_fetch(t)
        return shard_allgather(t, self.shard).cpu().numpy()

    # -- the fused path's view of the shards ---------------------------------
    def full_value(self, data: torch.Tensor) -> torch.Tensor:
        """The whole (padded) tensor of which ``data`` is this rank's
        block, on the table's device: ``data`` itself in one process, the
        ``all_gather`` of every rank's block under sharding (a
        collective — a fused step calls it on every rank)."""
        if not self.shard.sharded:
            return data
        return shard_allgather(data, self.shard).to(self.device)

    def _check_block(self, data: torch.Tensor) -> None:
        """``raw_assign``'s guard: sharded, a block of another length
        (a whole table, say) would leave the ranks' shards disagreeing."""
        sh = self.shard
        if sh.sharded and data.shape[0] != sh.size:
            raise ValueError(
                f"raw_assign of {data.shape[0]} rows into table "
                f"'{self.name}', whose block on this rank holds "
                f"{sh.size} (several processes: assign this rank's "
                f"block, e.g. local_part(full))")

    def local_part(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's block of a whole-table tensor whose leading length
        is the live or the padded one (``full`` itself in one process):
        the rows a fused step's update may apply here."""
        sh = self.shard
        if not sh.sharded and full.shape[0] == sh.size:
            return full
        if full.shape[0] < sh.padded:
            full = torch.cat([full, full.new_zeros(
                (sh.padded - full.shape[0],) + tuple(full.shape[1:]))])
        return full.narrow(0, sh.offset, sh.size)

    def _wire_compress_default(self):
        """Resolve the ``-wire_codec`` flag into a default ``compress=``
        for host dense adds (docs/wire_compression.md): ``"1bit"`` when
        the flag says so AND this table can carry it (float dtype, not
        BSP — the residual is per wire message), else ``None``.  An
        explicit ``compress=`` kwarg always wins; the device fast path
        and the sparse codec stay native/wire concepts."""
        if config.get("wire_codec") != "1bit" or self.sync:
            return None
        return "1bit" if self.torch_dtype.is_floating_point else None

    def _add_compressed(self, delta, option, compress: str,
                        blocking: bool) -> None:
        """Shared compress= dispatch for the dense table ``add`` paths:
        validation (codec name, BSP incompatibility, float dtype) in ONE
        place, then the 1-bit apply."""
        # Chaos seam (docs/fault_tolerance.md): a scripted encode
        # failure surfaces here, exactly where a real codec error would.
        fault.inject("codec.encode")
        if compress != "1bit":
            raise ValueError(
                f"unknown compress '{compress}' (expected '1bit')")
        if self.sync:
            raise ValueError(
                "compress='1bit' is incompatible with BSP buffering "
                "(the residual is per-wire-message)")
        if not self.torch_dtype.is_floating_point:
            # Fractional quantization scales would truncate into an int
            # table and the residual could never compensate.
            raise ValueError(
                f"compress='1bit' requires a floating table, got "
                f"{self.dtype}")
        self._apply_dense_compressed(delta, option)
        if blocking:
            self._sync_device()

    def _apply_dense_compressed(self, delta, option) -> None:
        """1-bit-SGD eager add (SURVEY.md §5 quantization lineage).

        Quantize (with this table's error-feedback residual), move only
        sign bits + two scales — under several processes, the allgather
        ships 1/32 the bytes — then every rank dequantizes the identical
        payloads and applies the identical sum.  Lossy per add; the
        residual re-injects the loss into the next add, which is what
        keeps SGD convergent (Seide et al. 2014).
        """
        from ..util.quantization import OneBitCompressor, dequantize_1bit

        # Residual read-modify-write under the table lock: concurrent
        # compressed adds racing it would double-inject one residual and
        # drop another — silently wrong values.
        with self._lock:
            if self._compressor is None:
                self._compressor = OneBitCompressor()
            packed, p, m = self._compressor.compress(delta)
        shape = delta.shape
        if is_multiprocess():
            header = np.frombuffer(
                np.asarray([p, m], np.float64).tobytes(), np.uint8)
            parts = multihost_allgather_list(
                np.concatenate([header, packed]))
            total = np.zeros(int(np.prod(shape)), np.float32)
            for part in parts:
                ps, ms = np.frombuffer(part[:16].tobytes(), np.float64)
                total += dequantize_1bit(part[16:], float(ps), float(ms),
                                         total.size)
            self._apply_dense_padded(total.reshape(shape), option,
                                     presummed=True)
            return
        # One process: ship the PACKED BITS to the device (1/32 the
        # host->device bytes) and unpack + scale + apply there.
        self._apply_packed_device(packed, p, m, shape, option)

    def _apply_packed_device(self, packed, pos_scale, neg_scale, shape,
                             option) -> None:
        """1-bit decode on the device + updater apply.

        ``np.packbits`` (and ``jnp.unpackbits``) are MSB-first: element
        ``8i + j`` is bit ``7 - j`` of byte ``i``, so the shifts run
        7…0 — 0…7 would flip every sign inside its byte.
        """
        n = int(np.prod(shape))
        dev = self.device
        u8 = torch.from_numpy(np.ascontiguousarray(packed, np.uint8)).to(dev)
        shifts = torch.arange(7, -1, -1, dtype=torch.int32, device=dev)
        bits = ((u8.to(torch.int32)[:, None] >> shifts) & 1).reshape(-1)[:n]
        scales = torch.tensor([pos_scale, neg_scale], dtype=torch.float32,
                              device=dev)
        d = torch.where(bits.bool(), scales[0], scales[1]).reshape(shape)
        self._apply(self._on_device(d), option)

    def _apply_dense_device(self, delta: torch.Tensor, option) -> None:
        """Device-resident eager add: the delta is already a tensor.

        No host→device ship — cast + apply on the device, so Add runs at
        HBM speed (the reference server's
        ProcessAdd with the network hop removed; SURVEY.md §3.3).
        One process only: multi-process adds need the cross-process sum
        and take the host path.
        """
        self._apply(self._on_device(delta), option)

    def _try_device_add(self, delta, expected_shape, option,
                        blocking: bool) -> bool:
        """Route a ``torch.Tensor`` delta to the device-resident apply.

        Returns False when the delta is host-side or the mode needs the
        host path (BSP buffering, the multi-process sum) — the ONE
        spelling of that guard for every dense table ``add``.
        """
        if (not isinstance(delta, torch.Tensor) or self.sync
                or is_multiprocess()):
            return False
        if tuple(delta.shape) != tuple(expected_shape):
            raise ValueError(
                f"delta shape {tuple(delta.shape)} != {expected_shape}")
        self._apply_dense_device(delta, option)
        if blocking:
            self._sync_device()
        return True

    def _sync_device(self) -> None:
        """Wait for this table's queued device work (the blocking add):
        the device's stream on CUDA, nothing on the CPU."""
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    def _dense_snapshot(self, live: int):
        """Checkpoint the LIVE region of ``_data``/``_state``: padding is
        a placement artifact, and baking it in would pin the snapshot to
        the layout that wrote it.  The same numpy dict as the JAX
        package's, so a snapshot of either loads into the other, at any
        world size.  Sharded, the blocks are gathered (a collective)."""
        return self._locked_read(
            lambda d, s: (self._fetch(d)[:live],
                          [self._fetch(x)[:live] for x in s]))

    def _dense_restore(self, data, state) -> None:
        """Place this rank's block of a live-region snapshot (the
        table's own live rows), zeros in the padding."""
        rest = tuple(self._data.shape[1:])

        def block(h):
            return host_put(self.shard.block(h, self.dtype, rest),
                            self.device)

        with self._lock:
            self._data = block(data)
            self._state = tuple(block(s) for s in state)
        self._serve_bump()   # restored timeline: cached reads are void
        if self._compressor is not None:
            # Carried quantization error belongs to the abandoned timeline.
            self._compressor.reset()

    def _locked_read(self, reader):
        """Run ``reader(data, state)`` under the table lock.

        Every eager read of ``_data``/``_state`` goes through this, so it
        never sees a half-swapped (data, state) pair.  (Multi-process
        callers still follow the lockstep contract — the lock serializes
        only this process's threads.)
        """
        with self._lock:
            return reader(self._data, self._state)

    def _slice_device(self, limits) -> Any:
        """Device-resident Get: a fresh tensor of the live region, so
        later adds don't mutate what the caller holds and the caller's
        writes never reach the table.

        One process only, as in the JAX package: under several the get
        is a collective host fetch of the shards — use ``get()``."""
        if is_multiprocess():
            raise RuntimeError(
                "get(device=True) is a single-process fast path; under "
                "several processes use get() (collective host fetch)")
        with self._lock:
            return self._data[tuple(slice(0, s) for s in limits)].clone()

    def close(self) -> None:
        """Unregister from the runtime and drop the device buffers.

        The context registry holds a strong reference to every table (it
        drives flush/checkpoint/shutdown), so ``del table`` alone never
        frees device memory — long-lived processes that create scratch
        tables (benchmarks, notebooks) call ``close()``.  The name is
        released for reuse; buffered BSP adds are discarded (they could
        never flush — the table left the registry barrier() walks); any
        later eager op on the closed table raises.
        """
        self._ctx.unregister_table(self.table_id)
        self.discard_pending()
        self._closed = True
        with self._lock:
            self._data = None
            self._state = ()
        if self._serve_cache is not None:
            self._serve_cache.invalidate()

    # -- BSP clock boundary --------------------------------------------------
    def _ssp_defer(self, apply_fn=None) -> None:
        """SSP clock-lag (SURVEY.md §2.9-bis, the SPMD semantic mapping).

        BSP (``staleness=0``): ``apply_fn`` runs now — the flush applies
        at its own barrier.  SSP (``staleness=s``): the apply waits out
        ``s`` further barriers, so a Get at clock *t* is guaranteed all
        adds from clocks ≤ t-1-s (the SSP reader bound) while the last
        *s* clocks' adds may still be pending — the lockstep analog of
        the native plane's per-rank clock vector (``-staleness`` +
        ``MV_Clock``; there stragglers are real, here every rank defers
        identically so the collective applies stay in lockstep).

        Called by each table's ``flush()`` with the pending snapshot
        closed over; the queue is clock-tagged with the barrier that
        buffered it.
        """
        if not self.staleness:
            if apply_fn is not None:
                apply_fn()
            return
        if apply_fn is not None:
            self._stale_queue.append((self._ctx.clock, apply_fn))
        # Drain on EVERY flush (apply_fn=None = nothing new this clock) —
        # an idle clock must still release the backlog it matured.
        ready = [(c, f) for c, f in self._stale_queue
                 if self._ctx.clock - c >= self.staleness]
        self._stale_queue = [(c, f) for c, f in self._stale_queue
                             if self._ctx.clock - c < self.staleness]
        for _, f in sorted(ready, key=lambda cf: cf[0]):
            f()

    def flush(self) -> None:
        """Apply buffered (sync-mode) adds; called by ``barrier()``."""
        raise NotImplementedError

    def discard_pending(self) -> None:
        """Drop buffered (sync-mode) adds without applying them.

        Used by checkpoint restore: deltas buffered before the restore
        belong to the abandoned timeline.
        """
        raise NotImplementedError

    # -- checkpoint hooks (ServerTable::Store/Load parity) -------------------
    def store_state(self) -> Any:
        """Snapshot of everything needed to restore the table."""
        raise NotImplementedError

    def load_state(self, state: Any) -> None:
        raise NotImplementedError

    # -- serve layer (docs/serving.md) ---------------------------------------
    @staticmethod
    def serve_key_bucket(key: Any) -> int:
        """Stable bucket of a KV key — crc32, NOT hash(): ranks must
        agree (PYTHONHASHSEED randomizes str hash per process)."""
        import zlib

        return zlib.crc32(repr(key).encode()) % Table.SERVE_BUCKETS

    def _serve_bump(self, buckets=None, keys=None) -> None:
        """Advance the table version after a local apply — the analog of
        the native server's per-apply version stamp.  Bumping IS the
        write-through invalidation: cached entries below the new version
        fail the staleness gate at lookup.  ``buckets`` (row ids or key
        buckets) stamps only the touched buckets.  ``keys`` (the touched
        row ids / KV keys, when the apply is key-granular) feeds the
        workload hot-key tracker — independent of the serve cache, which
        may be disarmed while accounting stays on."""
        if self._workload is not None:
            self._workload.note_add(keys)
        if self._serve_cache is None:
            return
        with self._serve_ver_lock:
            self._serve_version += 1
            v = self._serve_version
            if buckets is None:
                if self._serve_buckets is not None:
                    self._serve_buckets[:] = v
                return
            if self._serve_buckets is None:
                # Lazily created on the FIRST bucket-granular bump: seed
                # every bucket with the pre-bump version, not zero —
                # whole-table bumps (dense adds, load_state) that ran
                # while the array was None must stay visible to the
                # staleness gate, else entries cached before them would
                # hit forever.
                self._serve_buckets = np.full(self.SERVE_BUCKETS, v - 1,
                                              np.int64)
            idx = np.asarray(list(buckets), np.int64) % self.SERVE_BUCKETS
            self._serve_buckets[idx] = v

    def note_routing_epoch(self, epoch: int) -> None:
        """Adopt a fleet routing-epoch observation (docs/replication.md).

        Callers bridging this table to a native serve plane feed the
        epoch here; a FLIP means a shard was promoted or joined, so
        every cached serve entry — stamped under the previous shard
        owner's version timeline — is voided by a whole-table bump.
        Monotonic: stale observations are ignored (max-merge).  Never
        carry a cached shard-routing decision across a wire call
        without re-checking this epoch."""
        with self._serve_ver_lock:
            if epoch <= self._routing_epoch:
                return
            self._routing_epoch = int(epoch)
        self._serve_bump()  # route flip = cached reads are void

    @property
    def routing_epoch(self) -> int:
        """Last adopted fleet routing epoch (0 = registration map)."""
        with self._serve_ver_lock:
            return self._routing_epoch

    def _serve_current_many(self, buckets):
        """Per-bucket version estimates for a batch of reads — ONE lock
        acquisition for the whole id set (the row-granular cache gates
        each row on its own bucket, so per-row ``_serve_current`` calls
        would pay the lock k times)."""
        idx = np.asarray([int(b) for b in buckets], np.int64)
        with self._serve_ver_lock:
            if self._serve_buckets is None or idx.size == 0:
                return np.full(idx.shape, self._serve_version, np.int64)
            return self._serve_buckets[idx % self.SERVE_BUCKETS].copy()

    def _serve_current(self, buckets=None) -> int:
        """Version gating a read: table version, or the max over the
        touched buckets (adds elsewhere don't invalidate this read)."""
        with self._serve_ver_lock:
            if buckets is None or self._serve_buckets is None:
                return self._serve_version
            idx = np.asarray(list(buckets), np.int64)
            if idx.size == 0:
                return 0
            return int(self._serve_buckets[idx % self.SERVE_BUCKETS].max())

    def workload_report(self) -> dict:
        """Per-table workload report (docs/observability.md): the same
        shape as one entry of the native ``"hotkeys"`` OpsQuery kind —
        get/add totals, bucket-load skew ratio, top-K hot keys with
        count-min estimates.  ``{"armed": False}`` when disabled."""
        if self._workload is None:
            return {"id": self.table_id, "armed": False}
        out = {"id": self.table_id, "armed": True}
        out.update(self._workload.report())
        return out

    def _serve_read(self, key: tuple, fetch, buckets=None,
                    collective_safe: bool = True, copy=None, keys=None):
        """Cache + coalesce an eager host read (docs/serving.md).

        ``fetch`` is the full existing read path (including any
        multi-process collective); it runs at most once per coalescing
        window.  ``collective_safe=False`` marks reads whose cache keys
        can DIFFER per rank (row-id / key-set reads): a rank-local hit
        there would break the lockstep fetch collective, so they bypass
        the cache under several processes.  ``copy`` clones a value on
        the cache boundary (default: ndarray ``.copy()``) so caller
        mutation cannot corrupt the cached copy.  ``keys`` (the touched
        row ids / KV keys) feeds the workload hot-key tracker regardless
        of whether the cache is armed.
        """
        if self._workload is not None:
            self._workload.note_get(keys)
        cache = self._serve_cache
        if cache is None or (not collective_safe and is_multiprocess()):
            return fetch()
        if copy is None:
            def copy(v):
                return v.copy()
        cur = self._serve_current(buckets)
        forced = False
        try:
            # Chaos seam: an injected serve.stale forces this read to
            # miss (tests script staleness storms without real adds).
            fault.inject("serve.stale")
        except fault.FaultError:
            forced = True
        if not forced:
            hit = cache.lookup(key, min_version=cur - self._serve_staleness)
            if hit is not None:
                return copy(hit[0])
        else:
            metrics.counter("serve.cache.miss").inc()

        def execute(items):
            out = fetch()
            return [out] * len(items)   # one fetch serves every waiter

        with tracing.span("serve::table_get", table=self.name,
                          key=str(key)):
            val = self._serve_coalescer.submit((id(self),) + key, None,
                                               execute)
        # Stamp with the PRE-fetch version: the fetch ran after the
        # estimate, so the data is at least that new (a post-fetch stamp
        # could mark pre-add data as post-add fresh).  Store the fetched
        # value ITSELF and copy once on the way out — nothing else holds
        # `val` mutably (every coalesced waiter runs this same tail and
        # takes its own copy; hits copy at lookup).
        cache.store(key, val, cur)
        return copy(val)

    def _serve_read_rows(self, kind, keys, fetch_subset, buckets=None,
                         note_keys=None):
        """Row-granular serve cache (docs/embedding.md).

        Per-KEY cache entries ``(id(self), kind, key)``, each gated by
        its OWN bucket version — a cached hot row keeps hitting across
        different requested id sets and across adds to other buckets,
        and a miss fetches only the missing keys (never the whole set,
        never the whole table).  ``fetch_subset(sub)`` returns one value
        per key of ``sub`` (deduplicated, arbitrary order preserved).

        Returns the per-key value list in request order, or ``None``
        when this path is disarmed — serve cache off, ``-serve_row_cache
        =false``, or several processes (per-rank key sets would break
        the lockstep fetch collective; the caller falls back to the
        id-set path, which bypasses correctly).  Returned values are the
        CACHED objects (stored read-only): the caller copies at its own
        boundary (np.stack / per-value .copy()).

        Nothing accrues unless this path is ARMED — a disabled row cache
        must not count chaos-forced misses.
        """
        cache = self._serve_cache
        if (cache is None or not self._serve_row_cache
                or is_multiprocess()):
            return None
        if self._workload is not None:
            self._workload.note_get(
                note_keys if note_keys is not None
                else [int(k) for k in keys])
        keys_list = list(keys)
        bucket_list = list(buckets) if buckets is not None else keys_list
        vers = self._serve_current_many(bucket_list)
        forced = False
        try:
            # Chaos seam: an injected serve.stale forces this read to
            # miss wholesale (tests script staleness storms) — counted
            # only here, past the armed gate.
            fault.inject("serve.stale")
        except fault.FaultError:
            forced = True
            metrics.counter("serve.cache.miss").inc()
        values: dict = {}
        missing = []
        miss_vers: dict = {}
        first_idx: dict = {}
        for i, k in enumerate(keys_list):
            if k not in first_idx:
                first_idx[k] = i  # order-preserving dedup
        uniq = list(first_idx)
        if forced:
            missing = uniq
            miss_vers = {k: int(vers[first_idx[k]]) for k in uniq}
        else:
            # ONE lock + counter update for the whole id set
            # (VersionedLRUCache.lookup_many) — per-key lookup() calls
            # would pay the lock and the metrics registry k times.
            got = cache.lookup_many(
                [(id(self), kind, k) for k in uniq],
                [int(vers[first_idx[k]]) - self._serve_staleness
                 for k in uniq])
            for k, v in zip(uniq, got):
                if v is not None:
                    values[k] = v
                else:
                    missing.append(k)
                    # Pre-fetch stamp per key: the fetch runs after
                    # this estimate, so the data is at least this new.
                    miss_vers[k] = int(vers[first_idx[k]])
        if missing:
            def execute(items):
                # Coalesced miss fetch: concurrent readers' missing
                # sets union into ONE subset fetch.
                union = []
                seen = set()
                for it in items:
                    for k in it:
                        if k not in seen:
                            seen.add(k)
                            union.append(k)
                fetched = fetch_subset(union)
                lut = dict(zip(union, fetched))
                return [[lut[k] for k in it] for it in items]

            with tracing.span("serve::row_get", table=self.name,
                              k=len(missing)):
                got = self._serve_coalescer.submit(
                    (id(self), kind, "rows"), missing, execute)
            for k, v in zip(missing, got):
                if isinstance(v, np.ndarray):
                    # Loud ValueError on any aliasing slip instead of
                    # silent cache corruption; callers copy at their
                    # boundary.
                    v = v.copy()
                    v.flags.writeable = False
                cache.store((id(self), kind, k), v, miss_vers[k])
                values[k] = v
        return [values[k] for k in keys_list]

    # -- host-bridge borrow/out= protocol (docs/host_bridge.md) --------------
    def _coerce_delta(self, delta, borrow: bool):
        """THE one coercion gate of every eager add path.

        ``borrow=False`` (default): the defensive ``np.asarray`` —
        converts dtype/layout as needed (possibly copying); a tensor is
        fetched to the host first (a BSP table buffers device deltas on
        the host like any other).
        ``borrow=True``: the caller guarantees ``delta`` is already
        this table's dtype, C-contiguous, and will not be mutated while
        buffered (BSP) or in flight — the path then stores/ships it
        WITHOUT the astype/copy churn; a wrong layout raises instead of
        silently copying, so the fast path cannot quietly decay into the
        slow one."""
        if not borrow:
            if isinstance(delta, torch.Tensor):
                delta = host_fetch(delta)
            return np.asarray(delta, dtype=self.dtype)
        if not isinstance(delta, np.ndarray):
            raise TypeError(
                f"borrow=True needs an ndarray delta, got {type(delta)!r}")
        if delta.dtype != self.dtype:
            raise ValueError(
                f"borrow=True: delta dtype {delta.dtype} != table dtype "
                f"{self.dtype} — the borrow protocol never converts")
        if not delta.flags["C_CONTIGUOUS"]:
            raise ValueError(
                "borrow=True: delta is not C-contiguous — the borrow "
                "protocol never copies")
        return delta

    @staticmethod
    def _fill_out(out, val):
        """``out=`` tail of the eager get paths: fill the caller's
        preallocated buffer (killing the per-call allocation) or hand
        back ``val`` unchanged."""
        if out is None:
            return val
        np.copyto(out, val)
        return out

    def _monitor(self, op: str):
        # Every public eager op opens with this — it doubles as the
        # closed-table guard (a closed table's sync buffers would
        # otherwise swallow adds silently) and as the chaos seam: the
        # fault injector can script a Get/Add failure here exactly where
        # a real transport error would surface.
        if self._closed:
            raise RuntimeError(
                f"table '{self.name}' is closed (close() was called)")
        fault.inject(f"table.{op}")
        return dashboard.monitor(f"{type(self).__name__}::{op}")
