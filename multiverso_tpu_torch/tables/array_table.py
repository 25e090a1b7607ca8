"""ArrayTable — dense 1-D parameter vector.

Port of ``multiverso_tpu/tables/array_table.py``.  Reference (SURVEY.md
§2.11, ``table/array_table.h``): contiguous float/int vector evenly
sharded over server processes; workers ``Get`` the whole array and
``Add`` whole-array deltas; the server applies the Updater per shard.

PyTorch: in one process the vector is ONE tensor on the context's
device.  ``Get`` is a device→host copy; ``Add`` is the functional updater
call on the device — the reference's server-side ``ProcessAdd`` with the
network removed.  Under several processes each rank holds one contiguous
block of the vector padded to a multiple of the world size (``shard``):
``Get`` gathers the blocks, ``Add`` reduce-scatters the delta and each
rank updates its own block (``tables/base.py``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..parallel.sharding import shard_along, table_mesh
from ..updaters import AddOption
from .base import Table, host_put

__all__ = ["ArrayTable"]


class ArrayTable(Table):
    kind = "array"

    def __init__(self, size: int, dtype: Any = np.float32,
                 init: Optional[np.ndarray] = None, **kw):
        """``dtype`` is a numpy dtype, its name or a torch dtype."""
        self._set_dtype(dtype)   # before registering: a bad dtype leaves
        super().__init__(**kw)   # no half-built table in the registry
        self.size = int(size)
        self.shard = shard_along(table_mesh(self._ctx.device), self.size)
        self.device = self.shard.device
        self._data = host_put(self.shard.block(init, self.dtype),
                              self.device)
        self._state = self.updater.init_state(
            (self.shard.size,), self.torch_dtype, self.device)
        # BSP clock buffers, bucketed per AddOption so a flush applies each
        # option's aggregate with the right hyper-parameters.
        self._pending: Dict[Optional[AddOption], np.ndarray] = {}
        # Options whose buffered delta is a BORROWED caller array (no
        # defensive copy, docs/host_bridge.md): a second add to the same
        # option must not += into the caller's memory.
        self._pending_borrowed: set = set()

    # ------------------------------------------------------------------ Get
    def get(self, option=None, device: bool = False, out=None):
        """Pull the whole array (reference ``ArrayWorker<T>::Get``; §3.2).

        ``device=True`` returns a fresh tensor on the table's device
        instead of a host copy — the Get for callers whose next op runs
        on the device (no host hop; pairs with passing a tensor delta to
        ``add``).  ``out=`` fills a preallocated host buffer instead of
        allocating one per call (the host-bridge out= protocol,
        docs/host_bridge.md).  The host array is the caller's own:
        mutating it leaves the table unchanged.
        """
        with self._monitor("Get"):
            if device:
                if out is not None:
                    raise ValueError("out= is a host-path argument")
                return self._slice_device((self.size,))
            # Serve layer (docs/serving.md): repeat host reads within the
            # version-staleness bound serve from the client cache;
            # concurrent misses coalesce into one fetch.  No-op unless
            # -serve_cache_entries armed the cache.
            return self._fill_out(out, self._serve_read(
                ("get",),
                lambda: self._locked_read(
                    lambda d, s: self._fetch(d))[: self.size]))

    # ------------------------------------------------------------------ Add
    def add(self, delta, option: Optional[AddOption] = None,
            sync: bool = False, compress: Optional[str] = None,
            borrow: bool = False) -> None:
        """Push a delta/gradient (reference ``ArrayWorker<T>::Add``; §3.3).

        ``delta`` is [size] or [k, size] (stacked per-worker contributions,
        summed before the updater — the server receiving k Adds), as a
        host array or a ``torch.Tensor`` (the device-resident add).
        ``sync`` blocks until the device commit completes (the
        reference's blocking Add vs AddAsync).  ``compress="1bit"`` sends
        sign bits + scales with error feedback (1/32 the bytes; lossy per
        add, SGD-safe — SURVEY.md §5 quantization lineage).
        ``borrow=True``: ``delta`` is already this table's dtype/C layout
        and will not be mutated until applied — the path skips the
        defensive astype/copy churn (docs/host_bridge.md; wrong layouts
        raise instead of copying).
        """
        with self._monitor("Add"):
            if compress is None and isinstance(delta, torch.Tensor) \
                    and delta.ndim == 2:
                delta = delta.sum(dim=0)       # worker stack, on device
            if compress is None and self._try_device_add(
                    delta, (self.size,), option, sync):
                return
            if compress is None:
                # -wire_codec=1bit: host dense adds default to the 1-bit
                # wire format (docs/wire_compression.md).
                compress = self._wire_compress_default()
            delta = self._coerce_delta(delta, borrow)
            if delta.ndim == 2:
                delta = delta.sum(axis=0)
            if delta.shape != (self.size,):
                raise ValueError(
                    f"delta shape {delta.shape} != ({self.size},)")
            if compress is not None:
                self._add_compressed(delta, option, compress, sync)
                return
            if self.sync:
                # BSP: buffer until the clock boundary (barrier → flush).
                # Borrowed deltas buffer WITHOUT the defensive copy; a
                # second add to the same option must then allocate a
                # fresh sum instead of += into the caller's memory.
                with self._lock:
                    if option in self._pending:
                        if option in self._pending_borrowed:
                            self._pending[option] = (
                                self._pending[option] + delta)
                            self._pending_borrowed.discard(option)
                        else:
                            self._pending[option] += delta
                    elif borrow:
                        self._pending[option] = delta
                        self._pending_borrowed.add(option)
                    else:
                        self._pending[option] = delta.astype(
                            self.dtype, copy=True)
                return
            self._apply_now(delta, option)
            if sync:
                self._sync_device()

    def flush(self) -> None:
        with self._lock:
            pending, self._pending = self._pending, {}
            self._pending_borrowed = set()

        def apply(pending=pending):
            for option, delta in pending.items():
                self._apply_now(delta, option)

        self._ssp_defer(apply if pending else None)

    def discard_pending(self) -> None:
        with self._lock:
            self._pending = {}
            self._pending_borrowed = set()
            self._stale_queue = []

    def _apply_now(self, delta: np.ndarray, option: Optional[AddOption]) -> None:
        self._apply_dense_padded(delta, option)

    # ------------------------------------------------- fused (on-device) path
    def raw_value(self) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
        """Hand the tensors to a training step (the fused hot loop): this
        rank's blocks (the whole table in one process; see
        ``full_value``/``local_part``)."""
        return self._data, self._state

    def raw_assign(self, data: torch.Tensor,
                   state: Optional[Tuple[torch.Tensor, ...]] = None) -> None:
        self._check_block(data)
        self._data = data
        if state is not None:
            self._state = tuple(state)

    @property
    def sharding(self) -> torch.device:
        """The device this rank's block lives on (the JAX package's
        ``NamedSharding``; the block itself is ``shard``)."""
        return self.device

    # ------------------------------------------------------------ checkpoint
    def store_state(self) -> Any:
        data, state = self._dense_snapshot(self.size)
        return {
            "kind": self.kind,
            "size": self.size,
            "data": data,
            "state": state,
        }

    def load_state(self, snap: Any) -> None:
        if snap["kind"] != self.kind or snap["size"] != self.size:
            raise ValueError(
                f"snapshot of a {snap['kind']} table of size "
                f"{snap['size']} cannot load into {self.kind} table "
                f"'{self.name}' of size {self.size}")
        self._dense_restore(snap["data"], snap["state"])
