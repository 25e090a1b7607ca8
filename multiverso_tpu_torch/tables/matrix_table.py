"""MatrixTable — 2-D parameter matrix with row-granular Get/Add.

Port of ``multiverso_tpu/tables/matrix_table.py``.  Reference (SURVEY.md
§2.12, ``table/matrix_table.h``): row-partitioned over server processes;
workers Get/Add the whole matrix or a set of row ids — the sparse-access
workhorse behind word2vec and LightLDA.

PyTorch: in one process the matrix is ONE tensor [rows, cols] on the
context's device.  ``get_rows`` is an ``index_select`` and a device→host
copy; ``add_rows`` sums duplicate ids on the host (segment-sum, so
stateful updaters see one delta per row), ships the unique rows and
their deltas, and the updater scatters them into the table in place.
The JAX package pads row batches to power-of-two buckets for XLA's
static shapes; nothing here needs them.

Several processes: each rank holds one contiguous block of rows
(``shard``; the rows pad to a multiple of the world size, as the JAX
package pads them to its mesh).  The row ops union every rank's ids as
before; then each rank reads or updates only the rows it owns, at their
offsets in its block, and a read's rows reach every rank by one sum of
zero-filled buffers.  Padding rows are never written.

Ids past the table — outside ``[0, num_rows)`` — are the port's
contract: ``get_rows`` reads zeros for them and ``add_rows`` drops their
deltas on the host, so no such index ever reaches the device, where it
would be a device-side assert.  The JAX package's answer depends on its
mesh: it pads the rows to a multiple of the device count, an id inside
the padding reads the padding (zeros until an ``add_rows`` of that id
writes there), and an id past the padding reads the last padded row
(on one device: the last real row).  The two agree wherever the JAX
package reads untouched padding — the apps' padding ids (the skip-gram
mixture's ``vocab_size``) among them; they differ where the JAX package
reads padding that an add wrote, or reads its last row.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..parallel.sharding import shard_along, table_mesh
from ..updaters import AddOption
from ..updaters import base as updater_base
from .base import (Table, device_sum, host_fetch, host_put,
                   multihost_allgather_list, multihost_sum)

__all__ = ["MatrixTable"]


class MatrixTable(Table):
    kind = "matrix"

    def __init__(self, num_rows: int, num_cols: int, dtype: Any = np.float32,
                 init: Optional[np.ndarray] = None, **kw):
        """``dtype`` is a numpy dtype, its name or a torch dtype."""
        self._set_dtype(dtype)   # before registering: a bad dtype leaves
        super().__init__(**kw)   # no half-built table in the registry
        self.num_rows = int(num_rows)
        self.num_cols = int(num_cols)
        self.shard = shard_along(table_mesh(self._ctx.device),
                                 self.num_rows)
        self.device = self.shard.device
        # BSP buffers, bucketed per AddOption so a flush applies each
        # option's aggregate with the right hyper-parameters.  Set before
        # the device allocation, so a table whose allocation failed still
        # flushes (as nothing) at the barrier.
        self._pending_dense: Dict[Optional[AddOption], np.ndarray] = {}
        self._pending_sparse: List[
            Tuple[np.ndarray, np.ndarray, Optional[AddOption]]] = []
        # Options whose buffered dense delta is a BORROWED caller array
        # (docs/host_bridge.md): never += into the caller's memory.
        self._pending_borrowed: set = set()

        self._data = host_put(
            self.shard.block(init, self.dtype, (self.num_cols,)),
            self.device)
        self._state = self.updater.init_state(
            (self.shard.size, self.num_cols), self.torch_dtype, self.device)

    # ------------------------------------------------------------------ Get
    def get(self, option=None, device: bool = False, out=None):
        """Whole-matrix pull (reference ``MatrixWorkerTable::Get`` all-rows).

        ``device=True`` returns a fresh tensor on the table's device (no
        host hop); ``out=`` fills a preallocated host buffer
        (docs/host_bridge.md)."""
        with self._monitor("Get"):
            if device:
                if out is not None:
                    raise ValueError("out= is a host-path argument")
                return self._slice_device((self.num_rows, self.num_cols))
            # Serve layer: cached + coalesced whole-matrix host read
            # (collective-safe — the key is identical on every rank).
            return self._fill_out(out, self._serve_read(
                ("get",),
                lambda: self._locked_read(
                    lambda d, s: self._fetch(d))[: self.num_rows]))

    def get_rows(self, row_ids, option=None, out=None) -> np.ndarray:
        """Row-subset pull — the sparse hot read path.

        Reference: ``MatrixWorkerTable::Get(row_ids)`` partitions ids across
        servers; here it is one ``index_select`` on the device.

        Several processes: ranks may ask for different (or no) rows; as
        in the JAX package the ids are first unioned across processes,
        every rank fills the union's rows it owns, one sum hands every
        rank all of them, and each slices out its own request — so
        ``get_rows`` is a lockstep collective there too.
        """
        from .base import is_multiprocess

        with self._monitor("GetRows"):
            rows = np.asarray(row_ids, dtype=np.int64)

            # Row-granular serve cache first (docs/embedding.md): each
            # requested row is its own versioned entry, so a hot row
            # keeps hitting across DIFFERENT id sets and a miss fetches
            # only the missing rows — never the whole set.  Disarmed
            # (cache off / -serve_row_cache=false / several processes)
            # this returns None and the id-set path below takes over.
            if rows.shape[0]:
                def fetch_subset(sub):
                    return list(self._gather_host(np.asarray(sub, np.int64)))

                vals = self._serve_read_rows(
                    "row", [int(r) for r in rows], fetch_subset,
                    note_keys=rows.tolist())
                if vals is not None:
                    # np.stack allocates the caller's fresh result — the
                    # cached (read-only) rows are never handed out
                    # mutably.
                    return self._fill_out(
                        out, np.stack(vals).astype(self.dtype,
                                                   copy=False))

            def fetch():
                if is_multiprocess():
                    union = self._allgather_row_ids(rows)
                    if union.shape[0] == 0:
                        return np.zeros((0, self.num_cols),
                                        dtype=self.dtype)
                    # Every rank joins the fill's sum, asked for rows or not.
                    fetched = self._gather_host(union)
                    if rows.shape[0] == 0:
                        return np.zeros((0, self.num_cols),
                                        dtype=self.dtype)
                    return fetched[np.searchsorted(union, rows)]
                return self._gather_host(rows)

            # Serve layer: per-id-set cache entries, gated by the max
            # version over the TOUCHED row buckets (adds to other rows
            # keep these hitting).  collective_safe=False — ranks may
            # request different ids, and a rank-local hit would break
            # the union collective, so several processes bypass the cache.
            return self._fill_out(out, self._serve_read(
                ("rows", tuple(rows.tolist())), fetch,
                buckets=rows, collective_safe=False,
                keys=rows.tolist()))

    def _gather_host(self, rows: np.ndarray) -> np.ndarray:
        """Rows ``rows`` as a host array; ids outside the table read
        zeros and are never sent to the device.  Sharded (a collective:
        every rank passes the same ``rows``): each rank fills the rows it
        owns and the zero-filled buffers are summed across ranks."""
        sh = self.shard
        own = sh.owned(rows)
        ids = rows[own] - sh.offset
        got = np.zeros((0, self.num_cols), dtype=self.dtype)
        if ids.shape[0]:
            idx = host_put(ids.astype(np.int64), self.device)
            got = self._locked_read(
                lambda d, s: host_fetch(d.index_select(0, idx)))
        if own.all() and not sh.sharded:
            return got
        out = np.zeros((rows.shape[0], self.num_cols), dtype=self.dtype)
        out[own] = got
        return multihost_sum(out) if sh.sharded else out

    @staticmethod
    def _allgather_row_ids(rows: np.ndarray) -> np.ndarray:
        """Sorted union of every rank's requested row ids (collective)."""
        parts = multihost_allgather_list(rows)
        return np.unique(np.concatenate(parts))

    # ------------------------------------------------------------------ Add
    def add(self, delta, option: Optional[AddOption] = None,
            sync: bool = False, compress: Optional[str] = None,
            borrow: bool = False) -> None:
        """Whole-matrix add (reference ``Add`` all-rows path).

        A ``torch.Tensor`` delta is the device-resident add.
        ``compress="1bit"``: sign-bit wire format with error feedback
        (see ``ArrayTable.add``).  ``borrow=True``: skip the defensive
        astype/copy — the caller guarantees dtype/layout and no
        mutation until applied (docs/host_bridge.md)."""
        with self._monitor("Add"):
            if compress is None and self._try_device_add(
                    delta, (self.num_rows, self.num_cols), option, sync):
                return
            if compress is None:
                # -wire_codec=1bit: host dense adds default to the 1-bit
                # wire format (docs/wire_compression.md).
                compress = self._wire_compress_default()
            delta = self._coerce_delta(delta, borrow)
            if delta.shape != (self.num_rows, self.num_cols):
                raise ValueError(
                    f"delta shape {delta.shape} != "
                    f"({self.num_rows}, {self.num_cols})")
            if compress is not None:
                self._add_compressed(delta, option, compress, sync)
                return
            if self.sync:
                with self._lock:
                    if option in self._pending_dense:
                        if option in self._pending_borrowed:
                            self._pending_dense[option] = (
                                self._pending_dense[option] + delta)
                            self._pending_borrowed.discard(option)
                        else:
                            self._pending_dense[option] += delta
                    elif borrow:
                        # Buffer the caller's array itself; a second add
                        # to this option allocates a fresh sum above.
                        self._pending_dense[option] = delta
                        self._pending_borrowed.add(option)
                    else:
                        self._pending_dense[option] = delta.astype(
                            self.dtype, copy=True)
                return
            self._apply_dense_now(delta, option)
            if sync:
                self._sync_device()

    def add_rows(self, row_ids, delta, option: Optional[AddOption] = None,
                 sync: bool = False, borrow: bool = False) -> None:
        """Row-subset push — the sparse hot write path (§3.3 with rows).

        ``delta`` is a host array or a tensor (fetched to the host for
        the duplicate segment-sum).  ``borrow=True`` skips the defensive
        delta copy/convert; the BSP buffer then holds the caller's array
        until the barrier flush."""
        with self._monitor("AddRows"):
            rows = np.asarray(row_ids, dtype=np.int64)
            delta = self._coerce_delta(delta, borrow)
            if delta.shape != (rows.shape[0], self.num_cols):
                raise ValueError("rows/delta shape mismatch")
            if self.sync:
                with self._lock:
                    self._pending_sparse.append((rows, delta, option))
                return
            self._apply_rows_now(rows, delta, option)
            if sync:
                self._sync_device()

    def flush(self) -> None:
        with self._lock:
            dense, self._pending_dense = self._pending_dense, {}
            sparse, self._pending_sparse = self._pending_sparse, []
            self._pending_borrowed = set()

        def apply(dense=dense, sparse=sparse):
            by_opt: Dict[Optional[AddOption],
                         List[Tuple[np.ndarray, np.ndarray]]] = {}
            for rows, deltas, option in sparse:
                by_opt.setdefault(option, []).append((rows, deltas))
            for option, batches in by_opt.items():
                rows = np.concatenate([r for r, _ in batches])
                deltas = np.concatenate([d for _, d in batches])
                self._apply_rows_now(rows, deltas, option)
            for option, delta in dense.items():
                self._apply_dense_now(delta, option)

        self._ssp_defer(apply if (dense or sparse) else None)

    def discard_pending(self) -> None:
        with self._lock:
            self._pending_dense = {}
            self._pending_sparse = []
            self._pending_borrowed = set()
            self._stale_queue = []

    # ----------------------------------------------------------- internals
    def _multihost_union(self, uniq: np.ndarray, agg: np.ndarray):
        """Union per-process (rows, deltas) across processes (collective).

        Multi-process mapping of per-worker sparse Adds: each process
        contributes its row batch, and every process gets the identical
        union batch (duplicates re-aggregated), whose rows it owns it
        applies.  Rows and deltas ride one float64 buffer through the
        shared padded-allgather (f64 holds row ids exactly to 2^53).
        """
        from .base import is_multiprocess

        if not is_multiprocess():
            return uniq, agg

        packed = np.empty((uniq.shape[0], self.num_cols + 1),
                          dtype=np.float64)
        packed[:, 0] = uniq
        packed[:, 1:] = agg
        all_packed = np.concatenate(multihost_allgather_list(packed))
        uniq2, inv2 = np.unique(
            all_packed[:, 0].astype(np.int64), return_inverse=True)
        agg2 = np.zeros((uniq2.shape[0], self.num_cols), dtype=self.dtype)
        np.add.at(agg2, inv2.reshape(-1), all_packed[:, 1:].astype(self.dtype))
        return uniq2, agg2

    def _apply_dense_now(self, delta: np.ndarray,
                         option: Optional[AddOption]) -> None:
        self._apply_dense_padded(delta, option)

    def _apply_rows_now(self, rows: np.ndarray, delta: np.ndarray,
                        option: Optional[AddOption]) -> None:
        opt = option or self.default_option
        # Pre-aggregate duplicates (segment-sum) so stateful updaters see a
        # single delta per row; reference servers get the same effect from
        # sequential Add application.
        uniq, inv = np.unique(rows, return_inverse=True)
        agg = np.zeros((uniq.shape[0], self.num_cols), dtype=self.dtype)
        np.add.at(agg, inv.reshape(-1), delta)
        uniq, agg = self._multihost_union(uniq, agg)
        # Out-of-range ids are dropped here, on the host (the JAX
        # package's scatter drops them with mode="drop"); sharded, so are
        # the rows other ranks own, and the rest go to their offsets in
        # this rank's block.  Padding rows are never written.
        sh = self.shard
        live = sh.owned(uniq)
        if live.any():
            if not live.all():
                r, d = uniq[live], agg[live]
            else:
                r, d = uniq, agg
            if sh.offset:
                r = r - sh.offset
            r_dev = host_put(r, self.device)
            d_dev = host_put(d, self.device)
            with self._lock:
                # In place: the row add costs the rows, not the table.
                data, state = self.updater.apply_rows(
                    self._data, self._state, r_dev, d_dev, opt)
                self._data, self._state = data, tuple(state)
        # Serve layer: bucket-granular bump — uniq is already the
        # cross-rank union, so every rank stamps identical buckets (and
        # the workload tracker charges the touched rows).
        self._serve_bump(uniq, keys=[int(r) for r in uniq])

    # ------------------------------------------------ fused (on-device) path
    def raw_value(self) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
        """Hand the tensors to a training step (the fused hot loop): this
        rank's blocks (the whole table in one process), which the step
        reads through ``rows_of`` and updates through ``scatter_rows``."""
        return self._data, self._state

    def rows_of(self, data: torch.Tensor, ids: torch.Tensor
                ) -> torch.Tensor:
        """Rows ``ids`` (a device tensor of live ids) of the table whose
        block is ``data``, for a fused step: ``data[ids]`` in one
        process; sharded, each rank fills the ids it owns and one sum
        across ranks hands every rank every row (a collective)."""
        sh = self.shard
        if not sh.sharded:
            return data[ids]
        own = sh.owned(ids)
        got = data[torch.where(own, ids - sh.offset, 0)]
        return device_sum(torch.where(own[:, None], got,
                                      torch.zeros_like(got)))

    def scatter_rows(self, data, state, ids: torch.Tensor,
                     delta: torch.Tensor, opt: AddOption):
        """``updaters.base.scatter_apply`` of a fused step's row deltas
        into the block ``data``/``state``, in place: sharded, every rank
        passes the same ids and deltas and applies only the live rows it
        owns, at their offsets (duplicates aggregate over the whole
        batch first, as in one process)."""
        sh = self.shard
        upd = self.updater
        if not sh.sharded:
            return updater_base.scatter_apply(upd, data, state, ids, delta,
                                              opt)
        if upd.linear:
            return upd.apply_rows(data, state, ids - sh.offset, delta, opt,
                                  mask=sh.owned(ids))
        uniq, agg, mask = updater_base.aggregate_rows(ids, delta)
        return upd.apply_rows(data, state, uniq - sh.offset, agg, opt,
                              mask=mask & sh.owned(uniq))

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
        data, state = self._dense_snapshot(self.num_rows)
        return {
            "kind": self.kind,
            "shape": (self.num_rows, self.num_cols),
            "data": data,
            "state": state,
        }

    def load_state(self, snap: Any) -> None:
        if (snap["kind"] != self.kind
                or tuple(snap["shape"]) != (self.num_rows, self.num_cols)):
            raise ValueError(
                f"snapshot of a {snap['kind']} table of shape "
                f"{tuple(snap['shape'])} cannot load into {self.kind} "
                f"table '{self.name}' of shape "
                f"{(self.num_rows, self.num_cols)}")
        self._dense_restore(snap["data"], snap["state"])
