"""SparseMatrixTable — sparse-access variant of MatrixTable.

Reference (SURVEY.md §2.13, ``table/sparse_matrix_table.h``): only touched
rows travel the wire; the server tracks which rows each worker holds.

TPU-native: off-shard row traffic already moves as gathers/scatters over
ICI, so the "only touched rows" property is inherent.  What this subclass
adds is the reference's *worker-side freshness* feature: a host row cache so
repeated ``get_rows`` of hot rows (LightLDA's access pattern) skip the
device round-trip until the row is invalidated by an add or a clock tick.
"""

from __future__ import annotations

import threading
from typing import Optional

import numpy as np

from .matrix_table import MatrixTable

__all__ = ["SparseMatrixTable"]


class SparseMatrixTable(MatrixTable):
    kind = "sparse_matrix"

    def __init__(self, *args, cache: bool = True, **kw):
        super().__init__(*args, **kw)
        self._cache_enabled = cache
        # Vectorized cache: a dense [rows, cols] mirror plus a validity
        # bitmap — no per-row Python objects, so hit/miss classification
        # is one boolean mask and assembly one fancy-index.  Allocated on
        # first use so ``cache=False`` tables cost nothing.
        # Memory note: the mirror is num_rows × num_cols on the host; for
        # LightLDA-scale word-topic tables that is the same footprint the
        # reference's worker-side row cache converges to on a hot table.
        self._cache_valid: Optional[np.ndarray] = None
        self._cache_data: Optional[np.ndarray] = None
        self._cache_lock = threading.Lock()

    def get_rows(self, row_ids, option=None) -> np.ndarray:
        from .base import is_multiprocess

        rows = np.asarray(row_ids, dtype=np.int64)
        if not self._cache_enabled:
            return super().get_rows(rows, option)
        multi = is_multiprocess()
        if rows.shape[0] == 0 and not multi:
            return np.zeros((0, self.num_cols), dtype=self.dtype)
        # Ids outside [0, num_rows) read the zero padded region on the
        # device path (static-shape TPU semantics); mirror that here
        # rather than letting them index the cache arrays.
        in_range = (rows >= 0) & (rows < self.num_rows)
        # _cache_lock held across the fetch: a concurrent add_rows must not
        # invalidate entries between the miss check and the assembly below.
        # (Distinct from self._lock, which the inherited add path takes —
        # holding that one here would serialize against device applies.)
        with self._cache_lock:
            if self._cache_valid is None:
                self._cache_valid = np.zeros(self.num_rows, dtype=bool)
                self._cache_data = np.zeros(
                    (self.num_rows, self.num_cols), dtype=self.dtype)
            safe = rows[in_range]
            missing = np.unique(safe[~self._cache_valid[safe]])
            # Workload plane (docs/observability.md): rows served from
            # this table's own mirror never reach the base `_serve_read`
            # keys= hook, so the hot-key sketch / bucket load counters
            # would miss exactly the HOT traffic.  Note the mirror-hit
            # rows here; the `super().get_rows(missing)` call below
            # notes the misses itself — no double counting.
            if self._workload is not None:
                hit_mask = np.ones(rows.shape[0], dtype=bool)
                hit_mask &= in_range
                if missing.shape[0]:
                    hit_mask &= ~np.isin(rows, missing)
                hits = rows[hit_mask]
                if hits.shape[0]:
                    self._workload.note_get(hits.tolist())
            # Multi-host the base fetch is a lockstep collective, so every
            # rank must join it even with zero local misses (peers may
            # miss different rows; the union path merges the id sets).
            if missing.shape[0] or multi:
                fetched = super().get_rows(missing, option)
                self._cache_data[missing] = fetched
                self._cache_valid[missing] = True
            if in_range.all():
                return self._cache_data[rows]      # fancy index = fresh copy
            out = np.zeros((rows.shape[0], self.num_cols), dtype=self.dtype)
            out[in_range] = self._cache_data[safe]
            return out

    def _invalidate(self, rows: Optional[np.ndarray] = None) -> None:
        with self._cache_lock:
            if self._cache_valid is None:
                return
            if rows is None:
                self._cache_valid[:] = False
            else:
                rows = np.asarray(rows, dtype=np.int64)
                rows = rows[(rows >= 0) & (rows < self.num_rows)]
                self._cache_valid[rows] = False

    def add_rows(self, row_ids, delta, option=None, sync: bool = False,
                 borrow: bool = False) -> None:
        from .base import is_multiprocess

        super().add_rows(row_ids, delta, option=option, sync=sync,
                         borrow=borrow)
        if is_multiprocess():
            # The collective apply touched the UNION of every rank's rows
            # (matrix_table._multihost_union); invalidating only the local
            # ids would serve peers' updated rows stale from the cache.
            self._invalidate()
        else:
            self._invalidate(np.asarray(row_ids, dtype=np.int64))

    def add(self, delta, option=None, sync: bool = False,
            borrow: bool = False) -> None:
        super().add(delta, option=option, sync=sync, borrow=borrow)
        self._invalidate()

    def flush(self) -> None:
        super().flush()
        self._invalidate()

    def load_state(self, snap) -> None:
        super().load_state(snap)
        self._invalidate()

    def raw_assign(self, data, state=None) -> None:
        super().raw_assign(data, state)
        self._invalidate()

    def close(self) -> None:
        super().close()
        with self._cache_lock:
            self._cache_valid = None
            self._cache_data = None   # the host mirror can be table-sized
