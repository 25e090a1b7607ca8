"""KVTable — key→value table with a worker-local cache.

Reference (SURVEY.md §2.14, ``table/kv_table.h``): hash-map table; the
worker keeps a local dict (``KVWorkerTable::raw``), ``Get(keys)`` refreshes
it from the server, ``Add`` pushes deltas.

TPU-native: KV data is control-plane metadata (vocabulary counts, clocks,
small stats) — it stays on the host.  Values are numpy arrays; updater math
runs vectorized per key in numpy (the server-side hot loop is trivial at
this scale).

Multi-host: like every table, eager ``add`` (and the barrier-driven
``flush``) is a lockstep collective under ``process_count() > 1`` — each
rank's update dict is allgathered (pickled bytes, padded to a common
length) and the per-key delta *sums* are applied identically on every
rank, so stores converge exactly as the Array/Matrix collective-add
paths do.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..updaters import AddOption
from .base import Table

__all__ = ["KVTable"]


def _np_apply(name: str, w: np.ndarray, state: List[np.ndarray],
              d: np.ndarray, opt: AddOption) -> np.ndarray:
    """Numpy mirror of the jnp updaters (same math, host execution)."""
    if name in ("default", "add"):
        w += d
    elif name == "sgd":
        w -= opt.learning_rate * d
    elif name == "adagrad":
        state[0] += d * d
        w -= opt.learning_rate * d / (np.sqrt(state[0]) + opt.eps)
    elif name == "momentum":
        state[0][...] = opt.momentum * state[0] + opt.learning_rate * d
        w -= state[0]
    elif name == "smooth_gradient":
        state[0][...] = opt.rho * state[0] + (1.0 - opt.rho) * d
        w -= opt.learning_rate * state[0]
    elif name == "assign":
        w[...] = d          # last-write-wins store (docs/host_bridge.md)
    else:
        raise ValueError(f"unknown updater {name}")
    return w


class KVTable(Table):
    kind = "kv"

    def __init__(self, value_shape: Tuple[int, ...] = (), dtype=np.float32,
                 coalesce: bool = False, **kw):
        """``coalesce=True``: eager (ASP) adds buffer locally and merge
        into ONE collective at the next ``barrier()`` instead of paying a
        pickle-allgather per call — the knob for hot-loop KV use under
        multi-host.  Trades read-your-own-writes (the store, and peers,
        see the adds at the barrier).  No-op semantics change under a
        single controller beyond the barrier-visible timing.
        """
        super().__init__(**kw)
        self.value_shape = tuple(value_shape)
        self.dtype = np.dtype(dtype)
        self.coalesce = bool(coalesce)
        self._store: Dict[Any, np.ndarray] = {}
        self._state: Dict[Any, List[np.ndarray]] = {}
        # Reference-parity worker mirror (KVWorkerTable::raw): holds
        # exactly the keys the app Get()s, i.e. it tracks the store's
        # own key universe — not an eviction candidate without breaking
        # the reference raw() contract.
        self._cache: Dict[Any, np.ndarray] = {}  # mvlint: MV007-exempt(tracks the store's own key universe — reference raw() contract)
        self._pending: List[Tuple[Dict[Any, np.ndarray],
                                  Optional[AddOption]]] = []

    @property
    def raw(self) -> Dict[Any, np.ndarray]:
        """Worker-local cache (reference ``KVWorkerTable::raw``)."""
        return self._cache

    def _zero(self) -> np.ndarray:
        return np.zeros(self.value_shape, dtype=self.dtype)

    def get(self, keys) -> Dict[Any, np.ndarray]:
        """Refresh the local cache for ``keys`` from the store."""
        with self._monitor("Get"):
            keys = list(keys)

            # Key-granular serve cache first (docs/embedding.md): one
            # versioned entry PER KEY, gated by its own crc32 bucket —
            # a hot key keeps hitting across different key sets, and a
            # miss fetches only the missing keys.  None = disarmed;
            # the key-set path below takes over.
            def fetch_subset(sub):
                with self._lock:
                    return [
                        (self._store[k].copy() if k in self._store
                         else self._zero())
                        for k in sub]

            vals = self._serve_read_rows(
                "kv", keys, fetch_subset,
                buckets=[self.serve_key_bucket(k) for k in keys],
                note_keys=[str(k) for k in keys])
            if vals is not None:
                # Per-caller copies: the cached values are read-only.
                out = {k: v.copy() for k, v in zip(keys, vals)}
            else:
                def fetch():
                    with self._lock:
                        for k in keys:
                            w = self._store.get(k)
                            self._cache[k] = (w.copy() if w is not None
                                              else self._zero())
                    return {k: self._cache[k] for k in keys}

                # Serve layer: per-key-set entries gated by the touched
                # key BUCKETS (crc32 — rank-stable), so adds to
                # unrelated keys keep these hitting.  Values are copied
                # on both cache boundaries — a caller mutating its dict
                # must not corrupt the cached copy.
                out = self._serve_read(
                    ("kv", tuple(keys)), fetch,
                    buckets=[self.serve_key_bucket(k) for k in keys],
                    collective_safe=False,
                    copy=lambda d: {k: v.copy() for k, v in d.items()},
                    keys=[str(k) for k in keys])
            # raw() contract: the mirror holds every key the app Get()s
            # even when the serve cache short-circuits fetch() above.
            with self._lock:
                for k, v in out.items():
                    self._cache[k] = v.copy()
            return out

    def add(self, updates: Dict[Any, Any],
            option: Optional[AddOption] = None, sync: bool = False,
            borrow: bool = False) -> None:
        """``borrow=True``: every value is already a correctly-typed
        ndarray the caller will not mutate while buffered — skips the
        per-value asarray churn (docs/host_bridge.md); a wrong dtype
        raises instead of silently converting."""
        with self._monitor("Add"):
            if borrow:
                for k, v in updates.items():
                    if not isinstance(v, np.ndarray) \
                            or v.dtype != self.dtype:
                        raise ValueError(
                            f"borrow=True: value for {k!r} is not a "
                            f"{self.dtype} ndarray — the borrow "
                            f"protocol never converts")
                ups = dict(updates)
            else:
                ups = {k: np.asarray(v, dtype=self.dtype)
                       for k, v in updates.items()}
            if self.sync or self.coalesce:
                # BSP buffering, or coalesce=True batching eager adds
                # into the per-barrier collective.
                with self._lock:
                    self._pending.append((ups, option))
                return
            self._apply_now(ups, option)

    def add_many(self, updates_list,
                 option: Optional[AddOption] = None) -> None:
        """Batch API: N update dicts, ONE apply (and under multi-host ONE
        pickle-allgather instead of N) — the explicit alternative to
        ``coalesce=True`` for callers that batch naturally."""
        with self._monitor("AddMany"):
            merged: Dict[Any, np.ndarray] = {}
            for ups in updates_list:
                for k, v in ups.items():
                    v = np.asarray(v, dtype=self.dtype)
                    merged[k] = merged[k] + v if k in merged else v.copy()
            if not merged:
                return
            self.add(merged, option=option)

    def discard_pending(self) -> None:
        with self._lock:
            self._pending = []
            self._stale_queue = []

    def flush(self) -> None:
        from .base import is_multiprocess

        with self._lock:
            pending, self._pending = self._pending, []
        # Aggregate per AddOption so each bucket flushes with its own
        # hyper-parameters.
        merged: Dict[Optional[AddOption], Dict[Any, np.ndarray]] = {}
        for ups, option in pending:
            bucket = merged.setdefault(option, {})
            for k, v in ups.items():
                if k in bucket:
                    bucket[k] = bucket[k] + v
                else:
                    bucket[k] = v.copy()

        def apply(merged=merged):
            m = merged
            if is_multiprocess():
                # ONE collective for the whole flush, entered by every
                # rank even with nothing pending (a rank that
                # early-returned while peers allgathered would deadlock
                # the job), carrying the (option, ups) buckets so ranks
                # whose clocks used different AddOptions still merge per
                # matching option.
                m = self._multihost_merge_buckets(m)
            for option, ups in m.items():
                self._apply_local(ups, option)

        # NOTE the multi-host lockstep contract: the merge collective runs
        # inside the (possibly SSP-deferred) apply, and clocks advance in
        # lockstep, so every rank defers and enters it at the same barrier.
        # Unlike the dense tables, an empty flush must still apply (the
        # allgather is unconditional), so no empty-skip here.
        self._ssp_defer(apply)

    def _allgather_payload(self, payload: Any) -> List[Any]:
        """Pickle → byte-allgather → unpickle per rank (one collective).

        Same semantic mapping as ``tables.base.multihost_sum``: every
        rank contributes its own payload, every rank sees the identical
        rank-ordered list and merges deterministically.  Wire hygiene
        (docs/host_bridge.md): HIGHEST_PROTOCOL (out-of-band-capable
        framing, smaller ndarray pickles than the old pinned
        protocol=4) and the gathered parts feed ``pickle.loads``
        DIRECTLY via the buffer protocol — the old ``part.tobytes()``
        detour copied every rank's payload once more per gather.
        """
        import pickle

        from .base import multihost_allgather_list

        blob = np.frombuffer(
            pickle.dumps(payload, protocol=pickle.HIGHEST_PROTOCOL),
            np.uint8)
        return [pickle.loads(part)
                for part in multihost_allgather_list(blob)]

    def _multihost_merge_buckets(
            self, merged: Dict[Optional[AddOption], Dict[Any, np.ndarray]],
    ) -> Dict[Optional[AddOption], Dict[Any, np.ndarray]]:
        """Merge every rank's option-keyed flush buckets (collective)."""
        all_buckets = self._allgather_payload(list(merged.items()))
        out: Dict[Optional[AddOption], Dict[Any, np.ndarray]] = {}
        for rank_buckets in all_buckets:
            for option, ups in rank_buckets:
                bucket = out.setdefault(option, {})
                for k, v in ups.items():
                    if k in bucket:
                        bucket[k] = bucket[k] + v
                    else:
                        bucket[k] = np.asarray(v, dtype=self.dtype).copy()
        return out

    def _apply_now(self, ups: Dict[Any, np.ndarray],
                   option: Optional[AddOption]) -> None:
        from .base import is_multiprocess

        if is_multiprocess():
            # Eager-path collective: sum every rank's dict, apply the sum.
            merged: Dict[Any, np.ndarray] = {}
            for rank_ups in self._allgather_payload(ups):
                for k, v in rank_ups.items():
                    if k in merged:
                        merged[k] = merged[k] + v
                    else:
                        merged[k] = np.asarray(v, dtype=self.dtype).copy()
            ups = merged
        self._apply_local(ups, option)

    def _apply_local(self, ups: Dict[Any, np.ndarray],
                     option: Optional[AddOption]) -> None:
        opt = option or self.default_option
        with self._lock:
            for k, d in ups.items():
                w = self._store.get(k)
                if w is None:
                    w = self._zero()
                st = self._state.get(k)
                if st is None:
                    st = [np.zeros_like(w)
                          for _ in range(self.updater.num_slots)]
                    self._state[k] = st
                self._store[k] = _np_apply(
                    self.updater_type, w.copy(), st, d, opt)
        if ups:
            # Serve layer: one version bump per apply batch, stamping
            # only the touched key buckets.
            self._serve_bump([self.serve_key_bucket(k) for k in ups],
                             keys=[str(k) for k in ups])

    # ------------------------------------------------------------ checkpoint
    def store_state(self) -> Any:
        with self._lock:
            return {
                "kind": self.kind,
                "store": {k: v.copy() for k, v in self._store.items()},
                "state": {k: [s.copy() for s in v]
                          for k, v in self._state.items()},
            }

    def load_state(self, snap: Any) -> None:
        assert snap["kind"] == self.kind
        with self._lock:
            self._store = {k: np.asarray(v) for k, v in snap["store"].items()}
            self._state = {k: [np.asarray(s) for s in v]
                           for k, v in snap["state"].items()}
            self._cache.clear()
        self._serve_bump()   # restored timeline: cached reads are void
