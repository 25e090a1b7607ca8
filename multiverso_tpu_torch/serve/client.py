"""ServeClient — the hot-path read client over the native wire plane
(docs/serving.md).

Wraps a :class:`~multiverso_tpu_torch.native.NativeRuntime` with the three
serve-layer mechanisms so concurrent readers stop paying one full wire
round trip per ``get()``:

1. **Coalescing** — concurrent/window-adjacent gets on the same table
   merge into one wire round trip (``-coalesce_window_us``, size-capped
   by ``-serve_max_batch``); row gets union their ids; adds aggregate
   into one delta per AddOption.
2. **Versioned cache** — a bounded LRU serves repeat reads locally while
   ``cached_version >= server_version - max_staleness``.  Knowledge of
   the server version comes free from reply stamps
   (``NativeRuntime.last_version``), stays trusted for
   ``-version_lease_ms``, and is refreshed past the lease by a cheap
   header-only probe (``MV_TableVersion``) instead of a full fetch.
   ``max_staleness=0`` + ``lease_ms=0`` never serves a stale read —
   every cached read pays one probe (still far cheaper than the fetch).
3. **Busy retry** — a server shedding under ``-server_inflight_max``
   raises :class:`~multiverso_tpu_torch.native.BusyError`; the client's
   :class:`~multiverso_tpu_torch.fault.RetryPolicy` backs off and retries
   (the schedule; ``retry.attempts`` counts in the registry).

Chaos seams (tests/test_serve.py): ``fault.inject("serve.busy")`` fires
inside the wire path — configure it with ``error=BusyError`` to script
shed storms; ``fault.inject("serve.stale")`` fires at the hit decision
and forces that read to miss.
"""

from __future__ import annotations

import time
from typing import Any, Optional, Sequence

import numpy as np

from .. import config, fault, metrics, tracing
from ..native import BusyError
from .cache import VersionedLRUCache
from .coalescer import Coalescer

__all__ = ["ServeClient"]


def _flag(value, name):
    return config.get(name) if value is None else value


class ServeClient:
    """Read-optimized facade over a NativeRuntime (one per process).

    All knobs default to the config flags so launch scripts tune the
    serve layer the same way they tune the wire (``-coalesce_window_us``
    etc.).  ``max_staleness`` is a VERSION distance: how many server-side
    applies a served read may be behind (0 = reads are never stale).
    """

    def __init__(self, rt: Any, *,
                 max_staleness: Optional[int] = None,
                 cache_entries: Optional[int] = None,
                 window_us: Optional[float] = None,
                 max_batch: Optional[int] = None,
                 lease_ms: Optional[float] = None,
                 row_cache: Optional[bool] = None,
                 retry: Optional[fault.RetryPolicy] = None,
                 hedge=None):
        self.rt = rt
        # Tail-at-scale hedging (docs/serving.md "tail"): an optional
        # serve.hedge.HedgedReader the row-cache MISS path fetches
        # through instead of the runtime — past the p95-derived delay
        # the read re-issues against the reactor-served hot-key replica
        # and the loser is cancelled.  Single-shard scope: the reader
        # targets one endpoint, so arm it only when that shard owns the
        # rows this client reads (the DLRM serve shape).
        self.hedge = hedge
        self.max_staleness = int(_flag(max_staleness, "max_staleness"))
        entries = int(_flag(cache_entries, "serve_cache_entries"))
        self.cache = VersionedLRUCache(max(entries, 1))
        self._cache_on = entries > 0
        # Row-granular entries for matrix row / KV key reads
        # (docs/embedding.md): each id is its own versioned entry, so a
        # hot row hits across different requested id sets and a miss
        # wire-fetches only the missing ids.  -serve_row_cache=false
        # reverts to the whole-id-set entries.
        self._row_cache = bool(_flag(row_cache, "serve_row_cache"))
        self.coalescer = Coalescer(
            window_s=float(_flag(window_us, "coalesce_window_us")) * 1e-6,
            max_batch=int(_flag(max_batch, "serve_max_batch")))
        self.lease_s = float(_flag(lease_ms, "version_lease_ms")) * 1e-3
        self.retry = retry or fault.RetryPolicy(
            attempts=6, backoff_s=0.01, max_backoff_s=0.5,
            retry_on=(BusyError,))
        # Version-knowledge lease per handle: (version, monotonic ts).
        # Bounded by the process's table-handle count, not by data.
        self._known: dict = {}  # mvlint: MV007-exempt(one entry per table handle)
        # Fleet routing epoch last observed (docs/replication.md):
        # re-checked before every cached read — a promotion/join flip
        # voids cached entries and version leases, whose stamps came
        # from a shard owner that may no longer serve.
        self._route_epoch = 0

    def _check_routing_epoch(self) -> None:
        """Re-check the fleet routing epoch before serving from cache
        (docs/replication.md): cached values and version leases were
        stamped under the PREVIOUS shard→rank map; after a promotion
        or join flip they must be dropped and re-resolved against the
        new owner, never served on the stale route."""
        try:
            epoch = int(self.rt.routing_epoch())
        except Exception:
            return  # pre-replication runtime / stub: epoch-less
        if epoch == self._route_epoch:
            return
        self._route_epoch = epoch
        self.cache.invalidate()
        self._known.clear()
        metrics.counter("serve.route_flip").inc()

    # ------------------------------------------------ version knowledge
    def _note(self, handle: int) -> None:
        """Fold the latest reply stamp into the lease (free, no wire)."""
        v = self.rt.last_version(handle)
        old = self._known.get(handle)
        if old is None or v > old[0]:
            self._known[handle] = (v, time.monotonic())

    def _server_version(self, handle: int) -> int:
        """Best-known server version, probing past the lease.

        Within ``-version_lease_ms`` of the last observation the cached
        knowledge is trusted (zero wire traffic — the demo's repeat-read
        path); beyond it, one header-only RequestVersion round trip
        refreshes it (``serve.probe`` counts them).
        """
        known = self._known.get(handle)
        if known is not None and self.lease_s > 0 and \
                time.monotonic() - known[1] <= self.lease_s:
            return known[0]
        metrics.counter("serve.probe").inc()
        v = self.retry.run(self.rt.table_version, handle)
        self._known[handle] = (v, time.monotonic())
        return v

    def _read_version(self, handle: int) -> Optional[int]:
        """Server-version estimate gating THIS read (None = cache off).

        Doubles as the cache stamp for the value a miss fetches: the
        fetch runs AFTER this estimate, so the data is at least this
        new — stamping with a post-fetch ``last_version`` instead could
        over-stamp (a concurrent add's ack landing between fetch and
        stamp would mark pre-add data post-add fresh)."""
        self._check_routing_epoch()
        if not self._cache_on:
            return None
        return self._server_version(handle)

    @staticmethod
    def _forced_stale() -> bool:
        """``serve.stale`` chaos seam: an injected fault forces this
        read to miss (scriptable staleness storms)."""
        try:
            fault.inject("serve.stale")
        except fault.FaultError:
            return True
        return False

    # ------------------------------------------------------------ reads
    def _cached(self, handle: int, key: tuple, fetch) -> np.ndarray:
        """Shared read path: cache -> coalesced fetch -> store."""
        v0 = self._read_version(handle)
        if v0 is not None:
            # Chaos misses count only with the cache armed — a disabled
            # cache (serve_cache_entries=0) must not accrue miss stats.
            if self._forced_stale():
                metrics.counter("serve.cache.miss").inc()
            else:
                hit = self.cache.lookup(key,
                                        min_version=v0 - self.max_staleness)
                if hit is not None:
                    return hit[0].copy()

        def execute(items):
            def wire():
                fault.inject("serve.busy")
                return fetch()
            out = self.retry.run(wire)
            # One wire value serves every coalesced waiter.
            return [out] * len(items)

        with tracing.span("serve::get", table=str(handle)):
            val = self.coalescer.submit(key, None, execute)
        self._note(handle)
        if v0 is not None:
            # Store the wire value ITSELF, read-only flagged: every
            # consumer (coalesced waiters below, future hits above)
            # copies exactly once at its own boundary, so the old
            # store-a-copy pair cost one redundant full-payload copy
            # per miss (docs/host_bridge.md).  The writeable=False flip
            # turns any aliasing slip into a loud ValueError instead of
            # silent cache corruption.
            val.flags.writeable = False
            self.cache.store(key, val, v0)
        # Per-caller copy: coalesced waiters all hold the SAME wire
        # ndarray — returned uncopied, one caller's in-place mutation
        # would corrupt every other waiter's result (the hit path above
        # already copies).
        return val.copy()

    def array_get(self, handle: int, size: int) -> np.ndarray:
        return self._cached(handle, (handle, "array", size),
                            lambda: self.rt.array_get(handle, size))

    def matrix_get_all(self, handle: int, rows: int, cols: int) -> np.ndarray:
        return self._cached(handle, (handle, "all", rows, cols),
                            lambda: self.rt.matrix_get_all(handle, rows,
                                                           cols))

    def matrix_get_rows(self, handle: int, row_ids: Sequence[int],
                        cols: int) -> np.ndarray:
        """Row-range read: concurrent callers' id sets UNION into one
        wire request; each gets back exactly its rows.

        With the cache armed the entries are ROW-GRANULAR
        (docs/embedding.md): each id caches individually under the same
        versioned staleness bound, so a hot row hits across different
        id sets and a partial miss wire-fetches only the missing rows.
        ``-serve_row_cache=false`` reverts to per-id-set entries."""
        ids = np.ascontiguousarray(row_ids, dtype=np.int32)
        v0 = self._read_version(handle)
        if v0 is not None and self._row_cache and ids.size:
            return self._get_rows_row_granular(handle, ids, cols, v0)
        key = (handle, "rows", tuple(ids.tolist()))
        if v0 is not None:
            if self._forced_stale():
                metrics.counter("serve.cache.miss").inc()
            else:
                hit = self.cache.lookup(key,
                                        min_version=v0 - self.max_staleness)
                if hit is not None:
                    return hit[0].copy()

        def execute(items):
            union = np.unique(np.concatenate(items))

            def wire():
                fault.inject("serve.busy")
                return self.rt.matrix_get_rows(handle, union, cols)
            fetched = self.retry.run(wire)
            # Scatter each waiter its own rows (union is sorted).
            return [fetched[np.searchsorted(union, it)] for it in items]

        with tracing.span("serve::get_rows", table=str(handle),
                          k=int(ids.size)):
            val = self.coalescer.submit((handle, "rows"), ids, execute)
        self._note(handle)
        if v0 is not None:
            self.cache.store(key, val.copy(), v0)
        return val

    def _get_rows_row_granular(self, handle: int, ids: np.ndarray,
                               cols: int, v0: int) -> np.ndarray:
        """Row-granular read tail: per-row lookups, one coalesced union
        wire fetch for the misses, per-row stores stamped with the
        PRE-fetch version estimate (the same conservative discipline as
        ``_cached``)."""
        forced = self._forced_stale()
        if forced:
            metrics.counter("serve.cache.miss").inc()
        id_list = ids.tolist()
        uniq = list(dict.fromkeys(id_list))  # order-preserving dedup
        hits: dict = {}
        missing = []
        if forced:
            missing = uniq
        else:
            # ONE lock + counter update for the whole id set — per-key
            # lookup() calls cost more than the wire fetch they save.
            got = self.cache.lookup_many(
                [(handle, "row", r) for r in uniq],
                v0 - self.max_staleness)
            for r, val in zip(uniq, got):
                if val is not None:
                    hits[r] = val
                else:
                    missing.append(r)
        if missing:
            miss = np.asarray(missing, np.int32)

            def execute(items):
                union = np.unique(np.concatenate(items))

                def wire():
                    fault.inject("serve.busy")
                    if self.hedge is not None:
                        # Hedged miss (docs/serving.md "tail"): the
                        # wire fetch races the hot-key replica past the
                        # hedge delay; serve.hedge.{issued,won,wasted}
                        # count the outcome.
                        return self.hedge.get_rows(union)
                    return self.rt.matrix_get_rows(handle, union, cols)
                fetched = self.retry.run(wire)
                return [fetched[np.searchsorted(union, it)]
                        for it in items]

            with tracing.span("serve::get_rows", table=str(handle),
                              k=int(miss.size)):
                got = self.coalescer.submit((handle, "rows"), miss,
                                            execute)
            self._note(handle)
            for j, r in enumerate(missing):
                row = np.ascontiguousarray(got[j])
                # Read-only in the cache: one copy per consumer at its
                # own boundary (np.stack below), aliasing slips fail
                # loudly.
                row.flags.writeable = False
                self.cache.store((handle, "row", r), row, v0)
                hits[r] = row
        # Fresh caller-owned result assembled row by row out of the
        # read-only cached rows (np.empty + copyto beats np.stack's
        # sequence machinery ~2x on the 8-row hot path).
        out = np.empty((len(id_list), cols), np.float32)
        for j, r in enumerate(id_list):
            out[j] = hits[r]
        return out

    def kv_get(self, handle: int, keys) -> Any:
        """KV read (str or list of str).  Batch reads cache per KEY
        (docs/embedding.md) when the row cache is armed — a hot key
        hits across different key sets, a partial miss wire-fetches
        only the missing keys; ``-serve_row_cache=false`` reverts to
        per-key-set entries."""
        single = isinstance(keys, str)
        v0 = self._read_version(handle)
        if v0 is not None and self._row_cache and not single and keys:
            return self._kv_get_key_granular(handle, list(keys), v0)
        tup = (keys,) if single else tuple(keys)
        key = (handle, "kv", tup)
        if v0 is not None:
            if self._forced_stale():
                metrics.counter("serve.cache.miss").inc()
            else:
                hit = self.cache.lookup(key,
                                        min_version=v0 - self.max_staleness)
                if hit is not None:
                    out = hit[0]
                    return out if single else np.array(out, copy=True)

        def execute(items):
            def wire():
                fault.inject("serve.busy")
                return self.rt.kv_get(handle, keys)
            out = self.retry.run(wire)
            return [out] * len(items)

        with tracing.span("serve::kv_get", table=str(handle)):
            val = self.coalescer.submit(key, None, execute)
        self._note(handle)
        if v0 is not None:
            # Batch values are stored READ-ONLY and uncopied (the same
            # one-copy-per-miss discipline as _cached above); the
            # per-caller copy below is the single copy.
            if not single:
                val.flags.writeable = False
            self.cache.store(key, val, v0)
        # Single-key reads are python floats (immutable); batch reads are
        # one ndarray SHARED by every coalesced waiter — copy per caller.
        return val if single else np.array(val, copy=True)

    def _kv_get_key_granular(self, handle: int, keys: list,
                             v0: int) -> np.ndarray:
        """Per-key cached KV batch read: values are python floats
        (immutable — no copy discipline needed), missing keys fetch in
        one coalesced union wire request."""
        forced = self._forced_stale()
        if forced:
            metrics.counter("serve.cache.miss").inc()
        uniq = list(dict.fromkeys(keys))
        hits: dict = {}
        missing = []
        if forced:
            missing = uniq
        else:
            got = self.cache.lookup_many(
                [(handle, "kvkey", k) for k in uniq],
                v0 - self.max_staleness)
            for k, val in zip(uniq, got):
                if val is not None:
                    hits[k] = val
                else:
                    missing.append(k)
        if missing:
            def execute(items):
                union = []
                seen = set()
                for it in items:
                    for k in it:
                        if k not in seen:
                            seen.add(k)
                            union.append(k)

                def wire():
                    fault.inject("serve.busy")
                    return self.rt.kv_get(handle, union)
                fetched = self.retry.run(wire)
                lut = dict(zip(union, fetched))
                return [[lut[k] for k in it] for it in items]

            with tracing.span("serve::kv_get", table=str(handle),
                              k=len(missing)):
                got = self.coalescer.submit((handle, "kv"), missing,
                                            execute)
            self._note(handle)
            for k, v in zip(missing, got):
                v = float(v)
                self.cache.store((handle, "kvkey", k), v, v0)
                hits[k] = v
        return np.asarray([hits[k] for k in keys], np.float32)

    # ----------------------------------------------------------- writes
    def array_add(self, handle: int, delta, *, coalesce: bool = True,
                  sync: bool = True) -> None:
        """Write path: deltas queued inside one coalescing window merge
        into ONE aggregated wire add (sum — the linear-composition
        contract every BSP flush in this repo already relies on), then
        every cached read of the table is invalidated (write-through).
        """
        # Legitimate copy (MV012 exempt by hoisting): callers hand this
        # façade arbitrary dtypes/layouts, and the coalescer may SUM the
        # buffer with siblings — it must own a normalized copy.  Hot
        # loops that control their buffers use the arena/borrowed path
        # on NativeRuntime directly (docs/host_bridge.md).
        d = np.ascontiguousarray(delta, dtype=np.float32)
        if not coalesce:
            self.retry.run(self.rt.array_add, handle, d, sync=sync)
        else:
            def execute(items):
                agg = items[0] if len(items) == 1 else np.sum(items, axis=0)

                def wire():
                    fault.inject("serve.busy")
                    self.rt.array_add(handle, agg, sync=sync)
                self.retry.run(wire)
                metrics.counter("serve.coalesce.adds").inc(len(items))
                return [None] * len(items)

            with tracing.span("serve::add", table=str(handle)):
                self.coalescer.submit((handle, "add"), d, execute)
        self.invalidate(handle)
        if sync:
            self._note(handle)  # the ack stamped the post-apply version

    def matrix_add_rows(self, handle: int, row_ids, delta, *,
                        sync: bool = True) -> None:
        self.retry.run(self.rt.matrix_add_rows, handle, row_ids, delta,
                       sync=sync)
        self.invalidate(handle)
        if sync:
            self._note(handle)

    def kv_add(self, handle: int, keys, deltas, *, sync: bool = True) -> None:
        self.retry.run(self.rt.kv_add, handle, keys, deltas, sync=sync)
        self.invalidate(handle)
        if sync:
            self._note(handle)

    # ------------------------------------------------------------ admin
    def invalidate(self, handle: Optional[int] = None) -> int:
        """Write-through invalidation: drop this handle's cached reads
        (all handles when None) and void the version lease so the next
        read re-learns the server version."""
        if handle is None:
            self._known.clear()
        else:
            self._known.pop(handle, None)
        return self.cache.invalidate(handle)

    def stats(self) -> dict:
        s = self.cache.stats()
        s["probes"] = int(metrics.counter("serve.probe").value)
        s["retries"] = int(metrics.counter("retry.attempts").value)
        h = metrics.histogram("serve.coalesce.batch")
        s["coalesced_batches"] = h.count
        s["coalesce_batch_p95"] = h.quantile(0.95)
        return s

    def replica_stats(self, handle: int) -> dict:
        """Native hot-key replica ledger for one matrix table
        (docs/embedding.md): rows this process's worker stub served
        from the replica vs sent to the wire, plus the co-located
        shard's push count.  ``{}`` when the runtime has no replica
        surface (stub runtimes in tests)."""
        fn = getattr(self.rt, "replica_stats", None)
        if fn is None:
            return {}
        return fn(handle)
