"""Versioned client cache — the read side of the serve layer
(docs/serving.md).

A bounded LRU keyed by arbitrary tuples, where every entry carries the
SERVER VERSION it was fetched at.  A lookup names the freshest version
the caller may not be behind (``min_version`` — typically
``server_version - max_staleness``); entries older than that miss, in
the SSPTable tradition of bounded-staleness reads (PAPERS.md: Cui et
al. ATC'14) — except the bound here is a VERSION distance (number of
server-side applies), not the SSP clock distance the training plane's
``-staleness`` flag speaks (see docs/serving.md for the mapping).

Thread-safe; every operation is O(1).  Counters land in the metrics
registry: ``serve.cache.hit`` / ``serve.cache.miss`` /
``serve.cache.evict`` / ``serve.cache.stale`` (a miss specifically
caused by the version bound).
"""

from __future__ import annotations

import itertools
import threading
import weakref
from collections import OrderedDict
from typing import Any, Hashable, Optional, Tuple

from .. import capacity, metrics

__all__ = ["VersionedLRUCache"]

# Distinguishes same-named caches in the capacity gauge registry (two
# ServeClients both name theirs "serve").
_GAUGE_SEQ = itertools.count()


class VersionedLRUCache:
    """Bounded LRU of (key -> value, version) with staleness-gated reads.

    ``max_entries`` is a hard bound: inserting into a full cache evicts
    the least-recently-used entry (mvlint MV007 — client-side caches in
    library code must be bounded).
    """

    def __init__(self, max_entries: int, name: str = "serve"):
        if max_entries <= 0:
            raise ValueError(f"max_entries must be > 0, got {max_entries}")
        self.max_entries = int(max_entries)
        self._name = name
        self._lock = threading.Lock()
        self._entries: "OrderedDict[Hashable, Tuple[Any, int]]" = \
            OrderedDict()  # bounded: see store()'s popitem eviction
        # Capacity plane (docs/observability.md): every serve-plane
        # cache registers a byte gauge — MV018's contract.  Weakly
        # bound: a dead cache prunes its own gauge at the next
        # snapshot, so short-lived ServeClients never leak registry
        # entries (that would be untracked growth in the tracker).
        self._gauge_name = f"{name}.cache.{next(_GAUGE_SEQ)}"
        ref = weakref.ref(self)

        def _gauge(ref=ref, gname=self._gauge_name) -> int:
            obj = ref()
            if obj is None:
                capacity.unregister_gauge(gname)
                return 0
            return obj.bytes()

        capacity.register_gauge(self._gauge_name, _gauge)

    def bytes(self) -> int:
        """Resident bytes of the cached values (+ per-entry overhead,
        the shared capacity unit)."""
        with self._lock:
            return capacity.container_bytes(self._entries)

    def _tick(self, what: str) -> None:
        metrics.counter(f"{self._name}.cache.{what}").inc()

    def lookup(self, key: Hashable,
               min_version: Optional[int] = None) -> Optional[Tuple[Any, int]]:
        """Return ``(value, version)`` when present AND fresh enough,
        else None.  ``min_version=None`` accepts any cached version
        (version gating disabled); otherwise an entry whose version is
        below ``min_version`` misses (and counts ``cache.stale``)."""
        with self._lock:
            hit = self._entries.get(key)
            if hit is not None:
                self._entries.move_to_end(key)
        if hit is None:
            self._tick("miss")
            return None
        if min_version is not None and hit[1] < min_version:
            self._tick("stale")
            self._tick("miss")
            return None
        self._tick("hit")
        return hit

    def lookup_many(self, keys, min_versions) -> list:
        """Batched row-granular lookup (docs/embedding.md): one lock
        acquisition and one counter update for the whole id set — the
        per-key ``lookup`` loop's lock/metrics cost is what kept the
        row cache from clearing the 10x serving bar.  ``min_versions``
        aligns with ``keys`` (or is a scalar applied to all); returns
        one value-or-None per key (None = absent or stale)."""
        scalar = not hasattr(min_versions, "__len__")
        out = []
        hits = misses = stale = 0
        with self._lock:
            for i, key in enumerate(keys):
                entry = self._entries.get(key)
                if entry is None:
                    out.append(None)
                    misses += 1
                    continue
                mv = min_versions if scalar else min_versions[i]
                if mv is not None and entry[1] < mv:
                    out.append(None)
                    stale += 1
                    misses += 1
                    continue
                self._entries.move_to_end(key)
                out.append(entry[0])
                hits += 1
        if hits:
            metrics.counter(f"{self._name}.cache.hit").inc(hits)
        if misses:
            metrics.counter(f"{self._name}.cache.miss").inc(misses)
        if stale:
            metrics.counter(f"{self._name}.cache.stale").inc(stale)
        return out

    def store(self, key: Hashable, value: Any, version: int) -> None:
        """Insert/refresh an entry; never lowers a cached version (a
        racing slow fetch must not roll a fresher entry back)."""
        with self._lock:
            old = self._entries.get(key)
            if old is not None and old[1] > version:
                return
            self._entries[key] = (value, int(version))
            self._entries.move_to_end(key)
            while len(self._entries) > self.max_entries:
                self._entries.popitem(last=False)   # LRU eviction bound
                self._tick("evict")

    def invalidate(self, prefix: Optional[Hashable] = None) -> int:
        """Drop entries (write-through invalidation on a local add).

        ``prefix=None`` clears everything; otherwise drops every tuple
        key whose FIRST element equals ``prefix`` (the serve client keys
        entries as ``(handle, ...)`` / the tables as ``(kind, ...)``).
        Returns the number dropped."""
        with self._lock:
            if prefix is None:
                n = len(self._entries)
                self._entries.clear()
                return n
            doomed = [k for k in self._entries
                      if isinstance(k, tuple) and k and k[0] == prefix]
            for k in doomed:
                del self._entries[k]
            return len(doomed)

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def stats(self) -> dict:
        return {
            "entries": len(self),
            "max_entries": self.max_entries,
            "hits": int(metrics.counter(f"{self._name}.cache.hit").value),
            "misses": int(metrics.counter(f"{self._name}.cache.miss").value),
            "evictions": int(
                metrics.counter(f"{self._name}.cache.evict").value),
        }
