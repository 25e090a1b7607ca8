"""Workload sketches — the Python mirror of ``mvtpu/sketch.h``
(docs/observability.md, "workload plane").

Bounded-memory hot-key accounting for skewed sparse-table access:

- :class:`SpaceSavingSketch` (Metwally et al. 2005): top-K heavy
  hitters in K counters.  An unmonitored key evicts the minimum counter
  and inherits its count as ``error``; every key with true frequency
  > total/K is guaranteed monitored and
  ``count - error <= true <= count``.
- :class:`CountMinSketch` (Cormode & Muthukrishnan 2005): depth×width
  counters, per-row hashes, estimate = min over rows.  Never
  underestimates; overestimates by at most ``eps * total`` with
  probability 1-delta for ``width = e/eps``, ``depth = ln(1/delta)``.
- :class:`WorkloadTracker` combines both per table, reporting the same
  JSON shape the native ``"hotkeys"`` OpsQuery kind serves — so the
  pure-JAX plane and the native server plane read identically in mvtop.

Hashing is FNV-1a 64 (``key_hash``), byte-identical with the native
``workload::KeyHash`` / ``KVHash``, so per-rank sketches ``merge()``
coherently across planes (fleet scope folds per-rank top-Ks and
count-min grids cell-by-cell).
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Iterable, List, Optional, Tuple

__all__ = ["key_hash", "SpaceSavingSketch", "CountMinSketch",
           "WorkloadTracker"]

_FNV_OFFSET = 1469598103934665603
_FNV_PRIME = 1099511628211
_MASK64 = (1 << 64) - 1


def key_hash(key: Any) -> int:
    """Stable 64-bit FNV-1a of a key (str/bytes hash their bytes; ints
    hash their little-endian int64 form, matching the native
    ``KeyHash(int64_t)``).  NOT Python ``hash()`` — PYTHONHASHSEED
    randomizes that per process, which would break cross-rank merges."""
    if isinstance(key, bytes):
        data = key
    elif isinstance(key, str):
        data = key.encode()
    else:
        data = int(key).to_bytes(8, "little", signed=True)
    h = _FNV_OFFSET
    for b in data:
        h = ((h ^ b) * _FNV_PRIME) & _MASK64
    return h


def _splitmix(row: int, h: int) -> int:
    """Per-row hash family: splitmix64 finalize of ``h ^ row-salt``
    (identical to the native ``CountMin::RowHash``)."""
    x = (h ^ ((0x9E3779B97F4A7C15 * (row + 1)) & _MASK64)) & _MASK64
    x ^= x >> 30
    x = (x * 0xBF58476D1CE4E5B9) & _MASK64
    x ^= x >> 27
    x = (x * 0x94D049BB133111EB) & _MASK64
    x ^= x >> 31
    return x


class SpaceSavingSketch:
    """Top-K heavy hitters in K counters (not thread-safe; the owning
    :class:`WorkloadTracker` serializes access)."""

    def __init__(self, k: int = 16):
        self.k = max(1, int(k))
        self.total = 0
        # hash -> [label, count, error]
        self._entries: Dict[int, List[Any]] = {}

    def offer(self, key: Any, n: int = 1,
              _hash: Optional[int] = None) -> None:
        h = key_hash(key) if _hash is None else _hash
        self.total += n
        e = self._entries.get(h)
        if e is not None:
            e[1] += n
            return
        if len(self._entries) < self.k:
            self._entries[h] = [str(key), n, 0]
            return
        # Evict the minimum counter; the newcomer inherits its count as
        # `error` — the space-saving guarantee.
        min_h = min(self._entries, key=lambda x: self._entries[x][1])
        _, min_count, _ = self._entries.pop(min_h)
        self._entries[h] = [str(key), min_count + n, min_count]

    def topk(self) -> List[Tuple[str, int, int]]:
        """``[(label, count, error)]`` descending by count."""
        return sorted(((label, count, err)
                       for label, count, err in self._entries.values()),
                      key=lambda t: -t[1])

    def merge(self, other: "SpaceSavingSketch") -> None:
        """Fold another rank's sketch in (errors add conservatively)."""
        for h, (label, count, err) in list(other._entries.items()):
            e = self._entries.get(h)
            if e is not None:
                e[1] += count
                e[2] += err
                self.total += count
                continue
            self.offer(label, count, _hash=h)
            if h in self._entries:
                self._entries[h][2] += err


class CountMinSketch:
    """Depth×width counter grid; ``estimate()`` = min over rows."""

    def __init__(self, width: int = 1024, depth: int = 4):
        self.width = max(8, int(width))
        self.depth = max(1, int(depth))
        self.total = 0
        self._cells = [[0] * self.width for _ in range(self.depth)]

    def add(self, key: Any, n: int = 1,
            _hash: Optional[int] = None) -> None:
        h = key_hash(key) if _hash is None else _hash
        for r in range(self.depth):
            self._cells[r][_splitmix(r, h) % self.width] += n
        self.total += n

    def estimate(self, key: Any = None,
                 _hash: Optional[int] = None) -> int:
        h = key_hash(key) if _hash is None else _hash
        return min(self._cells[r][_splitmix(r, h) % self.width]
                   for r in range(self.depth))

    def merge(self, other: "CountMinSketch") -> None:
        if (other.width, other.depth) != (self.width, self.depth):
            raise ValueError(
                f"count-min shape mismatch: {self.width}x{self.depth} vs "
                f"{other.width}x{other.depth}")
        for r in range(self.depth):
            mine, theirs = self._cells[r], other._cells[r]
            for c in range(self.width):
                mine[c] += theirs[c]
        self.total += other.total


class WorkloadTracker:
    """Per-table tracker: one space-saving top-K + one count-min +
    per-bucket get/add load counters — the JAX-plane twin of the native
    ``ServerTable`` workload accounting, reporting the same shape as
    the ``"hotkeys"`` OpsQuery kind."""

    def __init__(self, topk: int = 16, buckets: int = 64):
        self._lock = threading.Lock()
        self.buckets = int(buckets)
        self._ss = SpaceSavingSketch(topk)
        self._cm = CountMinSketch()
        self._bucket_gets = [0] * self.buckets
        self._bucket_adds = [0] * self.buckets
        self.gets = 0
        self.adds = 0

    def note_get(self, keys: Optional[Iterable[Any]] = None) -> None:
        self._note(keys, is_add=False)

    def note_add(self, keys: Optional[Iterable[Any]] = None) -> None:
        self._note(keys, is_add=True)

    def _note(self, keys: Optional[Iterable[Any]], is_add: bool) -> None:
        with self._lock:
            if is_add:
                self.adds += 1
            else:
                self.gets += 1
            if keys is None:        # whole-table op: totals only
                return
            loads = self._bucket_adds if is_add else self._bucket_gets
            for key in keys:
                h = key_hash(key)
                self._ss.offer(key, _hash=h)
                self._cm.add(key, _hash=h)
                loads[h % self.buckets] += 1

    def estimate(self, key: Any) -> int:
        with self._lock:
            return self._cm.estimate(key)

    def merge(self, other: "WorkloadTracker") -> None:
        """Fold another rank's tracker (the fleet-scope reduction)."""
        with self._lock, other._lock:
            self._ss.merge(other._ss)
            self._cm.merge(other._cm)
            for b in range(min(self.buckets, other.buckets)):
                self._bucket_gets[b] += other._bucket_gets[b]
                self._bucket_adds[b] += other._bucket_adds[b]
            self.gets += other.gets
            self.adds += other.adds

    def report(self) -> Dict[str, Any]:
        """Same shape as one native ``"hotkeys"`` report entry."""
        with self._lock:
            loads = [g + a for g, a in zip(self._bucket_gets,
                                           self._bucket_adds)]
            mean = sum(loads) / float(self.buckets)
            # Estimate by the STORED hash, not the label string — the
            # key was offered as its raw form (int row ids hash their
            # int64 bytes, matching the native plane), and re-hashing
            # the stringified label would land in different cells.
            top = sorted(
                ({"key": label, "count": count, "error": err,
                  "estimate": self._cm.estimate(_hash=h)}
                 for h, (label, count, err) in self._ss._entries.items()),
                key=lambda e: -e["count"])
            return {
                "gets": self.gets,
                "adds": self.adds,
                "skew_ratio": (max(loads) / mean) if mean > 0 else 0.0,
                "bucket_load_max": max(loads) if loads else 0,
                "bucket_load_mean": mean,
                "hotkeys": {"total": self._cm.total, "topk": top},
            }
