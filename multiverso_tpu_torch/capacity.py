"""Python-plane capacity gauges — the host-side mirror of the native
``mvtpu/capacity.h`` registry (docs/observability.md, "capacity plane").

The native registry covers what the native runtime holds (table shards,
arena, write queues); everything the PYTHON serve plane holds — the
versioned serve caches, coalescer windows, hedge trackers — registers a
byte gauge HERE.  Gauges export into the unified metrics registry as
``capacity.<name>`` Gauge series, so they ride the same flush /
``/metrics`` scrape (and the pushed host-metrics superset) every other
series does, and ``snapshot()`` answers ad-hoc "who holds bytes right
now" questions without a scrape.

mvlint MV018 enforces the contract: a bounded cache/queue/ring added to
the serve plane without a registered capacity gauge is a lint error —
growth anybody can SEE is the precondition for placement anybody can
PLAN (tools/mvplan.py).
"""

from __future__ import annotations

import sys
import threading
from typing import Callable, Dict

from . import metrics
from .log import Log

__all__ = ["register_gauge", "unregister_gauge", "snapshot",
           "export_gauges", "container_bytes"]

_LOCK = threading.Lock()
_GAUGES: Dict[str, Callable[[], int]] = {}


def register_gauge(name: str, fn: Callable[[], int]) -> None:
    """Register (or re-register — latest wins) a byte gauge.  ``fn``
    returns the subsystem's CURRENT resident bytes; it runs at snapshot
    time and must be cheap and lock-light."""
    with _LOCK:
        _GAUGES[name] = fn


def unregister_gauge(name: str) -> None:
    with _LOCK:
        _GAUGES.pop(name, None)


def snapshot(export: bool = True) -> Dict[str, int]:
    """``{name: bytes}`` over every registered gauge.  A gauge whose
    callback raises reports -1 (a dead subsystem must not kill the
    scrape) and logs once per call.  ``export=True`` (default) also
    lands each value in the metrics registry as ``capacity.<name>``."""
    with _LOCK:
        gauges = dict(_GAUGES)
    out: Dict[str, int] = {}
    for name, fn in gauges.items():
        try:
            out[name] = int(fn())
        except Exception as exc:
            Log.error("capacity: gauge %s failed: %s", name, exc)
            out[name] = -1
    if export:
        for name, v in out.items():
            metrics.gauge(f"capacity.{name}").set(v)
    return out


def export_gauges() -> None:
    """Flush-thread hook: push every gauge into the metrics registry
    (one ``capacity.<name>`` Gauge per registered gauge)."""
    snapshot(export=True)


def container_bytes(container) -> int:
    """Best-effort resident bytes of a dict/deque of cached values:
    ``nbytes`` for array-protocol values, ``len`` for bytes-likes,
    ``sys.getsizeof`` otherwise, plus a flat per-entry overhead that
    matches the native ``kKVEntryOverhead`` so both planes speak one
    unit."""
    overhead = 64  # native capacity::kKVEntryOverhead
    total = 0
    try:
        values = container.values()
    except AttributeError:
        values = container
    for v in list(values):
        if isinstance(v, tuple):  # (value, version) cache entries
            v = v[0]
        nbytes = getattr(v, "nbytes", None)
        if nbytes is not None:
            total += int(nbytes)
        elif isinstance(v, (bytes, bytearray, memoryview)):
            total += len(v)
        else:
            total += int(sys.getsizeof(v))
        total += overhead
    return total
