"""Request coalescer — the batching side of the serve layer
(docs/serving.md).

Merges concurrent (and window-adjacent) requests against the same
logical target into ONE execution, PS-Lite-style: the first caller to
open a batch becomes its LEADER, waits out ``-coalesce_window_us`` (so
near-simultaneous callers can pile on), seals the batch, runs the
merged operation once, and fans the per-item results back to every
waiter.  A size cap seals early so a hot key cannot grow an unbounded
batch (mvlint MV007).

The merge semantics live entirely in the caller's ``execute`` function
— ``execute(items) -> results`` receives every queued item (in arrival
order) and returns one result per item — so the same engine serves:

- identical whole-table gets   (broadcast one fetch to N waiters),
- row-range gets               (union the ids, scatter the rows),
- adds                         (sum the deltas, push once, ack all).

Observability: each sealed batch records its size in the
``serve.coalesce.batch`` histogram and runs under a
``serve::coalesced`` span whose ``n`` arg shows N logical ops
collapsing into one execution.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Hashable, List

from .. import metrics, tracing

__all__ = ["Coalescer"]


class _Batch:
    __slots__ = ("items", "done", "full", "results", "error", "sealed")

    def __init__(self) -> None:
        self.items: List[Any] = []
        self.done = threading.Event()
        self.full = threading.Event()   # size cap hit — leader wakes early
        self.results: List[Any] = []
        self.error: BaseException | None = None
        self.sealed = False


class Coalescer:
    """Leader/follower batcher over keyed windows.

    One instance guards any number of keys (one open batch per key).
    ``submit`` blocks until the batch containing the caller's item
    executed and returns the caller's own result; an ``execute`` failure
    propagates to EVERY waiter of that batch (each may retry, landing in
    a fresh batch).
    """

    def __init__(self, window_s: float = 200e-6, max_batch: int = 64):
        self.window_s = max(0.0, float(window_s))
        self.max_batch = max(1, int(max_batch))
        self._lock = threading.Lock()
        # At most one OPEN batch per key; sealed batches leave the dict
        # before executing, so this cannot grow past the live key set.
        self._open: dict = {}  # mvlint: MV007-exempt(one entry per in-flight key, removed on seal)

    def submit(self, key: Hashable, item: Any,
               execute: Callable[[List[Any]], List[Any]]) -> Any:
        """Queue ``item`` under ``key``; return its result.

        The leader (batch opener) sleeps the window, seals, and calls
        ``execute(items)`` ONCE; followers just wait.  ``execute`` must
        return one result per item, in item order.
        """
        with self._lock:
            batch = self._open.get(key)
            if batch is not None and not batch.sealed:
                leader = False
                batch.items.append(item)
                slot = len(batch.items) - 1
                if len(batch.items) >= self.max_batch:
                    # Size cap: seal now and wake the leader out of the
                    # remainder of its window.
                    batch.sealed = True
                    self._open.pop(key, None)
                    batch.full.set()
            else:
                leader = True
                batch = _Batch()
                batch.items.append(item)
                slot = 0
                self._open[key] = batch
        if leader:
            if self.window_s > 0:
                # Let adjacent callers pile on; a full batch ends the
                # window early.
                batch.full.wait(self.window_s)
            with self._lock:
                if not batch.sealed:
                    batch.sealed = True
                    self._open.pop(key, None)
                items = list(batch.items)
            metrics.histogram("serve.coalesce.batch").observe(
                float(len(items)))
            try:
                with tracing.span("serve::coalesced", n=len(items),
                                  key=str(key)):
                    results = execute(items)
                if len(results) != len(items):
                    raise RuntimeError(
                        f"coalesced execute returned {len(results)} "
                        f"results for {len(items)} items")
                batch.results = list(results)
            except BaseException as exc:  # fan the failure to all waiters
                batch.error = exc
            finally:
                batch.done.set()
        else:
            batch.done.wait()
        if batch.error is not None:
            raise batch.error
        return batch.results[slot]
