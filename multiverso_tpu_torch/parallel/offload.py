"""OffloadedState — double-buffered async host bridge for ZeRO-style
offload (docs/host_bridge.md).

A flat float32 state vector lives on a native array table under the
``assign`` updater (``-updater_type=assign``): ``push()`` overwrites the
remote copy with the caller's bits verbatim, ``wait()`` returns the bits
exactly as pushed — the bridge is a bit-exact remote store, which is
what lets an offloaded trainer's loss trajectory match the in-memory
baseline bit for bit (``make bridge-demo``).

The overlap protocol (per step ``i``)::

    state = off.wait()        # arena buffer filled by step i-1's prefetch
    new   = compute(state)    # device/host compute
    off.push(new)             # ASYNC assign-add: wire overlaps compute
    off.prefetch()            # async get into the OTHER buffer

All four buffers (two get destinations, two push stagings) come from
the runtime's :class:`~multiverso_tpu_torch.native.HostArena`, so pushes ship
zero-copy into the scatter-gather send path and gets land replies
straight into the buffer ``wait()`` hands back.  Correct reuse is
guaranteed by wire FIFO: a prefetch issued after a push completes only
after the push was applied (Get flushes and rides behind Adds on the
same connection), so by the time ``wait()`` returns, the previous
push's borrow has drained and its staging buffer is reusable.

``backend="local"`` swaps the native runtime for an in-process numpy
dict performing the IDENTICAL float32 arithmetic — the control arm of
the bit-exactness demo and a dependency-free fallback for tests.
"""

from __future__ import annotations

import time
from typing import Any, Optional

import numpy as np

from .. import metrics, tracing

__all__ = ["OffloadedState"]


class _LocalStore:
    """In-process stand-in for the native assign table: the same
    float32 store semantics with zero wire — the demo's control arm."""

    def __init__(self, size: int):
        self._data = np.zeros(size, np.float32)

    def assign(self, vec: np.ndarray) -> None:
        self._data[:] = vec

    def fetch(self, out: np.ndarray) -> np.ndarray:
        np.copyto(out, self._data)
        return out


class OffloadedState:
    """Double-buffered bridge to a remote (or local) flat f32 store.

    ``rt``: a :class:`~multiverso_tpu_torch.native.NativeRuntime` whose fleet
    runs ``-updater_type=assign`` (the bridge asserts this on the first
    roundtrip by construction: a non-assign updater would fail the
    read-back check in ``init()``).  ``backend="local"`` needs no
    runtime at all.
    """

    def __init__(self, rt: Optional[Any], size: int, *,
                 backend: str = "native"):
        self.size = int(size)
        self.backend = backend
        self._pending = None          # in-flight AsyncGet (or None)
        self._step = 0
        if backend == "local":
            self._store = _LocalStore(self.size)
            self._get_bufs = [np.zeros(self.size, np.float32)
                              for _ in range(2)]
            self._push_bufs = [np.zeros(self.size, np.float32)
                               for _ in range(2)]
            self._rt = None
            self._arena = None
            self.handle = -1
        elif backend == "native":
            if rt is None:
                raise ValueError("backend='native' needs a NativeRuntime")
            self._rt = rt
            self._arena = rt.arena()
            self.handle = rt.new_array_table(self.size)
            self._get_bufs = [self._arena.alloc(self.size)
                              for _ in range(2)]
            self._push_bufs = [self._arena.alloc(self.size)
                               for _ in range(2)]
        else:
            raise ValueError(f"unknown backend '{backend}'")
        self._get_slot = 0

    # ------------------------------------------------------------ seeding
    def init(self, vec) -> None:
        """Blocking seed: store ``vec`` and verify the read-back is
        bit-identical — which also fails fast when the runtime's
        updater is not ``assign`` (an accumulate would double on the
        probe)."""
        v = np.ascontiguousarray(vec, np.float32).ravel()
        if v.size != self.size:
            raise ValueError(f"init vector has {v.size} elements, "
                             f"expected {self.size}")
        if self._pending is not None:
            self.wait()  # drain a pre-init prefetch: it predates `vec`
        self.push(v, blocking=True)
        self.push(v, blocking=True)  # idempotence probe: assign, not add
        got = self.wait()
        if got.tobytes() != v.tobytes():
            raise RuntimeError(
                "offload store round-trip is not bit-exact — is the "
                "native fleet running -updater_type=assign? "
                "(docs/host_bridge.md)")

    # ------------------------------------------------------------- bridge
    def push(self, vec, blocking: bool = False) -> None:
        """Ship ``vec`` (any f32 array-like of the right size) to the
        store.  Async by default: the copy into the arena staging
        buffer is the only host work; the wire rides behind the
        caller's next compute."""
        with tracing.span("bridge::push", n=self.size):
            staging = self._push_bufs[self._step % 2]
            self._step += 1
            src = np.asarray(vec, np.float32).reshape(-1)
            if src.size != self.size:
                raise ValueError(f"push vector has {src.size} elements, "
                                 f"expected {self.size}")
            np.copyto(staging, src)
            t0 = time.perf_counter()
            if self.backend == "local":
                self._store.assign(staging)
            else:
                self._rt.array_add(self.handle, staging, sync=blocking,
                                   borrowed=True)
            metrics.counter("bridge.push").inc()
            metrics.histogram("bridge.push_s").observe(
                time.perf_counter() - t0)

    def prefetch(self) -> None:
        """Start the async get for the NEXT ``wait()`` into the idle
        buffer.  FIFO on the table's connection orders it behind every
        push issued before it."""
        if self._pending is not None:
            return  # one outstanding prefetch at a time
        if self.backend == "local":
            self._pending = "local"
            return
        buf = self._get_bufs[self._get_slot]
        self._pending = self._rt.array_get_async(
            self.handle, self.size, out=buf, arena=self._arena)

    def wait(self) -> np.ndarray:
        """The current state vector — from the outstanding prefetch
        when one is in flight, else via a blocking fetch.  The returned
        array is the bridge's OWN buffer: treat it read-only and
        consume it before the next ``wait()`` reuses the slot."""
        with tracing.span("bridge::wait", n=self.size):
            t0 = time.perf_counter()
            buf = self._get_bufs[self._get_slot]
            if self.backend == "local":
                self._store.fetch(buf)
                self._pending = None
            elif self._pending is not None:
                got = self._pending.wait()
                self._pending = None
                # The reply landed in OUR buffer (out=buf) — same bytes,
                # possibly a distinct view object.
                assert (got.__array_interface__["data"][0]
                        == buf.__array_interface__["data"][0])
            else:
                self._rt.array_get(self.handle, self.size, out=buf)
            self._get_slot ^= 1  # next prefetch targets the other buffer
            metrics.histogram("bridge.wait_s").observe(
                time.perf_counter() - t0)
            return buf

    # ------------------------------------------------------------- admin
    def close(self) -> None:
        """Drop the in-flight prefetch (withdrawing its ticket) and
        release the arena buffers back to the pool."""
        if self._pending is not None and self.backend == "native":
            pending, self._pending = self._pending, None
            del pending  # __del__ cancels the ticket + frees the hold
        if self._arena is not None:
            for b in self._get_bufs + self._push_bufs:
                try:
                    self._arena.release(b)
                except Exception:
                    pass  # already released / interpreter teardown
            self._get_bufs = []
            self._push_bufs = []
