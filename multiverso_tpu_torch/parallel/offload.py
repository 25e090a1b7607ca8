"""OffloadedState — the double-buffered bridge of a trainer's state to a
flat float32 store (ZeRO-style offload), the port of
``multiverso_tpu/parallel/offload.py``.

The store keeps the caller's bits verbatim (an ``assign`` table): what
``push()`` writes, ``wait()`` returns exactly, which is what lets an
offloaded trainer's run match the in-memory one bit for bit.

The overlap protocol (per step ``i``)::

    state = off.wait()        # buffer filled by step i-1's prefetch
    new   = compute(state)    # device compute
    off.push(new)             # ship the new state
    off.prefetch()            # get into the OTHER buffer

``backend="local"`` is an in-process numpy store doing the same float32
arithmetic as the JAX package's local arm (its bit-exactness demo's
control arm).  ``backend="native"``, the native runtime's array table
behind the host bridge, needs the ctypes binding, which the port does
not have yet: it raises ``NotImplementedError`` (ROADMAP.md Queue 1,
"Modules that need the native runtime").
"""

from __future__ import annotations

import time
from typing import Any, Optional

import numpy as np

from .. import metrics, tracing

__all__ = ["OffloadedState"]


class _LocalStore:
    """In-process stand-in for the native assign table: the same
    float32 store semantics with zero wire."""

    def __init__(self, size: int):
        self._data = np.zeros(size, np.float32)

    def assign(self, vec: np.ndarray) -> None:
        self._data[:] = vec

    def fetch(self, out: np.ndarray) -> np.ndarray:
        np.copyto(out, self._data)
        return out


class OffloadedState:
    """Double-buffered bridge to a flat float32 store of ``size``
    elements.

    ``rt`` is the native runtime of ``backend="native"`` (not ported:
    that backend raises); ``backend="local"`` needs none.  Two get
    buffers alternate, so the vector ``wait()`` hands out stays intact
    while the next prefetch lands in the other one; two push staging
    buffers alternate likewise.
    """

    def __init__(self, rt: Optional[Any], size: int, *,
                 backend: str = "native"):
        self.size = int(size)
        self.backend = backend
        self._pending = None          # the outstanding prefetch, or None
        self._step = 0
        if backend == "local":
            self._store = _LocalStore(self.size)
            self._get_bufs = [np.zeros(self.size, np.float32)
                              for _ in range(2)]
            self._push_bufs = [np.zeros(self.size, np.float32)
                               for _ in range(2)]
        elif backend == "native":
            raise NotImplementedError(
                "OffloadedState(backend='native') needs the native "
                "runtime's ctypes binding, which is not ported yet "
                "(ROADMAP.md Queue 1, \"Modules that need the native "
                "runtime\"); use backend='local'")
        else:
            raise ValueError(f"unknown backend '{backend}'")
        self._get_slot = 0

    # ------------------------------------------------------------ seeding
    def init(self, vec) -> None:
        """Blocking seed: store ``vec`` and verify the read-back is
        bit-identical, twice over — a store that accumulates instead of
        assigning would double on the probe."""
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
                "offload store round-trip is not bit-exact — the store "
                "must assign, not accumulate")

    # ------------------------------------------------------------- bridge
    def push(self, vec, blocking: bool = False) -> None:
        """Ship ``vec`` (any float32 array-like of the right size) to the
        store through the next staging buffer."""
        with tracing.span("bridge::push", n=self.size):
            staging = self._push_bufs[self._step % 2]
            self._step += 1
            src = np.asarray(vec, np.float32).reshape(-1)
            if src.size != self.size:
                raise ValueError(f"push vector has {src.size} elements, "
                                 f"expected {self.size}")
            np.copyto(staging, src)
            t0 = time.perf_counter()
            self._store.assign(staging)
            metrics.counter("bridge.push").inc()
            metrics.histogram("bridge.push_s").observe(
                time.perf_counter() - t0)

    def prefetch(self) -> None:
        """Start the get for the next ``wait()`` (one outstanding at a
        time); it lands behind every push issued before it."""
        if self._pending is None:
            self._pending = "local"

    def wait(self) -> np.ndarray:
        """The current state vector, in the bridge's OWN buffer: treat it
        as read-only and consume it before the next ``wait()`` reuses the
        slot."""
        with tracing.span("bridge::wait", n=self.size):
            t0 = time.perf_counter()
            buf = self._get_bufs[self._get_slot]
            self._store.fetch(buf)
            self._pending = None
            self._get_slot ^= 1  # next prefetch targets the other buffer
            metrics.histogram("bridge.wait_s").observe(
                time.perf_counter() - t0)
            return buf

    # ------------------------------------------------------------- admin
    def close(self) -> None:
        """Drop the outstanding prefetch and the buffers."""
        self._pending = None
        self._get_bufs = []
        self._push_bufs = []
