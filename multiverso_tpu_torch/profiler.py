"""Always-on sampling profiler — the Python half
(docs/observability.md "latency plane").

Two samplers, one output shape:

- :class:`SamplingProfiler` — a daemon thread that samples EVERY Python
  thread's stack via ``sys._current_frames()`` at a fixed rate (no
  ``sys.setprofile``: tracing hooks tax every function call everywhere;
  a sampler taxes nothing between samples, which is what makes
  always-on viable).  Aggregates folded stacks
  (``outer;...;leaf count``).
- :func:`add_native_profile` — folds the NATIVE SIGPROF sampler's dump
  (``NativeRuntime.profiler_dump()``, same folded convention) in.

Both land in the Chrome trace via :func:`profile_to_spans`: each
distinct stack becomes one synthetic span whose duration is
``samples x period`` on a dedicated ``profile`` lane, so flame data
sits beside the request spans in ``trace_rank<r>.json`` and survives
``tracing.merge_dir`` like any other event.  Armed at ``init()`` by the
``-profile_hz`` flag; the overhead bar (``bench_latency``'s
``profiler_overhead_pct < 1``) is measured, not assumed.
"""

from __future__ import annotations

import sys
import threading
import time
from collections import Counter
from typing import Any, Dict, Optional

from . import tracing
from .log import Log

__all__ = ["SamplingProfiler", "parse_folded", "add_native_profile",
           "profile_to_spans", "start", "stop", "active"]

# Synthetic-span lane: keeps flame rows visually apart from real spans
# in Perfetto (tid is only a lane label in the Chrome trace format).
PROFILE_TID = 0xFADE


class SamplingProfiler:
    """Sampler thread over ``sys._current_frames()``.

    ``hz`` bounds the sampling cost: each tick walks every live
    thread's stack once (a few µs per thread) and bumps one Counter
    entry — there is no per-call hook anywhere.  The sampler SKIPS its
    own thread (it would otherwise be the hottest stack in an idle
    process)."""

    def __init__(self, hz: int = 97, max_depth: int = 48):
        self.period_s = 1.0 / max(1, int(hz))
        self.hz = max(1, int(hz))
        self.max_depth = int(max_depth)
        self._folded: Counter = Counter()
        self._samples = 0
        self._lock = threading.Lock()
        self._stop_evt = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------ control
    def start(self) -> "SamplingProfiler":
        if self._thread is not None:
            return self
        self._stop_evt.clear()
        self._thread = threading.Thread(target=self._run,
                                        name="mvtpu-profiler",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        t, self._thread = self._thread, None
        if t is None:
            return
        self._stop_evt.set()
        t.join(timeout=5.0)
        if t.is_alive():
            Log.error("profiler: sampler thread did not stop within 5s")

    @property
    def running(self) -> bool:
        return self._thread is not None

    # ----------------------------------------------------------- sampling
    def _run(self) -> None:
        me = threading.get_ident()
        while not self._stop_evt.wait(self.period_s):
            try:
                frames = sys._current_frames()
            except Exception:  # interpreter shutting down
                return
            with self._lock:
                for tid, frame in frames.items():
                    if tid == me:
                        continue
                    stack = []
                    depth = 0
                    while frame is not None and depth < self.max_depth:
                        code = frame.f_code
                        stack.append(f"{code.co_name} "
                                     f"({code.co_filename.rsplit('/', 1)[-1]}"
                                     f":{frame.f_lineno})")
                        frame = frame.f_back
                        depth += 1
                    # Innermost-first walk -> outermost-first folded key.
                    self._folded[";".join(reversed(stack))] += 1
                    self._samples += 1

    # ------------------------------------------------------------ results
    @property
    def samples(self) -> int:
        with self._lock:
            return self._samples

    def folded(self) -> Dict[str, int]:
        """``{"outer;...;leaf": samples}`` — the flamegraph folded
        shape, identical to the native ``MV_ProfilerDump`` lines."""
        with self._lock:
            return dict(self._folded)

    def clear(self) -> None:
        with self._lock:
            self._folded.clear()
            self._samples = 0


def parse_folded(text: str) -> Dict[str, int]:
    """Parse folded-stack lines (``stack count``) into a dict — the
    native ``MV_ProfilerDump`` wire shape."""
    out: Dict[str, int] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        stack, _, count = line.rpartition(" ")
        if not stack:
            continue
        try:
            out[stack] = out.get(stack, 0) + int(count)
        except ValueError:
            continue
    return out


def profile_to_spans(folded: Dict[str, int], period_s: float,
                     plane: str = "python") -> int:
    """Land flame data in the trace buffer beside the spans: each
    distinct stack becomes one synthetic ``profile:<leaf>`` span whose
    duration is ``samples x period`` (the CPU time it represents), on
    the dedicated profile lane.  Returns the span count recorded (0
    when tracing is disarmed — same contract as every span source)."""
    if not tracing.enabled():
        return 0
    ts_us = int(time.time() * 1e6)
    n = 0
    for stack, count in sorted(folded.items(),
                               key=lambda kv: -kv[1]):
        leaf = stack.rsplit(";", 1)[-1]
        tracing.record_span(
            f"profile:{leaf}", ts_us,
            int(count * period_s * 1e6), trace_id=0,
            args={"stack": stack, "samples": count,
                  "plane": f"profiler/{plane}"})
        n += 1
    return n


def add_native_profile(runtime: Any, hz: int = 97) -> int:
    """Fold the native SIGPROF sampler's dump into the trace buffer
    (``profile:*`` spans, ``plane=profiler/native``).  ``hz`` must
    match the rate the sampler ran at — it scales samples back into
    CPU time.  Returns the span count."""
    folded = parse_folded(runtime.profiler_dump())
    return profile_to_spans(folded, 1.0 / max(1, hz), plane="native")


# ---------------------------------------------------------------------------
# Module-level singleton, armed by init() via the -profile_hz flag.
# ---------------------------------------------------------------------------

_LOCK = threading.Lock()
_ACTIVE: Optional[SamplingProfiler] = None


def start(hz: int = 97) -> SamplingProfiler:
    """Start (or return) the process-wide sampler at ``hz``."""
    global _ACTIVE
    with _LOCK:
        if _ACTIVE is None:
            _ACTIVE = SamplingProfiler(hz=hz).start()
        return _ACTIVE


def stop(to_trace: bool = True) -> Optional[SamplingProfiler]:
    """Stop the process-wide sampler; with ``to_trace`` (default) its
    folded stacks land in the trace buffer first, so the shutdown
    trace export carries the flame data."""
    global _ACTIVE
    with _LOCK:
        p, _ACTIVE = _ACTIVE, None
    if p is None:
        return None
    p.stop()
    if to_trace:
        profile_to_spans(p.folded(), p.period_s)
    return p


def active() -> Optional[SamplingProfiler]:
    return _ACTIVE
