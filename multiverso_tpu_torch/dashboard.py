"""Dashboard: named timing monitors — now a shim over the metrics
registry (docs/observability.md).

Parity with the reference's ``dashboard.h`` / ``src/dashboard.cpp``
(``Dashboard``, ``Monitor``, ``MONITOR(...)`` macro; SURVEY.md §2.26):
named accumulating timers around hot paths, aggregated and dumped at
shutdown through the logger.  The ``monitor()`` / ``get_monitor()`` /
``report()`` surface is unchanged, but every monitor is now backed by a
:class:`multiverso_tpu.metrics.Histogram` (fixed log2 latency buckets),
so ``report()`` prints p50/p95/p99 and ``metrics.snapshot()`` exposes
every monitor alongside the counters/gauges of the rest of the system.

When tracing is armed (``-trace_dir`` / ``tracing.enable()``), each
monitored section also records a span into ``multiverso_tpu.tracing``
— table ops, barriers, and jitted steps show up on the merged timeline
without new call sites.  Under a ``torch.profiler`` capture each section
shows up in the capture too, on the profiler's clock (``tracing``'s "Two
clocks").

A port of ``multiverso_tpu/dashboard.py``: ``torch.profiler`` trace
capture (CPU and, where a card is present, CUDA activity) takes the place
of ``jax.profiler`` for a deeper look (SURVEY.md §5 "Tracing/profiling").
A monitor around work that runs on the card times only the host side
unless the caller synchronises inside it.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Dict, Iterator

from . import metrics, tracing
from .log import Log

__all__ = ["Monitor", "monitor", "get_monitor", "report", "reset",
           "start_trace", "stop_trace"]


class Monitor:
    """Accumulating named timer over a registry histogram.

    Keeps the legacy surface (``count`` / ``total_s`` / ``max_s`` /
    ``mean_ms``) and adds bucket percentiles (``p50_ms`` ...).
    """

    def __init__(self, name: str):
        self.name = name
        self._hist = metrics.histogram(name)

    def begin(self) -> float:
        return time.perf_counter()

    def end(self, t0: float) -> None:
        dt = time.perf_counter() - t0
        self._hist.observe(dt)
        if tracing.enabled():
            tracing.record_span(self.name,
                                int((time.time() - dt) * 1e6),
                                int(dt * 1e6),
                                trace_id=tracing.current_trace_id()
                                or tracing.new_trace_id())

    @property
    def count(self) -> int:
        return self._hist.count

    @property
    def total_s(self) -> float:
        return self._hist.sum

    @property
    def max_s(self) -> float:
        return self._hist.max

    @property
    def mean_ms(self) -> float:
        return self._hist.mean * 1e3

    def quantile_ms(self, q: float) -> float:
        return self._hist.quantile(q) * 1e3

    @property
    def p50_ms(self) -> float:
        return self.quantile_ms(0.50)

    @property
    def p95_ms(self) -> float:
        return self.quantile_ms(0.95)

    @property
    def p99_ms(self) -> float:
        return self.quantile_ms(0.99)

    def __str__(self) -> str:
        return (f"{self.name}: count={self.count} total={self.total_s:.3f}s "
                f"mean={self.mean_ms:.3f}ms p50={self.p50_ms:.3f}ms "
                f"p95={self.p95_ms:.3f}ms p99={self.p99_ms:.3f}ms "
                f"max={self.max_s * 1e3:.3f}ms")


_LOCK = threading.Lock()
_MONITORS: Dict[str, Monitor] = {}


def get_monitor(name: str) -> Monitor:
    with _LOCK:
        m = _MONITORS.get(name)
        if m is None:
            m = _MONITORS[name] = Monitor(name)
        return m


@contextmanager
def monitor(name: str) -> Iterator[Monitor]:
    """``with dashboard.monitor("Worker::Get"):`` — the MONITOR macro.

    The section runs under ``tracing.span(name)``: with tracing armed
    nested monitors (and native calls the caller stamps via
    ``NativeRuntime.set_trace_id``) share its trace id, and under a
    ``torch.profiler`` capture the section shows up in it.
    """
    m = get_monitor(name)
    with tracing.span(name):
        t0 = time.perf_counter()
        try:
            yield m
        finally:
            m._hist.observe(time.perf_counter() - t0)


def report(log: bool = True) -> Dict[str, Monitor]:
    """Aggregate table; dumped at shutdown like the reference Dashboard
    (now with percentiles)."""
    with _LOCK:
        monitors = dict(_MONITORS)
    if log and monitors:
        Log.info("---------------- Dashboard ----------------")
        for name in sorted(monitors):
            Log.info("  %s", monitors[name])
        Log.info("--------------------------------------------")
    return monitors


def reset() -> None:
    with _LOCK:
        for name in _MONITORS:
            metrics.REGISTRY.remove(name)
        _MONITORS.clear()


_profiler = None


def start_trace(log_dir: str) -> None:
    """Start a ``torch.profiler`` capture that writes a Chrome trace
    into ``log_dir`` when :func:`stop_trace` ends it."""
    global _profiler
    import torch

    if _profiler is None:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        _profiler = torch.profiler.profile(
            activities=acts,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir))
        _profiler.start()


def stop_trace() -> None:
    global _profiler
    if _profiler is not None:
        prof, _profiler = _profiler, None
        prof.stop()
