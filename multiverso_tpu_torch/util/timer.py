"""Wall timer (reference ``util/timer.h``; SURVEY.md §2.25)."""

from __future__ import annotations

import time

__all__ = ["Timer"]


class Timer:
    """Accumulating stopwatch: Start/Stop/elapsed, restartable."""

    def __init__(self, start: bool = True):
        self._accum = 0.0
        self._since = time.perf_counter() if start else None

    def start(self) -> None:
        if self._since is None:
            self._since = time.perf_counter()

    def stop(self) -> float:
        if self._since is not None:
            self._accum += time.perf_counter() - self._since
            self._since = None
        return self._accum

    def reset(self) -> None:
        self._accum = 0.0
        self._since = None

    @property
    def elapsed(self) -> float:
        running = (time.perf_counter() - self._since
                   if self._since is not None else 0.0)
        return self._accum + running
