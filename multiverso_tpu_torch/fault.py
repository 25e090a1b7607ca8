"""Fault injection + retry/backoff — the Python half of the resilience
layer (docs/fault_tolerance.md; the native half is ``mvtpu/fault.h``).

Two pieces:

- :class:`RetryPolicy` — a reusable bounded-retry schedule
  (attempts / exponential backoff / jitter / deadline) for transient
  failures.  ``checkpoint.py`` wears it on every stream read/write; any
  caller can ``RetryPolicy(...).run(fn)``.
- The **fault injector** — a process-global seam the chaos suite
  (``tests/test_fault.py``) uses to script failures at named sites:
  ``io.read`` / ``io.write`` (Streams), ``table.<Op>`` (every eager
  table op), ``barrier`` (``context.host_sync``), and the serve layer
  (docs/serving.md): ``serve.busy`` fires inside the wire fetch
  (configure it with ``error=native.BusyError`` to script shed storms
  the RetryPolicy must absorb) and ``serve.stale`` fires at the
  cache-hit decision, forcing that read to miss.  Disabled (the
  default) :func:`inject` is a single bool check — zero behavior
  change, zero counters.  Deterministic under :func:`configure`'s seed
  (env: ``MVTPU_FAULT_SEED``).

Every injected event counts a metrics-registry counter
``fault.<site>``; every retry counts ``retry.attempts`` — the
observable ledger the acceptance tests (and ``metrics.snapshot()``)
read.
"""

from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple, Type

from . import metrics
from .log import Log

__all__ = ["FaultError", "RetryPolicy", "configure", "inject", "reset",
           "is_enabled", "count"]


class FaultError(RuntimeError):
    """Raised by an injected failure; carries the site name."""

    def __init__(self, site: str):
        super().__init__(f"injected fault at '{site}'")
        self.site = site


def _tick(name: str) -> None:
    """Count one hit on the named registry counter (the observable
    ledger: fault.<site> / retry.attempts in metrics.snapshot())."""
    metrics.counter(name).inc()


def count(name: str) -> int:
    """Current hit count of a fault/retry counter (0 if it never fired)."""
    return int(metrics.counter(name).value)


# ---------------------------------------------------------------------------
# RetryPolicy
# ---------------------------------------------------------------------------

@dataclass
class RetryPolicy:
    """Bounded retry with exponential backoff and optional deadline.

    ``run(fn)`` calls ``fn`` up to ``attempts`` times, sleeping between
    failures per :meth:`delays`; exceptions outside ``retry_on`` (and
    the last failure) propagate.  A ``deadline_s`` caps the TOTAL wall
    time: a retry whose backoff would cross it re-raises immediately —
    bounded recovery, never a disguised hang.
    """

    attempts: int = 3
    backoff_s: float = 0.05
    multiplier: float = 2.0
    max_backoff_s: float = 2.0
    jitter: float = 0.1          # ± fraction of each delay
    deadline_s: Optional[float] = None
    retry_on: Tuple[Type[BaseException], ...] = (OSError,)
    seed: Optional[int] = None   # deterministic jitter for tests

    def delays(self):
        """The backoff schedule (``attempts - 1`` sleep durations)."""
        rng = random.Random(self.seed)
        d = self.backoff_s
        for _ in range(max(0, self.attempts - 1)):
            j = 1.0 + self.jitter * (2.0 * rng.random() - 1.0)
            yield min(d, self.max_backoff_s) * j
            d *= self.multiplier

    def run(self, fn: Callable[..., Any], *args: Any,
            on_retry: Optional[Callable[[int, BaseException], None]] = None,
            **kwargs: Any) -> Any:
        start = time.monotonic()
        delays = list(self.delays())
        for i in range(self.attempts):
            try:
                return fn(*args, **kwargs)
            except self.retry_on as exc:
                if i == self.attempts - 1:
                    raise
                delay = delays[i]
                if (self.deadline_s is not None
                        and time.monotonic() + delay - start
                        > self.deadline_s):
                    raise
                _tick("retry.attempts")
                Log.info("retry %d/%d after %s: %s (backoff %.0f ms)",
                         i + 1, self.attempts - 1, type(exc).__name__, exc,
                         delay * 1e3)
                if on_retry is not None:
                    on_retry(i, exc)
                time.sleep(delay)
        raise AssertionError("unreachable")  # pragma: no cover


# ---------------------------------------------------------------------------
# Fault injector
# ---------------------------------------------------------------------------

@dataclass
class _Site:
    rate: float = 0.0            # probability per op
    times: int = 0               # deterministic: fire on the next n ops
    delay_s: float = 0.0         # sleep instead of raising when > 0
    error: Type[BaseException] = FaultError


_LOCK = threading.Lock()
_SITES: Dict[str, _Site] = {}
_RNG = random.Random(0)
# Module-level fast-path gate — inject() must cost one attribute load +
# bool check on every hot-path call when chaos is off.
_ENABLED = False


def is_enabled() -> bool:
    return _ENABLED


def configure(seed: Optional[int] = None,
              sites: Optional[Dict[str, Any]] = None) -> None:
    """Arm the injector.  ``sites`` maps a site name to either a float
    (probability per op) or a dict with any of ``rate`` / ``times`` /
    ``delay_s`` / ``error``::

        fault.configure(seed=1234, sites={
            "io.write": {"times": 2},          # next two writes fail
            "table.Add": 0.1,                  # 10% of adds fail
            "barrier": {"delay_s": 5.0, "times": 1},  # one hung barrier
        })

    A site fires by consuming ``times`` first, then by ``rate``.
    Matching is exact name, then the prefix before the last dot
    (``io.write`` falls back to a configured ``io``).
    """
    global _ENABLED
    with _LOCK:
        if seed is not None:
            _RNG.seed(seed)
        for name, spec in (sites or {}).items():
            if isinstance(spec, (int, float)):
                _SITES[name] = _Site(rate=float(spec))
            else:
                _SITES[name] = _Site(**spec)
        _ENABLED = any(s.rate > 0 or s.times > 0 for s in _SITES.values())


def reset() -> None:
    """Disarm completely and zero the counter ledger (test isolation)."""
    global _ENABLED
    with _LOCK:
        _SITES.clear()
        _ENABLED = False
    for s in metrics.REGISTRY.series():
        if isinstance(s, metrics.Counter) and (
                s.name.startswith("fault.")
                or s.name.startswith("retry.")):
            metrics.REGISTRY.remove(s.name, s.labels or None)


def _lookup(site: str) -> Optional[_Site]:
    s = _SITES.get(site)
    if s is None and "." in site:
        s = _SITES.get(site.rsplit(".", 1)[0])
    return s


def inject(site: str) -> None:
    """Chaos seam: no-op unless armed; otherwise maybe delay or raise.

    Call sites name WHERE they are (``io.write``, ``table.Get``,
    ``barrier``); the configuration decides IF and HOW they fail.
    """
    if not _ENABLED:
        return
    with _LOCK:
        s = _lookup(site)
        if s is None:
            return
        if s.times > 0:
            s.times -= 1
        elif not (s.rate > 0 and _RNG.random() < s.rate):
            return
        delay_s, error = s.delay_s, s.error
    _tick(f"fault.{site}")
    if delay_s > 0:
        Log.info("fault: injected %.1f s delay at '%s'", delay_s, site)
        time.sleep(delay_s)
        return
    Log.info("fault: injected failure at '%s'", site)
    if error is FaultError:
        raise FaultError(site)
    raise error(f"injected fault at '{site}'")


def _init_from_env() -> None:
    import os

    seed = os.environ.get("MVTPU_FAULT_SEED")
    if seed is not None:
        configure(seed=int(seed))


_init_from_env()
