"""Error-budget / burn-rate math for the health plane
(docs/observability.md "health plane").

Pure functions over ``[(ts, value)]`` point lists — the exact shape
:mod:`multiverso_tpu_torch.metrics` records into its bounded time-series ring
(one point per flush) — so every result here is hand-computable in a
test without a registry, a flusher, or a fleet.  ``health.py`` is the
stateful evaluator that feeds these from live rings each flush.

The model is the standard SRE error-budget one: an SLO objective (say
0.999 availability over the window) leaves a budget of ``1 - objective``
bad events per good+bad event; the **burn rate** is how many multiples
of that budget the observed bad fraction is consuming.  Burn rate 1.0
spends exactly the budget over the SLO window; burn rate 14 spends a
30-day budget in ~2 days.  Multiwindow alerting (a LONG window for
significance and a SHORT window for "still happening now") is what
keeps a burn-rate alert both fast and flap-free: the long window alone
keeps firing long after recovery, the short window alone fires on any
blip.

Every function returns ``None`` when the ring cannot answer yet (fewer
than two points in the window, zero elapsed, zero denominator) — the
same ``'-'`` discipline as ``metrics.rate()``: "no data" must never
read as "zero".
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

__all__ = [
    "budget", "window_points", "window_delta", "window_rate",
    "error_fraction", "burn_rate", "multiwindow_burn",
]

Point = Tuple[float, float]


def budget(objective: float) -> float:
    """The error budget an SLO objective leaves: ``1 - objective``
    (objective 0.999 -> 0.001).  Raises on a non-sensical objective —
    a rule with objective >= 1.0 has no budget to burn and would
    divide by zero quietly forever."""
    if not 0.0 < objective < 1.0:
        raise ValueError(
            f"SLO objective must be in (0, 1), got {objective}")
    return 1.0 - objective


def window_points(points: Sequence[Point], window_s: float,
                  now: Optional[float] = None) -> List[Point]:
    """The suffix of ``points`` whose timestamps fall within
    ``window_s`` of ``now`` (default: the last point's timestamp).
    Points are assumed time-ordered, as the metrics ring records them."""
    if not points:
        return []
    end = points[-1][0] if now is None else float(now)
    lo = end - float(window_s)
    return [p for p in points if lo <= p[0] <= end]


def window_delta(points: Sequence[Point], window_s: float,
                 now: Optional[float] = None) -> Optional[float]:
    """Counter increase over the window: last - first of the in-window
    points, clamped at 0 (a restarted rank's counter reset reads as no
    events, not negative events).  ``None`` with fewer than two
    in-window points — one sample is a value, never a delta."""
    pts = window_points(points, window_s, now)
    if len(pts) < 2:
        return None
    return max(0.0, pts[-1][1] - pts[0][1])


def window_rate(points: Sequence[Point], window_s: float,
                now: Optional[float] = None) -> Optional[float]:
    """Per-second rate over the window (``window_delta`` / elapsed);
    ``None`` when the delta is undefined or no time elapsed."""
    pts = window_points(points, window_s, now)
    if len(pts) < 2:
        return None
    elapsed = pts[-1][0] - pts[0][0]
    if elapsed <= 0:
        return None
    return max(0.0, pts[-1][1] - pts[0][1]) / elapsed


def error_fraction(bad: Sequence[Point], total: Sequence[Point],
                   window_s: float,
                   now: Optional[float] = None) -> Optional[float]:
    """Fraction of events in the window that were bad:
    ``delta(bad) / delta(total)``.  ``None`` when either delta is
    undefined or no events happened — zero traffic is "no data", not
    "perfect availability" (an idle rank must not mask a broken one by
    averaging, nor look healthy just because nobody asked)."""
    db = window_delta(bad, window_s, now)
    dt = window_delta(total, window_s, now)
    if db is None or dt is None or dt <= 0:
        return None
    return min(1.0, db / dt)


def burn_rate(bad: Sequence[Point], total: Sequence[Point],
              objective: float, window_s: float,
              now: Optional[float] = None) -> Optional[float]:
    """How many multiples of the error budget the window consumed:
    ``error_fraction / (1 - objective)``.  1.0 = spending exactly the
    budget; ``None`` under the no-data rules of
    :func:`error_fraction`."""
    frac = error_fraction(bad, total, window_s, now)
    if frac is None:
        return None
    return frac / budget(objective)


def multiwindow_burn(bad: Sequence[Point], total: Sequence[Point],
                     objective: float, threshold: float,
                     long_s: float, short_s: float,
                     now: Optional[float] = None
                     ) -> Tuple[Optional[float], Optional[float], bool]:
    """Multiwindow burn-rate check (the SRE-workbook alert shape):
    returns ``(long_burn, short_burn, firing)`` where ``firing`` is
    True only when BOTH windows burn past ``threshold`` — the long
    window proves the spend is significant, the short window proves it
    is still happening (so the alert resolves promptly after the fault
    clears instead of dragging the long window's tail).  A ``short_s``
    of 0 degenerates to single-window.  Either burn being ``None``
    (no data) means not firing."""
    long_burn = burn_rate(bad, total, objective, long_s, now)
    if short_s <= 0:
        firing = long_burn is not None and long_burn > threshold
        return long_burn, long_burn, firing
    short_burn = burn_rate(bad, total, objective, short_s, now)
    firing = (long_burn is not None and long_burn > threshold and
              short_burn is not None and short_burn > threshold)
    return long_burn, short_burn, firing
