"""Latency attribution — the Python half of the latency plane
(docs/observability.md "latency plane").

The native runtime stamps a :class:`~multiverso_tpu_torch.serve.wire.TIMING`
trail into every worker request and attributes replies into
``lat.stage.*`` Dashboard histograms itself; this module does the same
for the PYTHON serve clients (``serve/wire.py`` computes the stage
math — it must stay stdlib-only — and this module lands the results in
the metrics registry), and gives tooling one import for the stage
names, the breakdown shape, and the dominant-stage analysis
``tools/latdoctor.py`` prints.

Stage model (six wire-stamped boundaries; see ``mvtpu/latency.h``)::

    queue      client: request minted -> handed to the transport
    wire_out   client send -> server frame-complete   (offset-corrected)
    mailbox    server reactor -> actor dequeue (incl. shed/SSP park)
    apply      server: table work
    reactor    server: apply done -> reply handed to the transport
    wire_back  reply send -> client receipt           (offset-corrected)

Offset-corrected stages telescope back to the end-to-end ``total``
exactly, so ``sum(stages) ~= total`` is a checkable invariant (the
``make latency-demo`` acceptance bar).
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, Optional

from . import metrics
from .serve.wire import (STAGES, OffsetEstimator, ntp_sample,  # noqa: F401
                         stage_durations)

__all__ = [
    "STAGES", "stage_durations", "ntp_sample", "OffsetEstimator",
    "record_stages", "attach_metrics", "dominant_stage", "stage_summary",
]


def record_stages(stages: Dict[str, float],
                  trace_id: Optional[int] = None) -> None:
    """Fold one round trip's stage breakdown (seconds, as produced by
    :func:`stage_durations`) into the metrics registry — the same
    ``lat.stage.<name>`` / ``lat.total`` series the native bridge
    imports, so one scrape carries both planes.  When
    ``-health_latency_slo_ms`` > 0 each total also scores the
    ``lat.slo.total`` / ``lat.slo.breach`` error-budget counters the
    health plane's burn-rate rule consumes (docs/observability.md
    "health plane")."""
    for name, seconds in stages.items():
        series = ("lat.total" if name == "total"
                  else f"lat.stage.{name}")
        metrics.histogram(series).observe(seconds, trace_id=trace_id)
    total = stages.get("total")
    if total is not None:
        slo_s = _slo_threshold_s()
        if slo_s > 0:
            # Both counters exist from the first scored round trip: a
            # counter's history ring starts at the first flush after it
            # is made, so a breach counter made by the first breach
            # would hide from the burn windows every breach before that
            # flush (a whole burst between two flushes read as none).
            breach = metrics.counter("lat.slo.breach")
            metrics.counter("lat.slo.total").inc()
            if total > slo_s:
                breach.inc()


def _slo_threshold_s() -> float:
    """The -health_latency_slo_ms flag in seconds (0 when unset or the
    flag registry is not initialised — serve/wire must stay usable
    standalone)."""
    try:
        from . import config

        return float(config.get("health_latency_slo_ms")) / 1e3
    except Exception:
        return 0.0


def attach_metrics(client: Any) -> Any:
    """Wire an :class:`~multiverso_tpu_torch.serve.wire.AnonServeClient`'s
    stage hook to the metrics registry: every timed reply it receives
    lands in the ``lat.stage.*`` histograms automatically.  Returns the
    client for chaining."""
    client.stage_hook = record_stages
    return client


def dominant_stage(report: Dict[str, Any],
                   quantile: str = "p99_ms") -> Optional[str]:
    """The stage carrying the most time at ``quantile`` in a "latency"
    ops report (the JSON ``MV_OpsReport("latency")`` / the ``latency``
    OpsQuery kind serve) — what latdoctor names.  ``None`` when the
    report holds no stages."""
    stages = report.get("stages") or {}
    best = None
    best_v = -1.0
    for name, st in stages.items():
        v = float(st.get(quantile, 0.0) or 0.0)
        if v > best_v:
            best, best_v = name, v
    return best


def stage_summary(report: Dict[str, Any]) -> Dict[str, Dict[str, float]]:
    """``{stage: {p50_ms, p95_ms, p99_ms, count}}`` out of a "latency"
    ops report, total included under ``"total"`` — the table latdoctor
    renders."""
    out: Dict[str, Dict[str, float]] = {}
    for name, st in (report.get("stages") or {}).items():
        out[name] = {k: float(st.get(k, 0.0) or 0.0)
                     for k in ("p50_ms", "p95_ms", "p99_ms", "count")}
    total = report.get("total")
    if total:
        out["total"] = {k: float(total.get(k, 0.0) or 0.0)
                        for k in ("p50_ms", "p95_ms", "p99_ms", "count")}
    return out
