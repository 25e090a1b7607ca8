"""Health plane — declarative SLO/alert rules evaluated each metrics
flush (docs/observability.md "health plane").

Five observability planes record signals (metrics/tracing, ops scrapes,
workload, latency, audit, capacity) but until this module nothing in
the tree *watched* them: every regression waited for a human to run
``mvtop`` by hand.  The health plane closes the loop:

- a :class:`Rule` names a metric, an operator (``p99_gt`` | ``rate_gt``
  | ``burn_rate_gt`` | ``counter_delta_gt`` | ``absent``), a threshold,
  a ``for_s`` hysteresis and a severity;
- a :class:`HealthEvaluator` runs every rule against the metrics
  registry's time-series rings on each flush (``metrics.add_flush_hook``)
  and drives the ok → pending → firing → resolved state machine;
- firing/resolving lands in the registry
  (``health.alerts.firing{severity=...}``), emits a flight-recorder
  event, and a CRITICAL alert additionally **re-arms the sampling
  profiler at a boosted rate** (adaptive observability: the evidence
  recorder spins up exactly when something is wrong) and triggers a
  blackbox dump;
- the full alert state is pushed to the native ops plane
  (``MV_SetOpsHostAlerts``) so the in-band ``"alerts"`` OpsQuery kind —
  and therefore one fleet-scope scrape — names every firing alert
  fleet-wide (``tools/mvtop.py --alerts``; ``tools/mvdoctor.py``
  correlates it across planes).

``for_s`` hysteresis is quantized by the flush cadence: a rule is only
evaluated once per flush, so a ``for_s`` of 2s with
``-metrics_flush_ms=500`` needs 4 consecutive breaching flushes, and
``for_s`` longer than ``flush interval x -metrics_history`` can never
fire (the ring forgets the breach before the hysteresis elapses).

A signal that cannot be computed yet (``rate()`` before two flushes,
p99 of an empty histogram, burn rate under zero traffic) is ``None``
and NEVER fires — the same ``'-'`` discipline the rest of the tree
uses: "no data" must not read as "healthy" OR as "breaching".  The
exception is ``absent``, whose whole job is to fire on missing series.

Pure rule math lives in :mod:`multiverso_tpu_torch.slo`; this module owns the
state machine and the wiring.
"""

from __future__ import annotations

import json
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from . import metrics, slo
from .log import Log

__all__ = [
    "Rule", "Alert", "HealthEvaluator", "RULE_OPS", "SEVERITIES",
    "default_rules", "arm", "disarm", "evaluator", "snapshot",
    "alerts_doc", "fleet_alert_rows",
]

RULE_OPS = ("p99_gt", "rate_gt", "burn_rate_gt", "counter_delta_gt",
            "absent")
SEVERITIES = ("info", "warning", "critical")

# Boosted sampler rate a critical alert arms (prime, like the 97 Hz
# house rate, so it cannot phase-lock with millisecond-periodic work).
BOOST_HZ = 997


@dataclass
class Rule:
    """One declarative alert rule.

    ``metric`` is a registry series name (``native.``-prefixed for
    bridged native monitors); histogram rules on ``rate_gt`` /
    ``counter_delta_gt`` / ``burn_rate_gt`` transparently fall back to
    the ring's ``<metric>_count`` series.  ``window_s`` bounds the
    history consulted; ``burn_rate_gt`` additionally needs
    ``total_metric`` (the denominator counter), ``objective`` and —
    for multiwindow mode — ``short_window_s`` (0 = single window).
    """

    name: str
    metric: str
    op: str
    threshold: float = 0.0
    for_s: float = 0.0
    severity: str = "warning"
    labels: Optional[Dict[str, str]] = None
    window_s: float = 60.0
    # burn_rate_gt only:
    total_metric: str = ""
    objective: float = 0.999
    short_window_s: float = 0.0

    def __post_init__(self) -> None:
        if self.op not in RULE_OPS:
            raise ValueError(
                f"rule {self.name!r}: unknown op {self.op!r} "
                f"(expected one of {RULE_OPS})")
        if self.severity not in SEVERITIES:
            raise ValueError(
                f"rule {self.name!r}: unknown severity "
                f"{self.severity!r} (expected one of {SEVERITIES})")
        if self.op == "burn_rate_gt" and not self.total_metric:
            raise ValueError(
                f"rule {self.name!r}: burn_rate_gt needs total_metric")


@dataclass
class Alert:
    """Live state of one rule: ``ok`` | ``pending`` | ``firing``.

    ``pending`` means the condition is true but younger than
    ``for_s``; ``fired``/``resolved`` count lifecycle transitions (a
    flapping series under a generous ``for_s`` shows pending churn but
    zero fires — that is the hysteresis doing its job)."""

    rule: Rule
    state: str = "ok"
    since: float = 0.0          # monotonic ts of the last state change
    value: Optional[float] = None
    fired: int = 0
    resolved: int = 0

    def to_dict(self, now: Optional[float] = None) -> Dict[str, Any]:
        ts = time.monotonic() if now is None else float(now)
        r = self.rule
        return {
            "rule": r.name, "metric": r.metric, "op": r.op,
            "threshold": r.threshold, "severity": r.severity,
            "state": self.state,
            "value": self.value,
            "age_s": round(max(0.0, ts - self.since), 3),
            "fired": self.fired, "resolved": self.resolved,
        }


class HealthEvaluator:
    """Evaluates a rule set against a metrics registry each call.

    One instance per process (module-level :func:`arm`); ``evaluate()``
    runs on the metrics flush thread, so every per-rule failure is
    contained — a broken rule logs and scores ``None``, it never kills
    the flusher."""

    def __init__(self, rules: List[Rule],
                 registry: Optional[metrics.Registry] = None,
                 runtime: Any = None):
        self._rules = list(rules)
        self._registry = registry or metrics.REGISTRY
        self._runtime = runtime
        self._lock = threading.Lock()
        self._alerts = {r.name: Alert(rule=r, since=time.monotonic())
                        for r in self._rules}
        self._boosted = False
        self._prev_py_hz = 0

    # ------------------------------------------------------------ signals
    def _find_series(self, name: str, labels: Optional[Dict[str, str]]):
        key = metrics._label_key(labels)
        for s in self._registry.series():
            if s.name == name and metrics._label_key(s.labels) == key:
                return s
        return None

    def _points(self, name: str, labels: Optional[Dict[str, str]]
                ) -> List:
        """History ring for a series, falling back to the histogram-
        derived ``_count`` ring so counter-style ops work on either."""
        pts = self._registry.history(name, labels)
        if not pts:
            pts = self._registry.history(name + "_count", labels)
        return pts

    def _signal(self, rule: Rule) -> Optional[float]:
        """The rule's observed value, ``None`` when unanswerable."""
        if rule.op == "p99_gt":
            s = self._find_series(rule.metric, rule.labels)
            if s is None or not isinstance(s, metrics.Histogram):
                return None
            if s.count == 0:
                return None
            return s.quantile(0.99)
        if rule.op == "rate_gt":
            return slo.window_rate(
                self._points(rule.metric, rule.labels), rule.window_s)
        if rule.op == "counter_delta_gt":
            return slo.window_delta(
                self._points(rule.metric, rule.labels), rule.window_s)
        if rule.op == "burn_rate_gt":
            long_burn, _short, _firing = slo.multiwindow_burn(
                self._points(rule.metric, rule.labels),
                self._points(rule.total_metric, None),
                rule.objective, rule.threshold,
                rule.window_s, rule.short_window_s)
            return long_burn
        if rule.op == "absent":
            return 1.0 if self._find_series(rule.metric,
                                            rule.labels) is None else 0.0
        return None

    def _condition(self, rule: Rule,
                   value: Optional[float]) -> Optional[bool]:
        if value is None:
            return None
        if rule.op == "absent":
            return value > 0.0
        if rule.op == "burn_rate_gt":
            # Multiwindow: BOTH windows must burn past the threshold.
            _long, _short, firing = slo.multiwindow_burn(
                self._points(rule.metric, rule.labels),
                self._points(rule.total_metric, None),
                rule.objective, rule.threshold,
                rule.window_s, rule.short_window_s)
            return firing
        return value > rule.threshold

    # ------------------------------------------------------------ machine
    def evaluate(self, now: Optional[float] = None) -> List[Dict[str, Any]]:
        """Run every rule once; returns the lifecycle transitions
        (``[{"rule":, "to": "firing"|"resolved"}]``) this pass caused.
        Called by the metrics flush hook each interval."""
        ts = time.monotonic() if now is None else float(now)
        transitions: List[Dict[str, Any]] = []
        with self._lock:
            for rule in self._rules:
                alert = self._alerts[rule.name]
                try:
                    value = self._signal(rule)
                    cond = self._condition(rule, value)
                except Exception as exc:  # a broken rule must not kill
                    Log.error("health: rule %s evaluation failed: %s",
                              rule.name, exc)
                    value, cond = None, None
                alert.value = value
                if cond is None:
                    # No data: a pending alert loses its evidence and
                    # resets; a FIRING alert stays firing — silence is
                    # not proof of recovery.
                    if alert.state == "pending":
                        alert.state, alert.since = "ok", ts
                    continue
                if cond:
                    if alert.state == "ok":
                        alert.state, alert.since = "pending", ts
                    if (alert.state == "pending"
                            and ts - alert.since >= rule.for_s):
                        alert.state, alert.since = "firing", ts
                        alert.fired += 1
                        transitions.append(
                            {"rule": rule.name, "to": "firing",
                             "severity": rule.severity, "value": value})
                else:
                    if alert.state == "pending":
                        alert.state, alert.since = "ok", ts
                    elif alert.state == "firing":
                        alert.state, alert.since = "ok", ts
                        alert.resolved += 1
                        transitions.append(
                            {"rule": rule.name, "to": "resolved",
                             "severity": rule.severity, "value": value})
            firing = [a for a in self._alerts.values()
                      if a.state == "firing"]
        self._export(firing)
        for t in transitions:
            self._record_transition(t)
        self._adapt(firing, transitions)
        return transitions

    def _export(self, firing: List[Alert]) -> None:
        """Land the firing counts in the registry so alert state itself
        is scrapeable (and ring-recorded) like any other series."""
        counts = {sev: 0 for sev in SEVERITIES}
        for a in firing:
            counts[a.rule.severity] += 1
        for sev, n in counts.items():
            metrics.gauge("health.alerts.firing",
                          {"severity": sev}).set(float(n))

    def _record_transition(self, t: Dict[str, Any]) -> None:
        try:
            from .ops.flight_recorder import recorder

            recorder.record(
                "alert_" + ("fired" if t["to"] == "firing"
                            else "resolved"),
                t["rule"], severity=t["severity"],
                value=t.get("value"))
        except Exception as exc:
            Log.error("health: flight-record of %s failed: %s",
                      t["rule"], exc)

    def _adapt(self, firing: List[Alert],
               transitions: List[Dict[str, Any]]) -> None:
        """Adaptive observability: a critical alert boosts the sampling
        profiler (evidence collection scales up exactly when something
        is wrong) and triggers a blackbox dump; the last critical
        resolving restores the previous rate."""
        any_critical = any(a.rule.severity == "critical" for a in firing)
        newly_critical = [t for t in transitions
                          if t["to"] == "firing"
                          and t["severity"] == "critical"]
        for t in newly_critical:
            reason = (f"alert: {t['rule']} critical "
                      f"(value={t.get('value')})")
            try:
                if self._runtime is not None:
                    self._runtime.blackbox_trigger(reason)
                else:
                    from .ops.flight_recorder import recorder

                    recorder.trigger(reason)
            except Exception as exc:
                Log.error("health: blackbox trigger failed: %s", exc)
        try:
            if any_critical and not self._boosted:
                self._boost()
            elif not any_critical and self._boosted:
                self._unboost()
        except Exception as exc:
            Log.error("health: profiler adapt failed: %s", exc)

    def _boost(self) -> None:
        from . import profiler as pyprof

        cur = pyprof.active()
        self._prev_py_hz = cur.hz if cur is not None else 0
        if cur is not None:
            pyprof.stop(to_trace=False)
        pyprof.start(BOOST_HZ)
        if self._runtime is not None:
            self._runtime.set_profiler(BOOST_HZ)
        self._boosted = True
        Log.info("health: critical alert — profiler boosted to %d Hz",
                 BOOST_HZ)

    def _unboost(self) -> None:
        from . import profiler as pyprof

        pyprof.stop(to_trace=False)
        if self._prev_py_hz > 0:
            pyprof.start(self._prev_py_hz)
        if self._runtime is not None:
            self._runtime.set_profiler(self._prev_py_hz)
        self._boosted = False
        Log.info("health: criticals resolved — profiler restored to "
                 "%d Hz", self._prev_py_hz)

    # ------------------------------------------------------------ reports
    def alerts(self) -> List[Alert]:
        with self._lock:
            return list(self._alerts.values())

    def snapshot(self) -> List[Dict[str, Any]]:
        now = time.monotonic()
        with self._lock:
            return [a.to_dict(now) for a in self._alerts.values()]


# ---------------------------------------------------------------------------
# Built-in default rule pack: one rule per existing plane.  Metrics a
# process never records simply score None (or fire `absent` only where
# that is the point) — the pack is safe to arm everywhere.
# ---------------------------------------------------------------------------

def default_rules() -> List[Rule]:
    return [
        # Latency plane: end-to-end p99 over the wire (Python serve
        # clients and the native bridge both feed lat.total).
        Rule(name="lat-p99", metric="lat.total", op="p99_gt",
             threshold=0.5, for_s=2.0, severity="critical"),
        # Latency SLO burn (multiwindow): record_stages feeds the
        # breach/total counters against -health_latency_slo_ms.
        Rule(name="lat-slo-burn", metric="lat.slo.breach",
             op="burn_rate_gt", total_metric="lat.slo.total",
             threshold=10.0, objective=0.999, window_s=300.0,
             short_window_s=30.0, for_s=0.0, severity="critical"),
        # Serve tier: sustained shedding means real work is bouncing.
        Rule(name="shed-rate", metric="native.serve.shed", op="rate_gt",
             threshold=10.0, for_s=5.0, severity="warning",
             window_s=30.0),
        # Audit plane: ANY delivery gap inside the window is a loss
        # signal (docs/observability.md "audit plane").
        Rule(name="audit-gap", metric="native.audit.gap",
             op="counter_delta_gt", threshold=0.0, for_s=0.0,
             severity="critical", window_s=120.0),
        # Wire plane: a retry storm precedes most cascade failures.
        Rule(name="retry-rate", metric="native.net.retries",
             op="rate_gt", threshold=5.0, for_s=5.0,
             severity="warning", window_s=30.0),
        # Capacity plane: RSS growing this fast burns headroom toward
        # the OOM killer (256 MiB per 5-minute window).
        Rule(name="rss-growth", metric="proc.rss_bytes",
             op="counter_delta_gt", threshold=256e6, for_s=0.0,
             severity="warning", window_s=300.0),
        # Membership plane: a missed heartbeat lease = a dead peer.
        Rule(name="hb-missed", metric="native.hb.missed",
             op="counter_delta_gt", threshold=0.0, for_s=0.0,
             severity="critical", window_s=120.0),
    ]


# ---------------------------------------------------------------------------
# Module singleton: arm()/disarm() wire the evaluator into the metrics
# flush loop and the native alerts push (docs/observability.md).
# ---------------------------------------------------------------------------

_LOCK = threading.Lock()
_EVALUATOR: Optional[HealthEvaluator] = None
_HOOK: Optional[Callable[[], None]] = None


def _export_proc_gauges() -> None:
    """Export /proc/self RSS as a ``proc.rss_bytes`` gauge so the
    capacity-headroom rule (and the ring behind it) has a Python-plane
    signal even without a native runtime attached."""
    try:
        with open("/proc/self/statm") as f:
            fields = f.read().split()
        import resource

        page = resource.getpagesize()
        metrics.gauge("proc.rss_bytes").set(float(int(fields[1]) * page))
    except (OSError, IndexError, ValueError):
        pass  # non-Linux host: the rule simply scores None


def arm(rules: Optional[List[Rule]] = None, runtime: Any = None,
        registry: Optional[metrics.Registry] = None) -> HealthEvaluator:
    """Arm the health plane: build the evaluator (default rule pack
    when ``rules`` is None), hook it into the metrics flush loop, and —
    with a native ``runtime`` — push the alert state to the ops plane
    (``MV_SetOpsHostAlerts``) after every evaluation plus bump the
    native stall watchdog's ``py.flush`` loop (a wedged Python flusher
    is detected by the NATIVE checker).  Re-arming replaces the
    previous evaluator."""
    global _EVALUATOR, _HOOK
    ev = HealthEvaluator(rules if rules is not None else default_rules(),
                         registry=registry, runtime=runtime)

    def _on_flush() -> None:
        _export_proc_gauges()
        ev.evaluate()
        if runtime is not None:
            try:
                runtime.watchdog_bump("py.flush")
                runtime.set_ops_host_alerts(json.dumps(alerts_doc()))
            except Exception as exc:
                Log.error("health: alerts push failed: %s", exc)

    with _LOCK:
        if _HOOK is not None:
            metrics.remove_flush_hook(_HOOK)
        _EVALUATOR, _HOOK = ev, _on_flush
        metrics.add_flush_hook(_on_flush)
    if runtime is not None:
        try:
            runtime.watchdog_busy("py.flush", 1)
        except Exception as exc:
            Log.error("health: watchdog arm failed: %s", exc)
    return ev


def disarm(runtime: Any = None) -> None:
    """Drop the evaluator and its flush hook (test isolation /
    shutdown); marks the watchdog's ``py.flush`` loop idle so a
    legitimately-stopped flusher never reads as a stall."""
    global _EVALUATOR, _HOOK
    with _LOCK:
        if _HOOK is not None:
            metrics.remove_flush_hook(_HOOK)
        ev, _EVALUATOR, _HOOK = _EVALUATOR, None, None
    rt = runtime if runtime is not None else (
        ev._runtime if ev is not None else None)
    if rt is not None:
        try:
            rt.watchdog_busy("py.flush", 0)
            rt.set_ops_host_alerts("")
        except Exception:
            pass  # runtime may already be shut down


def evaluator() -> Optional[HealthEvaluator]:
    with _LOCK:
        return _EVALUATOR


def snapshot() -> List[Dict[str, Any]]:
    """The armed evaluator's alert state ([] when disarmed)."""
    ev = evaluator()
    return ev.snapshot() if ev is not None else []


def alerts_doc() -> Dict[str, Any]:
    """The host-side alerts document pushed to the native ops plane —
    what the ``"alerts"`` OpsQuery kind serves under ``"host"``."""
    ev = evaluator()
    alerts = ev.snapshot() if ev is not None else []
    return {
        "armed": ev is not None,
        "rules": len(alerts),
        "firing": sum(1 for a in alerts if a["state"] == "firing"),
        "alerts": alerts,
    }


# ---------------------------------------------------------------------------
# Fleet merge helper (pure): rows for mvtop --alerts / mvdoctor.
# ---------------------------------------------------------------------------

def fleet_alert_rows(doc: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Flatten a fleet-scope ``"alerts"`` report into per-alert rows.

    ``doc`` is either one rank's local report (``{"rank":, "host":,
    "watchdog":}``) or the fleet wrapper (``{"ranks": {...},
    "silent": [...]}``).  A SILENT rank's alerts are explicitly
    ``unknown`` — never ``resolved``: a rank that cannot answer its
    scrape is the opposite of evidence that its alerts cleared.
    Native watchdog stalls join as synthetic ``watchdog:<loop>`` rows
    so one view names both planes' failures."""
    per_rank: Dict[str, Optional[Dict[str, Any]]] = {}
    if "ranks" in doc:
        for rank, rep in (doc.get("ranks") or {}).items():
            per_rank[str(rank)] = rep
        for rank in doc.get("silent") or []:
            per_rank[str(rank)] = None
    else:
        per_rank[str(doc.get("rank", "?"))] = doc
    rows: List[Dict[str, Any]] = []
    for rank in sorted(per_rank, key=str):
        rep = per_rank[rank]
        if rep is None:
            rows.append({"rank": rank, "rule": "-", "severity": "-",
                         "state": "unknown", "value": None,
                         "age_s": None})
            continue
        host = rep.get("host") or {}
        for a in host.get("alerts") or []:
            rows.append({"rank": rank, "rule": a.get("rule", "?"),
                         "severity": a.get("severity", "?"),
                         "state": a.get("state", "?"),
                         "value": a.get("value"),
                         "age_s": a.get("age_s")})
        for loop in rep.get("watchdog") or []:
            if loop.get("stalled"):
                rows.append({"rank": rank,
                             "rule": f"watchdog:{loop.get('loop', '?')}",
                             "severity": "critical", "state": "firing",
                             "value": float(loop.get("queued", 0)),
                             "age_s": loop.get("stalled_s")})
    return rows
