"""Unified metrics registry — counters, gauges, and fixed-bucket
histograms with p50/p95/p99 (docs/observability.md).

The reference Multiverso only dumps named timers at shutdown
(SURVEY.md §2.26); this registry is the superset every signal source in
the port now feeds:

- ``dashboard.py`` monitors (every table op, ``Zoo::Barrier``, jitted
  steps) are histograms here — ``dashboard.monitor()`` stays as a shim;
- ``fault.py`` injector/retry events are counters;
- ``io/stream.py`` counts stream bytes;
- ALL native ``Dashboard`` monitors (wire sends, server applies,
  ``net.retries``/``hb.missed``, chaos counters) bridge in through one
  ``MV_DumpMonitors`` call (:func:`bridge_native`).

Surface: :func:`counter` / :func:`gauge` / :func:`histogram` mint (or
look up) a series, optionally labeled (per-table, per-rank, ...);
:func:`snapshot` renders everything to a plain dict;
:func:`render_prometheus` emits Prometheus text format;
:func:`start_flush` runs a periodic export thread gated by the
``-metrics_flush_ms`` / ``-trace_dir`` flags (wired up by ``init()``).

Thread safety: every series carries its own lock; the registry map has
another.  A disabled-path observation costs one lock + a few adds.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Any, Dict, Iterable, Optional, Tuple

from .log import Log

__all__ = [
    "Counter", "Gauge", "Histogram", "Registry",
    "counter", "gauge", "histogram", "snapshot", "render_prometheus",
    "reset", "bridge_native", "start_flush", "stop_flush", "set_ops_push",
    "record_history", "rate", "delta", "history", "set_history_depth",
    "add_flush_hook", "remove_flush_hook",
    "NATIVE_TIME_BUCKETS", "DEFAULT_TIME_BUCKETS", "HISTORY_SNAPSHOTS",
]

# Mirror of the native Dashboard's fixed log2 latency buckets
# (mvtpu/dashboard.h kDashboardBuckets): bucket i holds values
# <= 1e-6 * 2^i seconds, the implicit last bucket is +inf.  The two
# lists MUST stay identical or bridged percentiles silently skew.
NATIVE_TIME_BUCKETS: Tuple[float, ...] = tuple(
    1e-6 * 2.0 ** i for i in range(27))
DEFAULT_TIME_BUCKETS = NATIVE_TIME_BUCKETS

# A labeled metric name may not explode into unbounded series (a bug
# that labels by value — row id, msg id — would OOM the registry);
# beyond the cap new label sets collapse into one overflow series.
# Per-key/per-row accounting belongs in a bounded sketch
# (multiverso_tpu_torch/sketch.py), never in registry labels — mvlint MV011
# polices the call sites.
MAX_SERIES_PER_NAME = 256
_OVERFLOW_LABELS = (("overflow", "true"),)

# Bounded per-series time-series ring: the last N history snapshots
# (one per record_history() call — the flush thread takes one each
# interval), enabling rate()/delta() queries so QPS / shed-rate /
# bytes-per-second are first-class instead of eyeball-the-counter.
# Default depth; the -metrics_history flag retargets it via
# set_history_depth() at init.  The ring spans roughly
# flush-interval x depth of wall time — an alert rule's window_s (or
# for_s hysteresis) longer than that can never see enough history.
HISTORY_SNAPSHOTS = 64


def _label_key(labels: Optional[Dict[str, str]]) -> Tuple[Tuple[str, str], ...]:
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _series_name(name: str, key: Tuple[Tuple[str, str], ...]) -> str:
    if not key:
        return name
    inner = ",".join(f'{k}="{v}"' for k, v in key)
    return f"{name}{{{inner}}}"


class Counter:
    """Monotonic count (events, bytes)."""

    kind = "counter"

    def __init__(self, name: str, key: Tuple[Tuple[str, str], ...] = ()):
        self.name = name
        self.labels = dict(key)
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    def _load(self, value: float) -> None:
        """Set absolute state (the native bridge imports cumulative
        counters, so re-bridging refreshes rather than double-counts)."""
        with self._lock:
            self._value = float(value)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def to_dict(self) -> Dict[str, Any]:
        return {"type": "counter", "value": self.value}


class Gauge:
    """Point-in-time value (queue depth, dead peers, clock)."""

    kind = "gauge"

    def __init__(self, name: str, key: Tuple[Tuple[str, str], ...] = ()):
        self.name = name
        self.labels = dict(key)
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    def dec(self, n: float = 1.0) -> None:
        self.inc(-n)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def to_dict(self) -> Dict[str, Any]:
        return {"type": "gauge", "value": self.value}


class Histogram:
    """Fixed-bucket histogram with interpolated quantiles.

    ``bounds`` are inclusive upper bucket bounds (ascending); one
    implicit +inf bucket follows.  Quantiles interpolate linearly inside
    the target bucket (clamped to the observed min/max), so with the
    default log2 time buckets the p99 of a latency series is exact to
    within one bucket ratio (2x) — the right fidelity for "where did
    the time go" at zero allocation per observation.

    Each bucket also keeps an **exemplar** — the last trace id whose
    observation landed there (docs/observability.md): a p99 latency
    sample links straight to the merged Chrome trace that explains it.
    Captured from the thread's active ``tracing`` span id (or an
    explicit ``trace_id=``); zero-cost when no span is active.
    """

    kind = "histogram"

    def __init__(self, name: str, key: Tuple[Tuple[str, str], ...] = (),
                 bounds: Iterable[float] = DEFAULT_TIME_BUCKETS):
        self.name = name
        self.labels = dict(key)
        self.bounds = tuple(float(b) for b in bounds)
        if list(self.bounds) != sorted(self.bounds):
            raise ValueError(f"histogram bounds must ascend: {bounds}")
        self._lock = threading.Lock()
        self._counts = [0] * (len(self.bounds) + 1)
        self._exemplars = [0] * (len(self.bounds) + 1)
        self._count = 0
        self._sum = 0.0
        self._max = 0.0
        self._min = math.inf

    def observe(self, v: float, trace_id: Optional[int] = None) -> None:
        v = float(v)
        i = self._bucket_of(v)
        if trace_id is None:
            from . import tracing

            trace_id = tracing.current_trace_id()
        with self._lock:
            self._counts[i] += 1
            self._count += 1
            self._sum += v
            if v > self._max:
                self._max = v
            if v < self._min:
                self._min = v
            if trace_id:
                self._exemplars[i] = int(trace_id)

    def _bucket_of(self, v: float) -> int:
        lo, hi = 0, len(self.bounds)
        while lo < hi:              # first bound >= v (bisect_left)
            mid = (lo + hi) // 2
            if self.bounds[mid] < v:
                lo = mid + 1
            else:
                hi = mid
        return lo

    def _load(self, count: int, total: float, vmax: float,
              bucket_counts: Iterable[int],
              exemplars: Optional[Iterable[int]] = None) -> None:
        """Replace state wholesale (the native-bridge import path)."""
        counts = [int(c) for c in bucket_counts]
        if len(counts) != len(self.bounds) + 1:
            raise ValueError(
                f"{self.name}: {len(counts)} bucket counts for "
                f"{len(self.bounds)} bounds (+inf)")
        ex = [int(e) for e in exemplars] if exemplars is not None else None
        if ex is not None and len(ex) != len(counts):
            raise ValueError(
                f"{self.name}: {len(ex)} exemplars for {len(counts)} "
                f"buckets")
        with self._lock:
            self._counts = counts
            if ex is not None:
                self._exemplars = ex
            self._count = int(count)
            self._sum = float(total)
            self._max = float(vmax)
            self._min = 0.0 if count else math.inf

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    @property
    def max(self) -> float:
        with self._lock:
            return self._max

    @property
    def mean(self) -> float:
        with self._lock:
            return self._sum / self._count if self._count else 0.0

    def quantile(self, q: float) -> float:
        """Interpolated q-quantile (q in [0, 1]) of the observations."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        with self._lock:
            if self._count == 0:
                return 0.0
            vmin, vmax = self._min, self._max
            target = q * self._count
            cum = 0
            for i, c in enumerate(self._counts):
                if c and cum + c >= target:
                    lo = self.bounds[i - 1] if i > 0 else vmin
                    hi = self.bounds[i] if i < len(self.bounds) else vmax
                    v = lo + (hi - lo) * (target - cum) / c
                    return max(min(v, vmax), vmin)
                cum += c
            return vmax

    def exemplar(self, q: float) -> int:
        """Trace id of the last observation in the bucket holding the
        q-quantile (0 = none recorded there) — the p99→trace link."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        with self._lock:
            if self._count == 0:
                return 0
            target = q * self._count
            cum = 0
            for i, c in enumerate(self._counts):
                if c and cum + c >= target:
                    return self._exemplars[i]
                cum += c
            for i in range(len(self._counts) - 1, -1, -1):
                if self._counts[i]:
                    return self._exemplars[i]
            return 0

    def to_dict(self) -> Dict[str, Any]:
        with self._lock:
            count, total, vmax = self._count, self._sum, self._max
            have_exemplars = any(self._exemplars)
        out = {
            "type": "histogram",
            "count": count,
            "sum": total,
            "max": vmax,
            "mean": total / count if count else 0.0,
            "p50": self.quantile(0.50),
            "p95": self.quantile(0.95),
            "p99": self.quantile(0.99),
        }
        if have_exemplars:
            out["exemplar_p99"] = f"{self.exemplar(0.99):#x}"
        return out


class Registry:
    """Name+labels -> series map; the process-global one is module-level."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._series: Dict[Tuple[str, Tuple[Tuple[str, str], ...]], Any] = {}
        self._per_name: Dict[str, int] = {}
        # Time-series ring: series key -> deque[(ts, value)], capped at
        # history_depth — bounded by construction (one deque per live
        # series, N points each).
        self._history: Dict[str, Any] = {}
        self.history_depth = HISTORY_SNAPSHOTS

    def set_history_depth(self, n: int) -> None:
        """Re-cap every ring to ``n`` points (the ``-metrics_history``
        flag; existing rings keep their newest points)."""
        import collections

        n = max(2, int(n))  # below 2 points rate()/delta() can never answer
        with self._lock:
            self.history_depth = n
            for key, ring in list(self._history.items()):
                if ring.maxlen != n:
                    self._history[key] = collections.deque(ring, maxlen=n)

    def _get(self, cls, name: str, labels: Optional[Dict[str, str]],
             **kwargs: Any):
        key = _label_key(labels)
        overflowed = False
        with self._lock:
            s = self._series.get((name, key))
            if s is not None:
                if not isinstance(s, cls):
                    raise TypeError(
                        f"metric '{name}' already registered as {s.kind}")
                return s
            if key and self._per_name.get(name, 0) >= MAX_SERIES_PER_NAME:
                # Cardinality guard: collapse, don't grow without bound.
                overflowed = True
                dropped = key
                key = _OVERFLOW_LABELS
                s = self._series.get((name, key))
            if s is None:
                s = cls(name, key, **kwargs)
                self._series[(name, key)] = s
                self._per_name[name] = self._per_name.get(name, 0) + 1
        if overflowed:
            # The overflow series alone is a memoryless snapshot — a
            # post-mortem of a cardinality explosion needs the EVENT,
            # so it also lands in the flight-recorder ring (and dumps
            # with the next black box).
            self._note_overflow(name, dropped)
        return s

    @staticmethod
    def _note_overflow(name: str, dropped_key) -> None:
        try:
            from .ops.flight_recorder import recorder

            recorder.record(
                "metric_overflow", name,
                dropped_labels=_series_name("", dropped_key) or "{}",
                cap=MAX_SERIES_PER_NAME)
        except Exception as exc:  # recording must never break a metric
            Log.error("metrics: overflow flight-record failed: %s", exc)

    def counter(self, name: str,
                labels: Optional[Dict[str, str]] = None) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str,
              labels: Optional[Dict[str, str]] = None) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str,
                  labels: Optional[Dict[str, str]] = None,
                  bounds: Iterable[float] = DEFAULT_TIME_BUCKETS
                  ) -> Histogram:
        return self._get(Histogram, name, labels, bounds=bounds)

    def series(self):
        with self._lock:
            return list(self._series.values())

    def remove(self, name: str,
               labels: Optional[Dict[str, str]] = None) -> None:
        key = _label_key(labels)
        with self._lock:
            if self._series.pop((name, key), None) is not None:
                self._per_name[name] = self._per_name.get(name, 1) - 1

    def reset(self) -> None:
        with self._lock:
            self._series.clear()
            self._per_name.clear()
            self._history.clear()

    # -- time-series ring (docs/observability.md, workload plane) --------
    def record_history(self, now: Optional[float] = None) -> int:
        """Append one ``(ts, value)`` point per series to the bounded
        ring (counters/gauges record their value; histograms record
        ``<name>_count`` and ``<name>_sum`` series so both event rates
        and e.g. bytes/s are queryable).  The flush thread calls this
        each interval; tests/tools may call it directly.  Returns the
        number of points recorded."""
        import collections

        ts = time.monotonic() if now is None else float(now)
        points = []
        for s in self.series():
            key = _series_name(s.name, _label_key(s.labels))
            if isinstance(s, Histogram):
                points.append((key + "_count", float(s.count)))
                points.append((key + "_sum", float(s.sum)))
            else:
                points.append((key, float(s.value)))
        with self._lock:
            for key, v in points:
                ring = self._history.get(key)
                if ring is None:
                    ring = collections.deque(maxlen=self.history_depth)
                    self._history[key] = ring
                ring.append((ts, v))
        return len(points)

    def history(self, name: str,
                labels: Optional[Dict[str, str]] = None) -> list:
        """The recorded ``[(ts, value)]`` ring for one series (the
        ``<name>_count`` / ``<name>_sum`` histogram-derived names work
        too — an unlabeled name passes through unchanged)."""
        key = _series_name(name, _label_key(labels))
        with self._lock:
            ring = self._history.get(key)
            return list(ring) if ring else []

    def delta(self, name: str, labels: Optional[Dict[str, str]] = None,
              n: int = 1) -> float:
        """Value change over the last ``n`` recorded intervals (0.0
        with fewer than two points)."""
        pts = self.history(name, labels)
        if len(pts) < 2:
            return 0.0
        lo = max(0, len(pts) - 1 - max(1, int(n)))
        return pts[-1][1] - pts[lo][1]

    def rate(self, name: str, labels: Optional[Dict[str, str]] = None,
             window_s: Optional[float] = None) -> Optional[float]:
        """Per-second rate over the recorded window: (last - first)
        / elapsed, where "first" is the oldest point inside
        ``window_s`` (or the whole ring).  ``None`` with fewer than
        two recorded points (or zero elapsed): before the second
        flush there IS no rate yet — histogram ``_count``/``_sum``
        series included — and returning 0.0 made a fresh scrape
        indistinguishable from genuinely zero traffic (the mvtop
        "dead shard" misread).  Renderers print ``-`` for ``None``.
        A counter that recorded twice without moving is still a true
        0.0 — that IS zero traffic."""
        pts = self.history(name, labels)
        if len(pts) < 2:
            return None
        t_last, v_last = pts[-1]
        first = pts[0]
        if window_s is not None:
            for p in pts:
                if t_last - p[0] <= window_s:
                    first = p
                    break
        t_first, v_first = first
        if t_last <= t_first:
            return None
        return (v_last - v_first) / (t_last - t_first)

    def snapshot(self) -> Dict[str, Dict[str, Any]]:
        """Every series as plain data, keyed ``name`` or ``name{k="v"}``."""
        out: Dict[str, Dict[str, Any]] = {}
        for s in self.series():
            out[_series_name(s.name, _label_key(s.labels))] = s.to_dict()
        return out

    def render_prometheus(self, exemplars: bool = False) -> str:
        """Prometheus text exposition (histograms with cumulative
        ``_bucket{le=...}`` plus ``_sum``/``_count``).  With
        ``exemplars=True``, bucket lines carry their last trace id in
        OpenMetrics exemplar form (`` # {trace_id="0x..."} <le>``) —
        off by default because plain-Prometheus parsers reject it."""
        lines = []
        by_name: Dict[str, list] = {}
        for s in self.series():
            by_name.setdefault(s.name, []).append(s)
        for name in sorted(by_name):
            group = by_name[name]
            pname = _prom_name(name)
            lines.append(f"# TYPE {pname} {group[0].kind}")
            for s in sorted(group, key=lambda x: _label_key(x.labels)):
                key = _label_key(s.labels)
                if isinstance(s, Histogram):
                    with s._lock:
                        counts = list(s._counts)
                        exs = list(s._exemplars)
                        total, count = s._sum, s._count

                    def _ex(i: int, le: float) -> str:
                        if not exemplars or not exs[i]:
                            return ""
                        return (f' # {{trace_id="{exs[i]:#x}"}}'
                                f' {_fmt(le)}')

                    cum = 0
                    for i, (bound, c) in enumerate(zip(s.bounds, counts)):
                        cum += c
                        lines.append(
                            f"{pname}_bucket"
                            f"{_prom_labels(key, le=_fmt(bound))} {cum}"
                            f"{_ex(i, bound)}")
                    cum += counts[-1]
                    lines.append(
                        f"{pname}_bucket{_prom_labels(key, le='+Inf')} "
                        f"{cum}"
                        f"{_ex(len(counts) - 1, s.bounds[-1] if s.bounds else 0.0)}")
                    lines.append(
                        f"{pname}_sum{_prom_labels(key)} {_fmt(total)}")
                    lines.append(
                        f"{pname}_count{_prom_labels(key)} {count}")
                else:
                    lines.append(
                        f"{pname}{_prom_labels(key)} {_fmt(s.value)}")
        return "\n".join(lines) + "\n"


def _prom_name(name: str) -> str:
    out = []
    for i, ch in enumerate(name):
        ok = ch.isalnum() and ch.isascii() or ch in "_:"
        if ok and ch.isdigit() and i == 0:
            ok = False
        out.append(ch if ok else "_")
    return "".join(out)


def _prom_escape(v: str) -> str:
    """Label-value escaping per the exposition format: backslash, quote
    and newline are the three characters the format reserves."""
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _prom_labels(key: Tuple[Tuple[str, str], ...], **extra: str) -> str:
    items = list(key) + sorted(extra.items())
    if not items:
        return ""
    return ("{" + ",".join(f'{_prom_name(k)}="{_prom_escape(v)}"'
                           for k, v in items) + "}")


def _fmt(v: float) -> str:
    return repr(float(v))


# ---------------------------------------------------------------------------
# Process-global registry + module-level convenience surface.
# ---------------------------------------------------------------------------

REGISTRY = Registry()


def counter(name: str, labels: Optional[Dict[str, str]] = None) -> Counter:
    return REGISTRY.counter(name, labels)


def gauge(name: str, labels: Optional[Dict[str, str]] = None) -> Gauge:
    return REGISTRY.gauge(name, labels)


def histogram(name: str, labels: Optional[Dict[str, str]] = None,
              bounds: Iterable[float] = DEFAULT_TIME_BUCKETS) -> Histogram:
    return REGISTRY.histogram(name, labels, bounds)


def snapshot() -> Dict[str, Dict[str, Any]]:
    return REGISTRY.snapshot()


def render_prometheus(exemplars: bool = False) -> str:
    return REGISTRY.render_prometheus(exemplars=exemplars)


def record_history(now: Optional[float] = None) -> int:
    """Take one time-series snapshot of every series (see
    :meth:`Registry.record_history`); the flush thread does this each
    interval automatically."""
    return REGISTRY.record_history(now)


def rate(name: str, labels: Optional[Dict[str, str]] = None,
         window_s: Optional[float] = None) -> Optional[float]:
    """Per-second rate of a series over the recorded history window
    (``None`` until two snapshots exist — a fresh scrape must never
    read as "zero traffic")."""
    return REGISTRY.rate(name, labels, window_s)


def delta(name: str, labels: Optional[Dict[str, str]] = None,
          n: int = 1) -> float:
    """Value change over the last ``n`` recorded intervals."""
    return REGISTRY.delta(name, labels, n)


def history(name: str, labels: Optional[Dict[str, str]] = None) -> list:
    """The recorded ``[(ts, value)]`` ring for one series."""
    return REGISTRY.history(name, labels)


def reset() -> None:
    """Drop every series AND stop the flush thread (test isolation);
    flush hooks (the health plane's evaluator) are dropped too and the
    ring depth returns to the default."""
    stop_flush()
    set_ops_push(None)
    with _HOOK_LOCK:
        _FLUSH_HOOKS.clear()
    REGISTRY.reset()
    REGISTRY.history_depth = HISTORY_SNAPSHOTS


def set_history_depth(n: int) -> None:
    """Re-cap the time-series rings to ``n`` points (the
    ``-metrics_history`` flag).  The ring spans flush-interval x depth
    of wall time; health-rule windows longer than that never fire."""
    REGISTRY.set_history_depth(n)


# ---------------------------------------------------------------------------
# Native bridge: ALL Dashboard monitors in one MV_DumpMonitors call.
# ---------------------------------------------------------------------------

def parse_native_dump(text: str) -> Dict[str, tuple]:
    """Parse ``MV_DumpMonitors`` text → {name: (count, total, max,
    bucket_counts[, exemplars])} (wire format documented in c_api.h).
    The trailing per-bucket exemplar trace ids are optional — a
    pre-exemplar dump yields 4-tuples, a current one 5-tuples."""
    out = {}
    for line in text.splitlines():
        if not line.strip():
            continue
        fields = line.split("\t")
        name, count, total, vmax, buckets = fields[:5]
        parsed = (int(count), float(total), float(vmax),
                  tuple(int(b) for b in buckets.split(",")))
        if len(fields) > 5:
            parsed += (tuple(int(e) for e in fields[5].split(",")),)
        out[name] = parsed
    return out


def bridge_native(runtime: Any, prefix: str = "native.") -> int:
    """Import every native Dashboard monitor into the registry as a
    ``<prefix><name>`` histogram (absolute state, so re-bridging after
    more native work just refreshes).  ``runtime`` is a
    ``native.NativeRuntime`` (anything with ``dump_monitors()``; a
    ``dead_peer_count()`` rides along as a gauge when present).
    Returns the number of monitors bridged.
    """
    dump = runtime.dump_monitors()
    n = 0
    for name, item in dump.items():
        count, total, vmax, buckets = item[:4]
        exemplars = item[4] if len(item) > 4 else None
        h = REGISTRY.histogram(prefix + name, bounds=NATIVE_TIME_BUCKETS)
        h._load(count, total, vmax, buckets, exemplars)
        n += 1
        # Wire-byte observability parity (docs/wire_compression.md):
        # the native transport ledgers record 1 unit = 1 byte with
        # count = frames, so they land as the same labelled counters
        # the Python io layer uses (io.bytes{dir=...} -> net.bytes).
        if name in ("net.bytes.sent", "net.bytes.recv"):
            direction = name.rsplit(".", 1)[1]
            REGISTRY.counter("net.bytes", {"dir": direction})._load(total)
            REGISTRY.counter("net.msgs", {"dir": direction})._load(count)
    dead = getattr(runtime, "dead_peer_count", None)
    if dead is not None:
        REGISTRY.gauge(prefix + "dead_peers").set(float(dead()))
    return n


# ---------------------------------------------------------------------------
# Periodic flush thread (gated by -metrics_flush_ms / -trace_dir).
# ---------------------------------------------------------------------------

_FLUSH_LOCK = threading.Lock()
_FLUSHER: Optional["_Flusher"] = None
# Optional per-flush push target (docs/observability.md): the native ops
# plane's MV_SetOpsHostMetrics, so in-band wire scrapes serve THIS
# registry's rendering (exemplars included) instead of the native-only
# fallback.  Set via set_ops_push(rt.set_ops_host_metrics).
_PUSH_FN = None


def set_ops_push(fn) -> None:
    """Register ``fn(prom_text)`` to receive the exemplar-annotated
    Prometheus rendering on every flush (``None`` disarms).  Wire it to
    ``NativeRuntime.set_ops_host_metrics`` so anonymous OpsQuery scrapes
    serve the full registry."""
    global _PUSH_FN
    _PUSH_FN = fn


# Flush hooks run on the flush thread each interval, AFTER the history
# point is recorded and BEFORE the render/push — so a hook that derives
# new series from the rings (the health plane's alert gauges) lands them
# in the SAME flush the evidence came from.  Hooks are individually
# fenced: one raising never kills the flusher or the other hooks.
# Own lock, NOT _FLUSH_LOCK: start_flush() joins the old flusher while
# holding _FLUSH_LOCK, and that flusher may be mid-hook.
_HOOK_LOCK = threading.Lock()
_FLUSH_HOOKS: list = []


def add_flush_hook(fn) -> None:
    """Register ``fn()`` to run on every metrics flush (idempotent)."""
    with _HOOK_LOCK:
        if fn not in _FLUSH_HOOKS:
            _FLUSH_HOOKS.append(fn)


def remove_flush_hook(fn) -> None:
    """Unregister a flush hook (missing is a no-op)."""
    with _HOOK_LOCK:
        try:
            _FLUSH_HOOKS.remove(fn)
        except ValueError:
            pass


def _run_flush_hooks() -> None:
    with _HOOK_LOCK:
        hooks = list(_FLUSH_HOOKS)
    for fn in hooks:
        try:
            fn()
        except Exception as exc:
            Log.error("metrics flush hook %r failed: %s", fn, exc)


class _Flusher(threading.Thread):
    def __init__(self, interval_s: float, path: Optional[str]):
        super().__init__(name="mvtpu-metrics-flush", daemon=True)
        self.interval_s = interval_s
        self.path = path
        self._stop_evt = threading.Event()

    def run(self) -> None:
        while not self._stop_evt.wait(self.interval_s):
            self.flush_once()

    def flush_once(self) -> None:
        try:
            # Capacity plane (docs/observability.md): land every
            # registered Python byte gauge as a capacity.<name> Gauge
            # BEFORE the history point / render, so serve-cache bytes
            # ride the same scrape (and time-series ring) as every
            # other series.
            from . import capacity as _capacity

            _capacity.export_gauges()
            # One time-series point per flush: the ring holds the last
            # history_depth flush snapshots, so rate()/delta() span
            # roughly interval_s * depth of history.
            record_history()
            # Hooks (the health plane's rule evaluation) run between
            # the history point and the render, so derived series are
            # current in the same exposition they were computed from.
            _run_flush_hooks()
            if self.path:
                from .io.stream import LocalStream

                with LocalStream(self.path, "wb", atomic=True) as s:
                    s.write(render_prometheus().encode())
            else:
                snap = snapshot()
                Log.debug("metrics flush: %d series", len(snap))
            push = _PUSH_FN
            if push is not None:
                push(render_prometheus(exemplars=True))
        except Exception as exc:  # a flush must never kill training
            Log.error("metrics flush failed: %s", exc)

    def stop(self) -> None:
        self._stop_evt.set()


def start_flush(interval_ms: int, path: Optional[str] = None) -> None:
    """Start (or retarget) the periodic exporter: every ``interval_ms``
    the registry is rendered to ``path`` (Prometheus text, atomic
    replace) or, with no path, summarized to the debug log.  The
    previous flusher (if any) is stopped AND JOINED before the new one
    starts — two live flushers would interleave writes to the same
    ``metrics_rank<r>.prom``."""
    global _FLUSHER
    if interval_ms <= 0:
        return
    with _FLUSH_LOCK:
        if _FLUSHER is not None:
            _FLUSHER.stop()
            _FLUSHER.join(timeout=5.0)
            if _FLUSHER.is_alive():
                Log.error("metrics flush: previous flusher still alive "
                          "after 5s; retargeting anyway")
        _FLUSHER = _Flusher(interval_ms / 1e3, path)
        _FLUSHER.start()


def stop_flush(final_flush: bool = True) -> None:
    """Stop the exporter.  The thread is JOINED before the final flush
    runs on the caller: shutdown's last ``snapshot()``/render must never
    interleave with a flusher mid-write of ``metrics_rank<r>.prom`` (the
    teardown race) — if the join times out, the final flush is
    SKIPPED and the error logged rather than racing the straggler."""
    global _FLUSHER
    with _FLUSH_LOCK:
        f, _FLUSHER = _FLUSHER, None
    if f is not None:
        f.stop()
        f.join(timeout=5.0)
        if f.is_alive():
            Log.error("metrics flush: flusher did not stop within 5s; "
                      "skipping the final flush to avoid interleaving")
            return
        if final_flush:
            f.flush_once()


# Convenience timer mirroring dashboard.monitor but registry-native:
#   with metrics.timed("io.open", {"scheme": "file"}): ...
class timed:
    def __init__(self, name: str, labels: Optional[Dict[str, str]] = None):
        self._h = histogram(name, labels)

    def __enter__(self) -> "timed":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc: Any) -> None:
        self._h.observe(time.perf_counter() - self._t0)
