"""Spans & trace export (docs/observability.md).

Cross-rank, cross-plane tracing for the push-pull path: a worker-side
``Get()``/``Add()``, the wire hop that carried it, and the server-side
apply all share one **trace id**, so a merged timeline answers *where
time went* across the Python/native/wire boundaries.

Three pieces:

- **Python spans** — :func:`span` is a context manager recording a
  wall-clock span into a bounded in-process buffer; ``dashboard``
  monitors emit spans automatically when tracing is on, so every table
  op / barrier / jitted step shows up without new call sites.  Trace
  ids are thread-local: nested spans share the outermost id (mirroring
  the native ``Monitor`` contract in ``mvtpu/dashboard.h``).
- **Native spans** — the C runtime records the same span shape
  (``MV_DumpSpans``; ids propagate through message headers across
  ranks).  :func:`add_native_spans` folds a dump into this buffer so
  one export holds both planes.
- **Export** — :func:`save` writes Chrome trace-event JSON (load it in
  Perfetto / ``chrome://tracing``); :func:`merge_dir` merges per-rank
  files into one timeline (timestamps are wall-clock µs, so same-host
  ranks line up).  ``torch.profiler`` capture stays available through
  ``dashboard.start_trace`` for kernel-level depth — this layer is the
  cheap always-on complement.

Two clocks.  The buffer's spans are on the wall clock (``time.time()``),
which is what lines ranks up in a merge, and no device trace shares it.
While a ``torch.profiler`` capture runs (``dashboard.start_trace`` or
any ``torch.profiler.profile``), :func:`span` also opens
``torch.profiler.record_function`` around its body, whether or not the
buffer is armed: the span then lands in the capture as a
``user_annotation`` on the profiler's own clock, beside the kernels it
launched.  With the buffer off and no capture running, a span is a flag
check and a profiler check and enters nothing.

Enable with the ``-trace_dir=<dir>`` flag (``init()`` arms it and
``shutdown()`` writes ``trace_rank<r>.json``), or programmatically with
:func:`enable`.
"""

from __future__ import annotations

import collections
import json
import os
import sys
import threading
import time
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional

from .log import Log

__all__ = [
    "SpanEvent", "enabled", "enable", "disable", "span", "record_span",
    "current_trace_id", "set_trace_id", "new_trace_id", "events",
    "clear", "to_chrome", "save", "merge_dir", "add_native_spans",
    "parse_native_spans", "default_trace_path",
]

# Bounded buffer: a long run must not grow without limit; newest win.
_MAX_EVENTS = 100_000

_LOCK = threading.Lock()
_EVENTS: "collections.deque[SpanEvent]" = collections.deque(
    maxlen=_MAX_EVENTS)
_ENABLED = False
_RANK = 0
_SEQ = 0
_TLS = threading.local()


@dataclass
class SpanEvent:
    """One complete ('X'-phase) span."""

    name: str
    trace_id: int
    ts_us: int            # wall-clock start, µs (merges across ranks)
    dur_us: int
    pid: int              # rank
    tid: int              # thread id (hash for native threads)
    args: Dict[str, Any] = field(default_factory=dict)


def enabled() -> bool:
    return _ENABLED


def enable(rank: Optional[int] = None) -> None:
    """Arm span recording (idempotent).  ``rank`` salts trace ids so two
    ranks never mint the same id and labels the pid lane of exports."""
    global _ENABLED, _RANK
    with _LOCK:
        if rank is not None:
            _RANK = int(rank)
        _ENABLED = True


def disable() -> None:
    global _ENABLED
    with _LOCK:
        _ENABLED = False


def clear() -> None:
    with _LOCK:
        _EVENTS.clear()


def new_trace_id() -> int:
    """Fresh id with the rank salt in the high bits (the same layout the
    native plane uses, so merged traces cannot collide)."""
    global _SEQ
    with _LOCK:
        _SEQ += 1
        return ((_RANK + 1) << 40) | _SEQ


def current_trace_id() -> int:
    """This thread's active trace id (0 = none)."""
    return getattr(_TLS, "trace_id", 0)


def set_trace_id(trace_id: int) -> None:
    _TLS.trace_id = int(trace_id)


def record_span(name: str, ts_us: int, dur_us: int,
                trace_id: Optional[int] = None,
                args: Optional[Dict[str, Any]] = None) -> None:
    """Append one finished span (no-op when tracing is off)."""
    if not _ENABLED:
        return
    tid = trace_id if trace_id is not None else current_trace_id()
    ev = SpanEvent(name=name, trace_id=int(tid), ts_us=int(ts_us),
                   dur_us=int(dur_us), pid=_RANK,
                   tid=threading.get_ident() & 0xFFFF,
                   args=dict(args or {}))
    with _LOCK:
        _EVENTS.append(ev)


def _profiling() -> bool:
    """A ``torch.profiler`` capture is running in this process (with no
    torch loaded, none can be)."""
    torch = sys.modules.get("torch")
    return torch is not None and torch.autograd._profiler_enabled()


@contextmanager
def span(name: str, trace_id: Optional[int] = None,
         **args: Any) -> Iterator[int]:
    """``with tracing.span("Worker::Get", table="w"):`` — times the body
    and records a span.  Yields the trace id in effect (0 when tracing
    is off) so callers can stamp it into native calls
    (``NativeRuntime.set_trace_id``) or log lines.  Nested spans share
    the outermost id; an explicit ``trace_id`` pins it.  Under a running
    ``torch.profiler`` capture the body also runs inside
    ``record_function(name)`` (the module's "Two clocks").
    """
    profiling = _profiling()
    if not _ENABLED and not profiling:
        yield 0
        return
    import torch

    with (torch.profiler.record_function(name) if profiling
          else nullcontext()):
        if not _ENABLED:
            yield 0
            return
        prev = current_trace_id()
        tid = int(trace_id) if trace_id else (prev or new_trace_id())
        set_trace_id(tid)
        ts = time.time()
        t0 = time.perf_counter()
        try:
            yield tid
        finally:
            dur = time.perf_counter() - t0
            set_trace_id(prev)
            record_span(name, int(ts * 1e6), int(dur * 1e6), trace_id=tid,
                        args=args)


def events() -> List[SpanEvent]:
    with _LOCK:
        return list(_EVENTS)


# ---------------------------------------------------------------------------
# Native span import (MV_DumpSpans wire format; see c_api.h).
# ---------------------------------------------------------------------------

def parse_native_spans(text: str) -> List[SpanEvent]:
    """``name\\ttrace_id\\tts_us\\tdur_us\\trank\\ttid`` lines → events."""
    out = []
    for line in text.splitlines():
        if not line.strip():
            continue
        name, trace_id, ts_us, dur_us, rank, tid = line.split("\t")
        out.append(SpanEvent(
            name=name, trace_id=int(trace_id), ts_us=int(ts_us),
            dur_us=int(dur_us), pid=int(rank), tid=int(tid) & 0xFFFF,
            args={"plane": "native"}))
    return out


def add_native_spans(runtime: Any) -> int:
    """Fold a ``NativeRuntime``'s recorded spans into this buffer (so one
    :func:`save` exports both planes).  Returns the span count."""
    spans = parse_native_spans(runtime.dump_spans())
    with _LOCK:
        _EVENTS.extend(spans)
    return len(spans)


# ---------------------------------------------------------------------------
# Chrome trace-event export.
# ---------------------------------------------------------------------------

def to_chrome(evts: Optional[List[SpanEvent]] = None) -> Dict[str, Any]:
    """Chrome trace-event JSON object (Perfetto / chrome://tracing)."""
    if evts is None:
        evts = events()
    trace_events = []
    for e in evts:
        args = dict(e.args)
        if e.trace_id:
            args["trace_id"] = f"{e.trace_id:#x}"
        trace_events.append({
            "name": e.name,
            "ph": "X",
            "ts": e.ts_us,
            "dur": e.dur_us,
            "pid": e.pid,
            "tid": e.tid,
            "args": args,
        })
    return {"traceEvents": trace_events, "displayTimeUnit": "ms"}


def default_trace_path(trace_dir: str, rank: Optional[int] = None) -> str:
    return os.path.join(trace_dir,
                        f"trace_rank{_RANK if rank is None else rank}.json")


def save(path: str, evts: Optional[List[SpanEvent]] = None) -> int:
    """Write the buffer (or ``evts``) as Chrome trace JSON; returns the
    event count.  Atomic replace so a crash mid-write never leaves a
    truncated file where a merge step expects JSON."""
    from .io.stream import LocalStream

    doc = to_chrome(evts)
    with LocalStream(path, "wb", atomic=True) as s:
        s.write(json.dumps(doc).encode())
    Log.debug("tracing: wrote %d span(s) to %s",
              len(doc["traceEvents"]), path)
    return len(doc["traceEvents"])


def merge_dir(trace_dir: str, out_name: str = "trace_merged.json") -> str:
    """Merge every ``trace_rank*.json`` (and any other ``*.json`` trace
    except a previous merge) in ``trace_dir`` into one Chrome trace;
    returns the merged file path.

    A truncated / mid-write / otherwise unparseable per-rank file is
    SKIPPED with a warning (and a synthetic ``trace_merge_skipped``
    metadata event naming it in the merged output) instead of raising:
    the flight recorder dumps while ranks are being SIGKILLed, and one
    corpse's half-written JSON must not cost the post-mortem every
    surviving rank's timeline."""
    merged: List[Dict[str, Any]] = []
    skipped: List[str] = []
    for name in sorted(os.listdir(trace_dir)):
        if not name.endswith(".json") or name == out_name:
            continue
        try:
            with open(os.path.join(trace_dir, name), "rb") as f:
                doc = json.load(f)
            events = doc.get("traceEvents", [])
            if not isinstance(events, list):
                raise ValueError("traceEvents is not a list")
        except (OSError, ValueError) as exc:
            # json.JSONDecodeError is a ValueError: truncated file,
            # interleaved partial write, or non-trace JSON all land here.
            Log.error("tracing.merge_dir: skipping unreadable %s (%s)",
                      name, exc)
            skipped.append(name)
            continue
        merged.extend(events)
    for name in skipped:
        merged.append({"name": "trace_merge_skipped", "ph": "i",
                       "ts": 0, "pid": -1, "tid": 0, "s": "g",
                       "args": {"file": name,
                                "why": "unparseable (truncated or "
                                       "mid-write)"}})
    merged.sort(key=lambda e: e.get("ts", 0))
    out_path = os.path.join(trace_dir, out_name)
    from .io.stream import LocalStream

    with LocalStream(out_path, "wb", atomic=True) as s:
        s.write(json.dumps({"traceEvents": merged,
                            "displayTimeUnit": "ms"}).encode())
    return out_path
