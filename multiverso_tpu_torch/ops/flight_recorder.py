"""Flight recorder ("black box") — the Python half of the bounded
in-memory failure ring (docs/observability.md).

The native runtime keeps its own ring (``mvtpu/ops.cc``) and dumps it on
native triggers (barrier timeout, dead peer detected, shed storm).  This
module is the SPMD/JAX-plane twin: lifecycle events, metric deltas, and
recent spans accumulate in a bounded ring, and a failure trigger
(:class:`~multiverso_tpu_torch.core.context.BarrierTimeout`,
:class:`~multiverso_tpu_torch.checkpoint.CheckpointCorrupt`, or anything the
caller deems fatal) dumps ``<trace_dir>/blackbox_rank<r>.json`` — the
same schema as the native dump, so one post-mortem reader serves both
planes, and the spans inside correlate by trace id with the surviving
ranks' exported Chrome traces.

Recording is always on (one deque append); the dump happens only when a
trigger fires AND ``-trace_dir`` is set.  When a
:class:`~multiverso_tpu_torch.native.NativeRuntime` is attached, its span ring
rides along in the dump so one file holds both planes.
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
from typing import Any, Dict, Optional

from ..log import Log

__all__ = ["FlightRecorder", "recorder"]

_DEFAULT_EVENTS = 512


class FlightRecorder:
    """Bounded event ring + trigger-time dump."""

    def __init__(self, max_events: int = _DEFAULT_EVENTS):
        self._lock = threading.Lock()
        self._events: "collections.deque" = collections.deque(
            maxlen=max_events)
        self._runtime: Any = None
        self._triggers = 0
        # Dump-rotation ledger: retained timestamped archive names (the
        # canonical blackbox_rank<r>.json stays the LATEST dump).
        self._archives: list = []
        self._dump_seq = 0
        self.rank = 0

    # ------------------------------------------------------------ wiring
    def attach(self, runtime: Any = None,
               rank: Optional[int] = None) -> None:
        """Attach a ``NativeRuntime`` (its spans join the dump) and/or
        pin the rank used in the dump filename."""
        with self._lock:
            if runtime is not None:
                self._runtime = runtime
            if rank is not None:
                self.rank = int(rank)

    # ---------------------------------------------------------- recording
    def record(self, kind: str, detail: str = "",
               **fields: Any) -> None:
        """Append one event (always on; bounded ring — newest win)."""
        ev = {"ts_us": int(time.time() * 1e6), "kind": str(kind),
              "detail": str(detail)}
        if fields:
            ev.update({k: v for k, v in fields.items()})
        with self._lock:
            self._events.append(ev)

    def record_metric_delta(self, name: str, value: float) -> None:
        """A metric observation worth keeping in the black box (queue
        spikes, shed bursts) — same ring, typed kind."""
        self.record("metric", name, value=float(value))

    @property
    def triggers(self) -> int:
        with self._lock:
            return self._triggers

    def events(self):
        with self._lock:
            return list(self._events)

    def reset(self) -> None:
        with self._lock:
            self._events.clear()
            self._runtime = None
            self._triggers = 0
            # Forget the rotation ledger (files on disk stay); the dump
            # counter keeps counting so archive names never collide.
            self._archives = []

    # ------------------------------------------------------------ trigger
    def trigger(self, reason: str) -> Optional[str]:
        """Failure trigger: dump ring + recent spans + metrics snapshot
        to ``<trace_dir>/blackbox_rank<r>.json``.  Returns the path, or
        ``None`` when no ``-trace_dir`` is configured (the event still
        lands in the ring).  Never raises — a broken dump must not mask
        the failure that triggered it."""
        self.record("trigger", reason)
        with self._lock:
            self._triggers += 1
            runtime = self._runtime
            rank = self.rank
        try:
            from .. import config, metrics, tracing

            trace_dir = str(config.get("trace_dir"))
            if not trace_dir:
                return None
            os.makedirs(trace_dir, exist_ok=True)

            spans = [{
                "name": e.name,
                "trace_id": f"{e.trace_id:#x}",
                "ts": e.ts_us,
                "dur": e.dur_us,
                "pid": e.pid,
                "tid": e.tid,
            } for e in tracing.events()[-2048:]]
            if runtime is not None:
                try:
                    for e in tracing.parse_native_spans(
                            runtime.dump_spans()):
                        spans.append({
                            "name": e.name,
                            "trace_id": f"{e.trace_id:#x}",
                            "ts": e.ts_us,
                            "dur": e.dur_us,
                            "pid": e.pid,
                            "tid": e.tid,
                        })
                except Exception as exc:
                    Log.error("flight recorder: native span dump "
                              "failed: %s", exc)

            doc: Dict[str, Any] = {
                "reason": reason,
                "rank": rank,
                "ts_us": int(time.time() * 1e6),
                "plane": "python",
                "events": self.events(),
                "spans": spans,
                "metrics": metrics.snapshot(),
            }
            path = os.path.join(trace_dir, f"blackbox_rank{rank}.json")
            tmp = path + ".tmp"
            with open(tmp, "w") as fh:
                json.dump(doc, fh)
            os.replace(tmp, path)
            self._rotate(trace_dir, rank, doc)
            Log.error("flight recorder: dumped black box to %s "
                      "(reason: %s)", path, reason)
            return path
        except Exception as exc:
            Log.error("flight recorder: dump failed: %s", exc)
            return None

    def _rotate(self, trace_dir: str, rank: int, doc: Dict[str, Any],
                keep: Optional[int] = None) -> None:
        """Archive this dump beside the canonical file and prune to the
        last N (``-blackbox_keep``): a second trigger on the same rank
        keeps the first dump's evidence instead of overwriting it.  The
        manifest lists the retained archives, oldest first."""
        from .. import config

        if keep is None:
            try:
                keep = int(config.get("blackbox_keep"))
            except Exception:
                keep = 4
        keep = max(1, keep)
        with self._lock:
            self._dump_seq += 1
            # ts + per-process seq: two triggers in the same
            # microsecond still get distinct archive names.
            name = (f"blackbox_rank{rank}."
                    f"{int(time.time() * 1e6)}.{self._dump_seq}.json")
            self._archives.append(name)
            drop, self._archives = (self._archives[:-keep],
                                    self._archives[-keep:])
            archives = list(self._archives)
            seq = self._dump_seq
        with open(os.path.join(trace_dir, name), "w") as fh:
            json.dump(doc, fh)
        for old in drop:
            try:
                os.remove(os.path.join(trace_dir, old))
            except OSError:
                pass  # already gone: rotation is best-effort cleanup
        manifest = {"rank": rank, "keep": keep, "dumps": archives,
                    "total_triggers": seq}
        mpath = os.path.join(trace_dir,
                             f"blackbox_rank{rank}.manifest.json")
        tmp = mpath + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(manifest, fh)
        os.replace(tmp, mpath)


# Process-global recorder: the trigger sites (context barrier timeout,
# checkpoint corruption) record here without plumbing an instance.
recorder = FlightRecorder()
