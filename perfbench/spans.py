"""Device time under the program's phase spans, from a ``torch.profiler``
trace of a cell's traced window.

    python3 perfbench/spans.py --workload <cell> --seed <n>

The port's ``tracing.span`` opens ``record_function`` while a capture
runs, so each phase of a step (``Transformer::forward``,
``SkipGram::scatter``, ...) is a ``user_annotation`` event on the
trace's clock, beside the kernels.  From the exported Chrome trace this
takes, inside the ``bench.window`` span:

- for each annotation name, the device seconds of the kernels, copies
  and fills whose launch lies inside one of that name's intervals.  The
  launch is matched on any thread of the process, not only the span's:
  autograd launches the backward's kernels from its device thread while
  the calling thread waits inside ``Transformer::backward``;
- ``span_check``: the share of the busy device time launched inside the
  cell's phase spans;
- ``span_gaps``: the longest idle gaps, each with the phase span and the
  step open at its middle.

The command runs the cell's set-up and its traced window through the
cell's driver, as ``run.py --trace 1`` does (no check, no reference),
and prints one JSON line: these readings, the readers of
``metrics/train_*`` and ``metrics/w2v_*`` that read them, and the
trace's busy and window seconds.  ``run.py`` does not call it:
``BENCHMARK.json`` lists none of those metrics yet.
"""

from __future__ import annotations

import argparse
import bisect
import contextlib
import importlib
import json
import os
import sys
import tempfile
import time
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from perfbench import common  # noqa: E402
from perfbench import trace as trace_mod  # noqa: E402

# Each step's span, and the phase spans that together hold its ops.
STEP = {"train": "Transformer::train_step_async", "w2v": "SkipGram::step"}
PHASES = {
    "train": ("Transformer::forward", "Transformer::backward",
              "Transformer::grad_sync", "Transformer::update"),
    "w2v": ("SkipGram::gather", "SkipGram::sgns", "SkipGram::scatter"),
}
# The metrics that read them (``metrics/<name>.py``).
READERS = {
    "train": ("train_forward_ms", "train_backward_ms", "train_update_ms",
              "train_update_hbm"),
    "w2v": ("w2v_gather_ms", "w2v_sgns_ms", "w2v_scatter_ms",
            "w2v_scatter_hbm"),
}
UPDATE_BYTES = "trainer.update_bytes"

Interval = Tuple[float, float]


def _window(events: List[dict]) -> Interval:
    for e in events:
        if e.get("ph") == "X" and e.get("name") == trace_mod.WINDOW:
            return float(e["ts"]), float(e["ts"]) + float(e["dur"])
    raise ValueError(f"the trace holds no '{trace_mod.WINDOW}' span")


def annotations(events: List[dict]) -> Dict[str, List[Interval]]:
    """Each ``user_annotation`` name but the window's: its intervals
    (µs), merged, on every thread."""
    out: Dict[str, List[Interval]] = defaultdict(list)
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation" \
                and e.get("name") != trace_mod.WINDOW:
            a = float(e["ts"])
            out[e["name"]].append((a, a + float(e["dur"])))
    return {n: trace_mod._union(s) for n, s in out.items()}


def device_ops(events: List[dict]) -> List[Tuple[float, float,
                                                 Optional[float]]]:
    """Every kernel, copy and fill in the window: (start, end) clipped to
    it, in µs, and the start of its launch (None when the trace lost
    it)."""
    w0, w1 = _window(events)
    launches = {e["args"]["correlation"]: float(e["ts"]) for e in events
                if e.get("ph") == "X" and e.get("cat") in
                trace_mod.LAUNCH_CATS
                and "correlation" in e.get("args", {})}
    out = []
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in trace_mod.DEVICE_CATS:
            continue
        ts, dur = float(e["ts"]), float(e["dur"])
        if ts + dur < w0 or ts > w1:
            continue
        out.append((max(ts, w0), min(ts + dur, w1),
                    launches.get(e.get("args", {}).get("correlation"))))
    return out


class _Spans:
    """One name's merged intervals, for "is ``t`` inside one of them"."""

    def __init__(self, intervals: List[Interval]):
        self.intervals = intervals
        self.starts = [a for a, _ in intervals]

    def __contains__(self, t: Optional[float]) -> bool:
        return t is not None and trace_mod._inside(self.intervals,
                                                   self.starts, t)


def _spans(events: List[dict]) -> Dict[str, _Spans]:
    return {n: _Spans(s) for n, s in annotations(events).items()}


def span_device_s(events: List[dict]) -> Dict[str, float]:
    """Each annotation name (the window's aside): the device seconds of
    the window's kernels, copies and fills launched inside it."""
    ops = device_ops(events)
    return {name: sum(b - a for a, b, t in ops if t in spans) * 1e-6
            for name, spans in _spans(events).items()}


def span_check(events: List[dict], names: Sequence[str]) -> float:
    """The share (%) of the window's busy device time launched inside
    any of ``names``' spans (0 with no busy time)."""
    spans = [s for n, s in _spans(events).items() if n in names]
    ops = device_ops(events)
    busy = _length(trace_mod._union([(a, b) for a, b, _ in ops]))
    covered = _length(trace_mod._union([
        (a, b) for a, b, t in ops if any(t in s for s in spans)]))
    return 100.0 * covered / busy if busy > 0 else 0.0


def phase_seconds(ctx, kind: str, span: str) -> Optional[float]:
    """For a reader (``metrics/<name>.py``): the device seconds under
    ``span`` over the traced steps (``ctx.span_s``), or None where the
    cell is not of ``kind``, the context has no steps or the trace has no
    device time under that span (the parent's trace has no such span):
    never 0."""
    if ctx.kind != kind or not ctx.span_s or not ctx.steps:
        return None
    spent = ctx.span_s.get(span, 0.0)
    return spent if spent > 0 else None


def _length(intervals: List[Interval]) -> float:
    return sum(b - a for a, b in intervals)


def span_gaps(events: List[dict], phases: Sequence[str], step: str,
              top: int = 10) -> List[dict]:
    """The ``top`` longest idle gaps of the window, longest first: each
    gap's ms, the phase span open at its middle (the step's own span if
    it is open there and no phase is, else "none"), the step (1 for the
    window's first; 0 before it) that began last before the middle, and
    the innermost host span open then, as ``run.py``'s breakdown names
    it."""
    w0, w1 = _window(events)
    busy = trace_mod._union([(a, b) for a, b, _ in device_ops(events)])
    edges = [w0] + [x for span in busy for x in span] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    gaps.sort(key=lambda g: g[0] - g[1])
    spans = _spans(events)
    none = _Spans([])
    steps = spans.get(step, none)
    host = [e for e in events if e.get("ph") == "X"
            and e.get("cat") in trace_mod.HOST_CATS
            and e.get("name") != trace_mod.WINDOW]
    out = []
    for a, b in gaps[:top]:
        mid = (a + b) / 2
        phase = next((n for n in phases if mid in spans.get(n, none)),
                     step if mid in steps else "none")
        out.append({"ms": (b - a) * 1e-3, "phase": phase,
                    "step": bisect.bisect_right(steps.starts, mid),
                    "host": trace_mod._host_at(host, mid)})
    return out


def scatter_bytes(rows: Sequence[Tuple[int, int]], dim: int,
                  elem: int = 4) -> int:
    """The least bytes of the two row scatters of the batches whose
    distinct rows are ``rows`` (``drivers/w2v.py``'s ``distinct_rows``
    of each): every such row, ``dim`` wide, read once and written
    once."""
    return sum((uin + uout) * dim * elem * 2 for uin, uout in rows)


def _update_bytes() -> float:
    from multiverso_tpu_torch import metrics

    return metrics.counter(UPDATE_BYTES).value


def _capture(holder: dict, tmpdir: str):
    """``run.py``'s traced window (the profiler around a ``bench.window``
    span), keeping the events and the update-bytes counter's increase."""
    from torch.profiler import ProfilerActivity, profile, record_function

    @contextlib.contextmanager
    def traced():
        acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
        before = _update_bytes()
        with profile(activities=acts) as prof:
            with record_function(trace_mod.WINDOW):
                yield
        holder["update_bytes"] = _update_bytes() - before
        path = os.path.join(tmpdir, "trace.json")
        prof.export_chrome_trace(path)
        holder["events"] = trace_mod.load(path)
        os.remove(path)

    return traced


def measure(cell: str, seed: int, device: str,
            overrides: Optional[dict] = None) -> dict:
    """Set-up and the traced window of ``cell`` (``overrides`` as in
    ``run.run``); returns the readings."""
    from perfbench import run

    wl = common.load_workload(cell)
    for key, value in (overrides or {}).items():
        if key == "model":
            wl["model"] = {**wl["model"], **value}
        else:
            wl[key] = value
    drv = importlib.import_module(f"perfbench.drivers.{wl['driver']}")
    cell_obj = drv.setup(wl, seed, device)
    kind = cell_obj.kind
    first = cell_obj.step_no
    holder: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        info = cell_obj.traced(_capture(holder, tmp))
    events = holder["events"]
    steps = info["steps"]
    if kind == "w2v":
        pool = cell_obj.rows
        extra = {"scatter_bytes_per_step": scatter_bytes(
            [pool[i % len(pool)] for i in range(first, first + steps)],
            wl["model"]["dim"]) / steps}
    else:
        extra = {"update_bytes": holder["update_bytes"]}
    tr = trace_mod.reduce(events)
    span_s = span_device_s(events)
    kind_name = _device_kind(device)
    ctx = run.Context(cell=cell, kind=kind, trace=tr,
                      peaks=common.peaks_for(kind_name), span_s=span_s,
                      **extra, **info)
    readings = {}
    for name in READERS[kind]:
        value = run.load_reader(name)(ctx)
        if value is not None:
            readings[name] = value
    phase_s = sum(span_s.get(n, 0.0) for n in PHASES[kind])
    return {
        "cell": cell, "seed": seed, "device": kind_name, "steps": steps,
        "metrics": readings,
        "span_ms_per_step": {n: 1e3 * s / steps for n, s in
                             sorted(span_s.items())},
        **extra,
        "span_check": span_check(events, PHASES[kind]),
        "phase_over_busy": phase_s / tr.busy_s if tr.busy_s > 0 else None,
        "span_gaps": span_gaps(events, PHASES[kind], STEP[kind]),
        "busy_s": tr.busy_s, "window_s": tr.window_s,
        "kernels_per_step": tr.n_kernels / steps,
    }


def _device_kind(device: str) -> str:
    import torch

    if torch.device(device).type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    args = p.parse_args(argv)
    from perfbench.run import fix_environment

    fix_environment()
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 3
    t0 = time.perf_counter()
    out = measure(args.workload, args.seed, "cuda:0")
    out["seconds"] = time.perf_counter() - t0
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
