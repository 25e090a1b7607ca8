"""Reading a ``torch.profiler`` trace of the traced window.

The window is one ``record_function`` span, ``bench.window``, that ends
after a ``synchronize``.  From the exported Chrome trace this takes:

- the device's busy time: the union of the intervals in which a kernel,
  a copy or a fill ran, inside the window (overlapping kernels count
  once, unlike a sum of self times);
- each kernel with the host op it was launched under: its launch (the
  runtime event of the same correlation id) lies inside one of the
  spans named by ``attention_op``;
- the longest idle gaps, each named by the innermost host span open at
  its middle;
- the device operations that took the most time.
"""

from __future__ import annotations

import bisect
import json
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
WINDOW = "bench.window"


def attention_op(name: str) -> bool:
    """The port's attention ops: the forward's dispatcher op and the
    autograd function around the three kernels, forward and backward."""
    return (name == "mvt::flash_fwd" or name.endswith("_Flash")
            or name.endswith("_FlashBackward"))


@dataclass
class Kernel:
    name: str
    dur: float       # seconds
    cat: str
    attention: bool = False


@dataclass
class Trace:
    window_s: float
    busy_s: float
    kernels: List[Kernel]
    gaps: List[Tuple[str, float]] = field(default_factory=list)
    top_ops: List[Tuple[str, float]] = field(default_factory=list)

    def count(self, pred: Callable[[str], bool]) -> int:
        return sum(1 for k in self.kernels
                   if k.cat == "kernel" and pred(k.name))

    @property
    def attention_s(self) -> float:
        return sum(k.dur for k in self.kernels if k.attention)

    @property
    def n_kernels(self) -> int:
        return sum(1 for k in self.kernels if k.cat == "kernel")


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def _inside(spans: List[Tuple[float, float]], starts: List[float],
            t: float) -> bool:
    i = bisect.bisect_right(starts, t) - 1
    return i >= 0 and spans[i][0] <= t <= spans[i][1]


def _short(name: str, width: int = 160) -> str:
    return name if len(name) <= width else name[:width - 3] + "..."


def reduce(events: List[dict], top: int = 10) -> Trace:
    """The window's busy time, kernels, idle gaps and top operations."""
    window = [e for e in events if e.get("ph") == "X"
              and e.get("name") == WINDOW]
    if not window:
        raise ValueError(f"the trace holds no '{WINDOW}' span")
    w0 = float(window[0]["ts"])
    w1 = w0 + float(window[0]["dur"])
    host = [e for e in events if e.get("ph") == "X"
            and e.get("cat") in HOST_CATS and e.get("name") != WINDOW]
    launches = {e["args"]["correlation"]: e for e in events
                if e.get("ph") == "X" and e.get("cat") in LAUNCH_CATS
                and "correlation" in e.get("args", {})}
    op_spans: Dict[object, List[Tuple[float, float]]] = defaultdict(list)
    for e in host:
        if attention_op(e["name"]):
            op_spans[e.get("tid")].append(
                (float(e["ts"]), float(e["ts"]) + float(e["dur"])))
    merged = {tid: _union(s) for tid, s in op_spans.items()}
    starts = {tid: [a for a, _ in s] for tid, s in merged.items()}

    kernels: List[Kernel] = []
    spans: List[Tuple[float, float]] = []
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        ts, dur = float(e["ts"]), float(e["dur"])
        if ts + dur < w0 or ts > w1:
            continue
        att = False
        launch = launches.get(e.get("args", {}).get("correlation"))
        if launch is not None and launch.get("tid") in merged:
            tid = launch["tid"]
            att = _inside(merged[tid], starts[tid], float(launch["ts"]))
        kernels.append(Kernel(e["name"], dur * 1e-6, e["cat"], att))
        spans.append((max(ts, w0), min(ts + dur, w1)))

    busy = _union(spans)
    busy_s = sum(b - a for a, b in busy) * 1e-6
    edges = [w0] + [x for span in busy for x in span] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    gaps.sort(key=lambda g: g[0] - g[1])
    named = [(f"host: {_host_at(host, (a + b) / 2)}", (b - a) * 1e-6)
             for a, b in gaps[:top]]

    by_name: Dict[str, float] = defaultdict(float)
    for k in kernels:
        by_name[_short(k.name)] += k.dur
    top_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return Trace((w1 - w0) * 1e-6, busy_s, kernels, named, top_ops)


def _host_at(host: List[dict], t: float) -> str:
    """The innermost host span open at ``t`` (the latest to start)."""
    best: Optional[dict] = None
    for e in host:
        a = float(e["ts"])
        if a <= t <= a + float(e["dur"]) and (
                best is None or a > float(best["ts"])):
            best = e
    return "none" if best is None else _short(best["name"], 120)


def load(path: str) -> List[dict]:
    with open(path) as f:
        data = json.load(f)
    return data["traceEvents"] if isinstance(data, dict) else data
