"""Run one cell of the benchmark once and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout.  The cell is ``workloads/<cell>.json``; its
configuration ``configs/<config>.json``; its driver ``drivers/<driver>.py``
(set-up, the window, the traced window and the plain reference); the
metrics and their units are ``BENCHMARK.json``'s, and each per-layer
metric's reader is ``metrics/<metric>.py``.

Set-up (from the start of this process: imports, weights or tables and
traffic drawn on the card from the seed, the kernels built or loaded,
the checked steps and a warm step) is ``setup_s``.  With ``--trace 0``
the window runs for ``--seconds`` and the line holds the cell's
end-to-end metrics; with ``--trace 1`` a few steps run under
``torch.profiler`` and the line holds its per-layer metrics, the
device's busy and window time and a breakdown.  Then the program's state
is freed and the plain reference replays the checked steps; the numbers
compared, each beside its limit, end standard error and the line.

Exit codes: 0 with a result line (``correct`` may be false); 2 for bad
arguments; 3 without the cards the cell asks for; 4 when a JAX module
was loaded.  Nothing else is printed on standard output.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from perfbench import common  # noqa: E402
from perfbench import trace as trace_mod  # noqa: E402

CACHE = os.path.join(ROOT, "perfbench", ".cache")


def fix_environment() -> None:
    """Kernel caches at fixed paths inside the checkout, and no JAX
    pulled in by a library behind the program's back."""
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE,
                                                      "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def benchmark() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _for_cell(entries, cell: str):
    return [e for e in entries if cell in e.get("workloads", [cell])]


def load_reader(name: str):
    """``metrics/<name>.py``'s ``read(ctx)``."""
    path = os.path.join(common.HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def _profiler(holder: dict, tmpdir: str):
    """A context manager factory for the driver's traced window: the
    profiler around a ``bench.window`` span, the trace exported and
    reduced on exit into ``holder["trace"]``."""
    from torch.profiler import ProfilerActivity, profile, record_function

    @contextlib.contextmanager
    def traced():
        acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
        with profile(activities=acts) as prof:
            with record_function(trace_mod.WINDOW):
                yield
        path = os.path.join(tmpdir, "trace.json")
        prof.export_chrome_trace(path)
        holder["trace"] = trace_mod.reduce(trace_mod.load(path))
        os.remove(path)

    return traced


def _power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout else ""
    except (OSError, subprocess.SubprocessError):
        return ""


def _number(x: float):
    return x if math.isfinite(x) else str(x)


def run(cell: str, seed: int, seconds: float, trace: bool, device: str,
        chips: int = 1, overrides: dict = None, t_start: float = None
        ) -> dict:
    """One run of ``cell``: set-up, the window (or the traced window),
    the check; returns the result line's object.  ``overrides`` replaces
    entries of the cell's file, and of its configuration under
    ``"model"``, for runs at a test's size.  ``setup_s`` counts from
    ``t_start`` (the process's start in a real run)."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    wl = common.load_workload(cell)
    for key, value in (overrides or {}).items():
        if key == "model":
            wl["model"] = {**wl["model"], **value}
        else:
            wl[key] = value
    bench = benchmark()
    drv = importlib.import_module(f"perfbench.drivers.{wl['driver']}")
    cuda = torch.device(device).type == "cuda"
    t_setup = time.perf_counter()
    cell_obj = drv.setup(wl, seed, device)
    setup_s = time.perf_counter() - t_start
    log("setup_phases", json.dumps({"before_setup": t_setup - t_start,
                                    **cell_obj.phases.seconds}))
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)

    metrics = {}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": chips}
    result = {}
    if trace:
        holder: dict = {}
        with tempfile.TemporaryDirectory() as tmp:
            info = cell_obj.traced(_profiler(holder, tmp))
        tr = holder["trace"]
        ctx = Context(cell=cell, kind=cell_obj.kind, trace=tr,
                      peaks=common.peaks_for(dev["kind"]), **info)
        launches = info.get("launches")
        if launches:
            for k, n in sorted(launches.items()):
                seen = tr.count(lambda name, k=k: f"{k}_hopper" in name)
                log(f"trace_check {k} trace {seen} launch_counts {n}"
                    f" {'ok' if seen == n else 'LOST'}")
        for m in _for_cell(bench["per_layer"], cell):
            value = load_reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev["busy_s"] = tr.busy_s
        dev["window_s"] = tr.window_s
        result["breakdown"] = {
            "device_ops": [[n, s] for n, s in tr.top_ops],
            "idle_gaps": [[n, s] for n, s in tr.gaps]}
        attempted = info["steps"]
    else:
        values = cell_obj.window(seconds)
        values["setup_s"] = setup_s
        if cuda:
            values["peak_mem_gib"] = \
                torch.cuda.max_memory_allocated(device) / 2 ** 30
        for m in _for_cell(bench["end_to_end"], cell):
            if m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
        log("window", json.dumps(values))
        attempted = values["steps"]
    if cuda:
        peak = max(peak, torch.cuda.max_memory_allocated(device))
    dev["memory_peak_bytes"] = int(peak)
    dev["power"] = _power_limit() if cuda else ""
    last = getattr(cell_obj, "last_loss", float("nan"))
    log(f"last_loss {last}")

    prog = cell_obj.readings
    cell_obj.release()
    ref = cell_obj.reference("fp32")
    numbers = common.training_numbers(prog, ref)
    limits = wl["limits"]
    correct = common.judge(numbers, limits) and math.isfinite(last)
    log("program", json.dumps(prog["loss"]), "reference",
        json.dumps(ref["loss"]))
    left_out = sorted(set(ref["change"]) - set(common.moved_leaves(
        ref["grad"])))
    log(f"leaves left out of change_gap (first gradient under 1e-3 of the"
        f" median leaf's): {len(left_out)} {' '.join(left_out)}")
    for k in limits:
        log(f"check {k} {numbers[k]:.6g} limit {limits[k]:.6g}")
    result.update({
        "correct": bool(correct), "attempted": int(attempted),
        "failed": 0 if math.isfinite(last) else int(attempted),
        "metrics": metrics, "device": dev,
        "check": {k: {"value": _number(numbers[k]), "limit": limits[k]}
                  for k in limits},
    })
    return result


class Context:
    """What a per-layer reader gets: the cell, its kind (``train`` or
    ``w2v``), the reduced trace, the card's peaks (or None) and what the
    driver's traced window reported."""

    def __init__(self, **kw):
        self.__dict__.update(kw)

    def __getattr__(self, name):        # a reader asks for what is not
        return None                     # there: it finds nothing


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    fix_environment()
    try:
        wl = common.load_workload(args.workload)
    except FileNotFoundError as e:
        log(f"no such cell: {e}")
        return 2
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < wl["chips"]:
        log(f"cell {args.workload} needs {wl['chips']} CUDA card(s); "
            f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 3
    result = run(args.workload, args.seed, args.seconds, bool(args.trace),
                 "cuda:0", wl["chips"], t_start=T_START)
    bad = common.forbidden_loaded()
    if bad:
        log(f"modules that no run may load are loaded: {', '.join(bad)}")
        return 4
    print(json.dumps(result), flush=True)   # "check" is its last key
    return 0


if __name__ == "__main__":
    sys.exit(main())
