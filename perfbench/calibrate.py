"""Read the numbers that set a cell's limits, at the cell's own size.

    python3 perfbench/calibrate.py --workload <cell> --seeds 1,2,3 \
        [--control-seeds 1,2,3] [--faults half_batch]

For each seed, in one process: the program's checked steps against the
plain reference (sound runs: the lower readings), and on the control
seeds the reference in the precision below the configuration's in the
program's place (the control: the upper readings) and each planted fault
in the reference (``half_batch``: half of each batch's rows left out,
the mean over the rest).  One JSON line a seed and reading on standard
output, then a summary: the largest sound reading and the smallest
control and fault readings of each number.  A state left unchanged
reads 1 on the change by construction and needs no run.  The benchmark's
own runs never run this.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from perfbench import common  # noqa: E402
from perfbench.run import fix_environment  # noqa: E402


def _ints(text: str):
    return [int(x) for x in text.split(",") if x]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=_ints, required=True)
    p.add_argument("--control-seeds", type=_ints, default=[])
    p.add_argument("--faults", default="")
    args = p.parse_args(argv)
    fix_environment()
    wl = common.load_workload(args.workload)
    drv = importlib.import_module(f"perfbench.drivers.{wl['driver']}")
    faults = [f for f in args.faults.split(",") if f]
    readings = {}
    for seed in sorted(set(args.seeds) | set(args.control_seeds)):
        cell = drv.setup(wl, seed, "cuda:0")
        prog = cell.readings
        cell.release()
        ref = cell.reference("fp32")
        kinds = {}
        if seed in args.seeds:
            kinds["program"] = prog
        if seed in args.control_seeds:
            kinds["control"] = cell.reference(wl["control"])
            for f in faults:
                kinds[f] = cell.reference("fp32", fault=f)
        for kind, got in kinds.items():
            numbers = common.training_numbers(got, ref)
            readings.setdefault(kind, []).append(numbers)
            print(json.dumps({"seed": seed, "kind": kind, **numbers,
                              "loss": got["loss"], "ref_loss": ref["loss"]}),
                  flush=True)
        del cell
    summary = {}
    for kind, rows in readings.items():
        pick = max if kind == "program" else min
        summary[kind] = {k: pick(r[k] for r in rows) for k in rows[0]}
    print(json.dumps({"workload": args.workload, "summary": summary}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
