#!/usr/bin/env python3
"""The port's transformer mesh at full width on four cards.

Run from the repository root on a machine with four NVIDIA cards:

    python3 tools/mesh_full_width.py [--out DIR] [--steps 5]

It spawns one NCCL rank per card (a process of this script each) and
trains ``bench_transformer_large``'s model (vocab 32768, dim 2048, 16
heads of 128, hidden 5632, 16 layers, bf16, seq 2048, SGD, no remat) at
the global batch of 4 that ``chip_smoke.py``'s mesh phase uses, from one
draw of the masters (seed 0), on the meshes (dp 2, tp 2), (dp 2, sp 2)
with the ring contiguous and zigzag, and (dp 2, pp 2) with GPipe's 2
microbatches; rank 0 first trains the same batch without a mesh on its
card.  Each run takes ``--steps`` steps (host clock, each ending in a
synchronize; the mean of steps 2 on) and one more under
``torch.profiler``, whose kernel spans on each rank give:

- the device's busy time (the union of every kernel's span) and its
  compute-busy time (every kernel but NCCL's) over the step;
- NCCL's kernels by kind: all-reduces in bf16 (tp's activations) and in
  float32 (the gradients' sum over dp), send/recv (the sp ring's
  rotations, GPipe's hand-overs);
- how much of the send/recv time overlaps a flash kernel, and any
  compute kernel, on the same card (the transport hidden behind the
  compute);
- under pp, each stage's idle share (no compute kernel running): GPipe's
  bubble.

Every rank's losses must be finite and fall.  It prints one JSON line
per run and rank, then the card's name and power limit as nvidia-smi
gives them, and writes ``mesh_full_width.json`` under ``--out``.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
BATCH, SEQ = 4, 2048
LARGE = dict(vocab_size=32768, dim=2048, n_layers=16, n_heads=16,
             hidden=5632, max_seq=SEQ)
# (name, sizes, names, config changes, ring layout)
RUNS = [("dp2_tp2", [2, 2], ["dp", "tp"], {}, None),
        ("dp2_sp2_contiguous", [2, 2], ["dp", "sp"], {}, "contiguous"),
        ("dp2_sp2_zigzag", [2, 2], ["dp", "sp"], {}, "zigzag"),
        ("dp2_pp2", [2, 2], ["dp", "pp"],
         dict(scan_layers=True, pipeline_microbatches=2), None)]
TIMEOUT_S = 1500


def _union(spans):
    """Total length of the union of ``[(start, end)]``."""
    total, end = 0.0, -np.inf
    for a, b in sorted(spans):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def _overlap(spans, cover):
    """Length of ``spans``'s union that lies inside ``cover``'s union."""
    return _union(spans) + _union(cover) - _union(spans + cover)


def kernel_summary(trace_events, wall_ms):
    """The profiled step's kernel spans (chrome-trace ``kernel`` events)
    summed as the module docstring says; times in ms."""
    kern = [(e["name"], e["ts"], e["ts"] + e["dur"]) for e in trace_events
            if e.get("cat") == "kernel" and e.get("ph") == "X"]

    def spans(pred):
        return [(a, b) for n, a, b in kern if pred(n)]

    def is_nccl(n):
        return n.startswith("nccl")

    def is_p2p(n):
        return is_nccl(n) and "SendRecv" in n

    def is_bf16(n):
        return "bf16" in n or "bfloat16" in n

    compute = spans(lambda n: not is_nccl(n))
    flash = spans(lambda n: "flash" in n)
    p2p = spans(is_p2p)
    kinds = {}
    for n, a, b in kern:
        if is_nccl(n):
            k = n.split("(")[0]
            t, c = kinds.get(k, (0.0, 0))
            kinds[k] = (t + (b - a) / 1e3, c + 1)
    first = min((a for _, a, _ in kern), default=0.0)
    last = max((b for _, _, b in kern), default=0.0)
    return {
        "wall_ms": wall_ms, "kernels": len(kern),
        "kernel_span_ms": (last - first) / 1e3,
        "busy_ms": _union(spans(lambda n: True)) / 1e3,
        "compute_busy_ms": _union(compute) / 1e3,
        "compute_idle_share_of_wall": 1 - _union(compute) / 1e3 / wall_ms,
        "flash_ms": _union(flash) / 1e3,
        "nccl_by_kind": {k: {"ms": t, "count": c}
                         for k, (t, c) in sorted(kinds.items())},
        "allreduce_bf16_ms": _union(spans(
            lambda n: is_nccl(n) and "AllReduce" in n and is_bf16(n))) / 1e3,
        "allreduce_other_ms": _union(spans(
            lambda n: is_nccl(n) and "AllReduce" in n
            and not is_bf16(n))) / 1e3,
        "sendrecv_ms": _union(p2p) / 1e3,
        "sendrecv_hidden_by_flash_ms": _overlap(p2p, flash) / 1e3,
        "sendrecv_hidden_by_compute_ms": _overlap(p2p, compute) / 1e3,
    }


def _train(torch, cfg, host, tokens, steps, mesh, device, trace_dir, tag):
    """``steps`` steps and one profiled step: the report of this rank."""
    from multiverso_tpu_torch import ops
    from multiverso_tpu_torch.models import TransformerTrainer

    tr = TransformerTrainer(cfg, device=device, updater_type="sgd",
                            params=host, mesh=mesh)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    losses, step_s = [], []
    for _ in range(steps):
        s0 = time.perf_counter()
        loss = tr.train_step_async(tokens)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - s0)
        losses.append(float(loss))
    counts = ops.launch_counts()
    acts = [torch.profiler.ProfilerActivity.CUDA]     # the kernels' spans
    with torch.profiler.profile(activities=acts) as prof:
        s0 = time.perf_counter()
        loss = tr.train_step_async(tokens)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - s0) * 1e3
    del loss
    path = os.path.join(trace_dir, f"{tag}.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    os.remove(path)
    steady = step_s[1:] or step_s
    mean = sum(steady) / len(steady)
    del tr
    torch.cuda.empty_cache()
    return {"losses": losses, "step_s": step_s,
            "step_s_mean_after_first": mean,
            "tokens_per_s": tokens.numel() / mean,
            "peak_mem_bytes": torch.cuda.max_memory_allocated(),
            "launch_counts": counts,
            "falling": all(np.isfinite(losses)) and losses[-1] < losses[0],
            "profile": kernel_summary(events, wall_ms)}


def rank_main(rank, port, steps, out_dir) -> int:
    sys.path.insert(0, REPO)
    import torch
    import torch.distributed as dist

    import importlib

    from multiverso_tpu_torch.models import TransformerConfig, init_params
    from multiverso_tpu_torch.parallel import make_mesh

    # The module (the package re-exports a function of the same name).
    ring_attention = importlib.import_module(
        "multiverso_tpu_torch.parallel.ring_attention")

    device = f"cuda:{rank}"
    torch.cuda.set_device(device)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            world_size=WORLD, rank=rank,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    cfg = TransformerConfig(**LARGE, compute_dtype=torch.bfloat16)
    host = init_params(cfg, seed=0)
    tokens = torch.randint(0, cfg.vocab_size, (BATCH, SEQ),
                           generator=torch.Generator().manual_seed(1))
    reports = []
    trace_dir = tempfile.mkdtemp(prefix=f"mvt_fw{rank}_")
    if rank == 0:
        reports.append({"run": "one_card_no_mesh", "rank": 0,
                        **_train(torch, cfg, host, tokens, steps, None,
                                 device, trace_dir, "one")})
    dist.barrier()
    plain = ring_attention._use_zigzag
    for name, sizes, names, extra, layout in RUNS:
        mesh = make_mesh(sizes, names, device=device)
        if layout is not None:
            ring_attention._use_zigzag = (
                lambda T, sp, causal, lay, z=(layout == "zigzag"): z)
        try:
            rep = _train(torch, TransformerConfig(
                **LARGE, **extra, compute_dtype=torch.bfloat16), host,
                tokens, steps, mesh, device, trace_dir, name)
        finally:
            ring_attention._use_zigzag = plain
        coords = {a: mesh.index(a) for a in names}
        reports.append({"run": name, "rank": rank, "coords": coords, **rep})
        dist.barrier()
    os.rmdir(trace_dir)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(reports, f)
    dist.destroy_process_group()
    return 0


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="build/mesh_full_width")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--rank", type=int, default=None)
    ap.add_argument("--port", type=int, default=0)
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    if args.rank is not None:
        return rank_main(args.rank, args.port, args.steps, args.out)
    sys.path.insert(0, REPO)
    import torch

    if torch.cuda.device_count() < WORLD:
        print(f"mesh_full_width: needs {WORLD} CUDA devices, has "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 1
    from multiverso_tpu_torch.ops import _build

    _build.build()              # once, before the ranks load it
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--rank", str(r),
         "--port", str(port), "--steps", str(args.steps), "--out", args.out],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT_S)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        print(f"ranks did not finish within {TIMEOUT_S} s", file=sys.stderr)
        return 1
    failed = [r for r, p in enumerate(procs) if p.returncode != 0]
    for r in failed:
        print(f"rank {r} failed:\n{logs[r][-4000:]}", file=sys.stderr)
    if failed:
        return 1
    reports = []
    for r in range(WORLD):
        with open(os.path.join(args.out, f"rank{r}.json")) as f:
            reports.extend(json.load(f))
    for rep in reports:
        print(json.dumps({k: v for k, v in rep.items()
                          if k not in ("step_s",)}), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    doc = {"seconds": time.perf_counter() - t0, "batch": BATCH, "seq": SEQ,
           "config": LARGE, "nvidia_smi": smi.strip().splitlines(),
           "reports": reports}
    with open(os.path.join(args.out, "mesh_full_width.json"), "w") as f:
        json.dump(doc, f)
    print(smi.strip(), flush=True)
    return 0 if all(r["falling"] for r in reports) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
