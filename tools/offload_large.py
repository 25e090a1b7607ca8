#!/usr/bin/env python3
"""The port's trainer state offload at the large config's size, on one card.

Run from the repository root on a machine with an NVIDIA card:

    python3 tools/offload_large.py

It trains ``bench_transformer_large``'s model (vocab 32768, dim 2048, 16
heads of 128, hidden 5632, 16 layers, bf16, seq 2048) with momentum from
one draw of the masters (seed 0) at ``chip_smoke.py``'s batch (4): its
``MOE_MESH_STEPS`` (3) steps in memory, then the same steps with the
momentum state (956 M float32, about 3.8 GB) offloaded to the native
runtime's ``assign`` table through ``OffloadedState`` (four arena
buffers of the state's size), through ``chip_smoke.py``'s
``offload_arm``.  Losses, parameters and state must agree bit for bit.
It prints one JSON line with the step times, the bridge's push/wait
p50s, the host's memory (``MemTotal``) and this process's peak resident
set, then the card's name and power limit as nvidia-smi gives them.  It
exits 1 without a card and when the arms differ.
"""

from __future__ import annotations

import importlib.util
import json
import os
import resource
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _mem_total_bytes() -> int:
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemTotal:"):
                return int(line.split()[1]) * 1024
    raise RuntimeError("no MemTotal in /proc/meminfo")


def main() -> int:
    sys.path.insert(0, HERE)
    import torch

    if not torch.cuda.is_available():
        print("offload_large: no CUDA card", file=sys.stderr)
        return 1
    cs = _chip_smoke()
    from multiverso_tpu_torch import native as nat
    from multiverso_tpu_torch.models import init_params

    steps, batch = cs.MOE_MESH_STEPS, cs.BATCH
    cfg = cs.large_config(torch)
    host = init_params(cfg, seed=0)
    tokens = torch.randint(0, cfg.vocab_size, (batch, cs.SEQ),
                           generator=torch.Generator().manual_seed(1))
    mem = cs.offload_arm(torch, cfg, host, tokens, steps=steps)
    rt = nat.NativeRuntime(args=["-updater_type=assign", "-log_level=error"])
    try:
        off = cs.offload_arm(torch, cfg, host, tokens, "native", rt,
                             steps=steps)
        arena = rt.arena().stats()
    finally:
        rt.shutdown()
    verdict, same = cs.judge_offload_arms(mem, {"native": off})
    print(json.dumps({
        "config": "transformer_large", "batch": batch, "seq": cs.SEQ,
        "updater": "momentum", "steps": steps,
        "state_elements": mem[4], "state_bytes": 4 * mem[4],
        "bitwise_equal": verdict, "losses": {"in_memory": mem[0],
                                             "native": off[0]},
        "step_s": {"in_memory": mem[1], "native": off[1]},
        "bridge_p50_s": off[5], "arena": arena,
        "host_mem_total_bytes": _mem_total_bytes(),
        "peak_rss_bytes": resource.getrusage(
            resource.RUSAGE_SELF).ru_maxrss * 1024,
        "host_cpus": os.cpu_count(),
        "card": torch.cuda.get_device_name(0)}), flush=True)
    print(cs.nvidia_smi_line(), flush=True)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
