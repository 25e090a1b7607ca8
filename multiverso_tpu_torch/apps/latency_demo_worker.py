"""Fleet holder for the latency-attribution demo (``make latency-demo``).

Run as ``python latency_demo_worker.py <machine_file> <rank>
<trace_dir>``: two of these form a 2-rank native epoll fleet with
tracing, wire timing, heartbeats (a clock-offset channel), and the
native SIGPROF sampler armed, do cross-rank table traffic so every
stage histogram / offset estimator / exemplar has data, and print
``LATD_READY`` — then serve stdin commands:

- ``fault``   — arm a 100% 25 ms ``apply_delay`` fault on THIS rank's
  server apply path (the "slow apply" the doctor must name); print
  ``LATD_FAULT_ARMED``.
- ``traffic`` — 25 more cross-rank gets; print ``LATD_TRAFFIC_DONE``.
- ``quit``    — export native spans + the profiler's folded stacks to
  ``<trace_dir>/trace_rank<r>.json``, shut down, print
  ``LATD_OK <rank>``.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import numpy as np  # noqa: E402

from multiverso_tpu_torch import profiler, tracing  # noqa: E402
from multiverso_tpu_torch import native as nat  # noqa: E402

SIZE = 256
PROFILE_HZ = 97


def main() -> int:
    mf, rank, trace_dir = sys.argv[1], int(sys.argv[2]), sys.argv[3]
    rt = nat.NativeRuntime(args=[
        f"-machine_file={mf}", f"-rank={rank}", "-log_level=error",
        "-trace=true", f"-trace_dir={trace_dir}",
        f"-profile_hz={PROFILE_HZ}",
        "-heartbeat_ms=100", "-heartbeat_timeout_ms=5000",
        "-rpc_timeout_ms=30000", "-barrier_timeout_ms=60000"])
    assert rt.net_engine() == "epoll", rt.net_engine()
    h = rt.new_array_table(SIZE)
    rt.barrier()
    for _ in range(10):
        rt.array_add(h, np.full(SIZE, 0.5, np.float32))
        rt.array_get(h, SIZE)
    rt.barrier()
    print("LATD_READY", flush=True)

    for line in sys.stdin:
        cmd = line.strip()
        if cmd == "fault":
            rt.set_fault("delay_ms", 25)
            rt.set_fault("apply_delay", 1.0)
            print("LATD_FAULT_ARMED", flush=True)
        elif cmd == "traffic":
            for _ in range(25):
                rt.array_get(h, SIZE)
            print("LATD_TRAFFIC_DONE", flush=True)
        elif cmd == "quit":
            break
    rt.clear_faults()
    rt.barrier()

    # Trace export: native spans + the SIGPROF sampler's flame data on
    # one timeline (docs/observability.md "latency plane").
    tracing.enable(rank=rank)
    tracing.add_native_spans(rt)
    profiler.add_native_profile(rt, hz=PROFILE_HZ)
    tracing.save(os.path.join(trace_dir, f"trace_rank{rank}.json"))
    rt.shutdown()
    print(f"LATD_OK {rank}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
