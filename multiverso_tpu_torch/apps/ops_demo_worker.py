"""Fleet holder for the ops/introspection demo (``make ops-demo``).

Run as ``python ops_demo_worker.py <machine_file> <rank> <trace_dir>``:
two of these form a 2-rank native epoll fleet with tracing armed, do a
few cross-rank table ops (so monitors, spans, and bucket exemplars
exist), push the Python metrics registry into the native ops plane, and
print ``OPS_READY`` — then HOLD the fleet for the demo's anonymous
scraper until a line arrives on stdin.

On release, rank 0 runs an INJECTED BARRIER TIMEOUT: it enters a
barrier with ``-barrier_timeout_ms=1500`` while rank 1 sleeps 3 s before
arriving.  Rank 0's timeout is a flight-recorder trigger — the native
black box dumps ``<trace_dir>/blackbox_rank0.json`` — after which the
retry completes the rendezvous (round semantics).  Both ranks then
export their span rings as ``trace_rank<r>.json`` (Chrome trace) so the
demo can prove the blackbox spans AND the scraped exemplars resolve in
the merged timeline, and exit with ``OPS_WORKER_OK <rank>``.
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from multiverso_tpu_torch import metrics, tracing  # noqa: E402
from multiverso_tpu_torch import native as nat  # noqa: E402

SIZE = 256


def main() -> int:
    mf, rank, trace_dir = sys.argv[1], int(sys.argv[2]), sys.argv[3]
    barrier_ms = 1500 if rank == 0 else 60000
    rt = nat.NativeRuntime(args=[
        f"-machine_file={mf}", f"-rank={rank}", "-log_level=error",
        "-trace=true", f"-trace_dir={trace_dir}",
        "-rpc_timeout_ms=30000", f"-barrier_timeout_ms={barrier_ms}",
        "-server_inflight_max=64", "-heartbeat_ms=200"])
    assert rt.net_engine() == "epoll", rt.net_engine()
    h = rt.new_array_table(SIZE)
    hk = rt.new_kv_table()
    rt.barrier()
    # Cross-rank traffic: every op records monitors + spans + exemplars
    # (the worker Get on one rank correlates with the server apply on
    # the other by trace id — the ids a scraped exemplar must resolve).
    for step in range(5):
        rt.array_add(h, np.full(SIZE, 0.5, np.float32))
        rt.array_get(h, SIZE)
    rt.barrier()

    # Serve the FULL registry over the wire: bridge native monitors in,
    # then push the exemplar-annotated rendering into the ops plane.
    metrics.bridge_native(rt)
    rt.set_ops_host_metrics(metrics.render_prometheus(exemplars=True))

    print("OPS_READY", flush=True)
    sys.stdin.readline()          # held while the demo scrapes us

    # ---- injected barrier timeout (the flight-recorder trigger) ------
    if rank == 1:
        time.sleep(3.0)           # straggle PAST rank 0's deadline
        rt.barrier()              # late arrival: releases rank 0's retry
    else:
        try:
            rt.barrier()          # times out at 1.5s -> blackbox dump
            print("OPS_DEMO_UNEXPECTED: barrier did not time out",
                  flush=True)
            return 1
        except RuntimeError:
            box = os.path.join(trace_dir, "blackbox_rank0.json")
            assert os.path.exists(box), box
            print("BLACKBOX_DUMPED", flush=True)
        # Retry rounds until rank 1's late arrival completes the
        # rendezvous (each retry waits the 1.5s deadline again).
        for _ in range(20):
            try:
                rt.barrier()
                break
            except RuntimeError:
                continue
        else:
            raise RuntimeError("barrier retries never completed")
    rt.kv_add(hk, f"done{rank}", 1.0)
    rt.barrier()

    # Export the span ring as this rank's Chrome trace (the merge target
    # exemplars + blackbox spans resolve against).
    tracing.enable(rank=rank)
    tracing.add_native_spans(rt)
    tracing.save(os.path.join(trace_dir, f"trace_rank{rank}.json"))
    rt.barrier()
    rt.shutdown()
    print(f"OPS_WORKER_OK {rank}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
