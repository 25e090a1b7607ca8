"""Fleet holder for the health-plane demo (``make doctor-demo``).

Run as ``python doctor_demo_worker.py <machine_file> <rank>``: two of
these form a 2-rank native epoll fleet with wire timing, heartbeats,
the native stall watchdog armed and the PYTHON health plane armed (a
demo-tightened latency burn-rate rule riding the default windows down
so the closed loop is watchable in seconds, not minutes), then print
``DOC_READY`` and serve stdin commands:

- ``probe``  — native cross-rank gets (feeds the peer-visible stage
  histograms) plus timed ANONYMOUS probes against the PEER's serve
  port (feeds this rank's ``lat.total`` / ``lat.slo.*`` error-budget
  counters — the series the burn-rate rule watches); print
  ``DOC_PROBE_DONE``.
- ``fault``  — arm a 100% 25 ms ``apply_delay`` fault on THIS rank's
  server apply path; print ``DOC_FAULT_ARMED``.
- ``clear``  — clear faults; print ``DOC_CLEARED``.
- ``alerts`` — print this rank's alert doc as one line
  (``DOC_ALERTS <json>``) for the driver's asserts.
- ``quit``   — disarm, shut down, print ``DOC_OK <rank>``.
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import numpy as np  # noqa: E402

from multiverso_tpu_torch import config, health, latency, metrics  # noqa: E402
from multiverso_tpu_torch import native as nat  # noqa: E402
from multiverso_tpu_torch.serve import wire  # noqa: E402

SIZE = 256
FLUSH_MS = 250
# 10 ms SLO vs a 25 ms injected apply delay: every faulted probe is a
# breach, so the burn rate saturates within one flush of traffic.
SLO_MS = 10.0


def demo_rules():
    """The default pack's latency burn rule with demo-scale windows:
    8 s long / 2 s short so the alert both fires within two flushes of
    faulted traffic AND resolves within seconds of the fault clearing
    (the production windows are 300 s / 30 s)."""
    return [health.Rule(
        name="lat-slo-burn", metric="lat.slo.breach", op="burn_rate_gt",
        threshold=2.0, total_metric="lat.slo.total", objective=0.99,
        window_s=8.0, short_window_s=4.0, for_s=0.0,
        severity="critical")]


def main() -> int:
    mf, rank = sys.argv[1], int(sys.argv[2])
    with open(mf) as f:
        eps = [ln.strip() for ln in f if ln.strip()]
    peer = eps[1 - rank]
    rt = nat.NativeRuntime(args=[
        f"-machine_file={mf}", f"-rank={rank}", "-log_level=error",
        "-heartbeat_ms=100", "-heartbeat_timeout_ms=5000",
        "-watchdog_stall_ms=2000",
        "-rpc_timeout_ms=30000", "-barrier_timeout_ms=60000"])
    assert rt.net_engine() == "epoll", rt.net_engine()
    h = rt.new_array_table(SIZE)
    rt.barrier()

    config.set_flag("health_latency_slo_ms", SLO_MS)
    metrics.reset()
    metrics.start_flush(FLUSH_MS)
    health.arm(rules=demo_rules(), runtime=rt)
    print("DOC_READY", flush=True)

    for line in sys.stdin:
        cmd = line.strip()
        if cmd == "probe":
            for _ in range(5):
                rt.array_add(h, np.full(SIZE, 0.5, np.float32))
                rt.array_get(h, SIZE)
            client = latency.attach_metrics(
                wire.AnonServeClient(peer, timeout=15, timing=True))
            for _ in range(10):
                client.get_shard(h)
            client.close()
            print("DOC_PROBE_DONE", flush=True)
        elif cmd == "fault":
            rt.set_fault("delay_ms", 25)
            rt.set_fault("apply_delay", 1.0)
            print("DOC_FAULT_ARMED", flush=True)
        elif cmd == "clear":
            rt.clear_faults()
            print("DOC_CLEARED", flush=True)
        elif cmd == "alerts":
            print("DOC_ALERTS " + json.dumps(health.alerts_doc()),
                  flush=True)
        elif cmd == "quit":
            break
    rt.clear_faults()
    rt.barrier()
    health.disarm(rt)
    metrics.stop_flush()
    rt.shutdown()
    print(f"DOC_OK {rank}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
