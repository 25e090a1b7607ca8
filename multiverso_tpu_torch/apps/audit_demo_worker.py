"""Delivery-audit acceptance worker (``make audit-demo``; not a pytest
module — tools/audit_demo.py drives it, docs/observability.md "audit
plane").

Run as ``python audit_demo_worker.py <machine_file> <rank> <mode>
[trace_dir] [extra flags...]``; both ranks print
``AUDIT_DEMO_WORKER_OK`` on success.  Modes:

- ``chaos`` — rank 1 blocking-adds through injected ``fail_send``
  faults (the retry harness absorbs every one; the exact table
  value proves zero lost acked adds), then eats exactly two injected
  ``dup`` sends, then an async burst acked by one final blocking add.
  Rank 0 prints the fleet ``"audit"`` books: the auditor must name
  exactly the two dups and no loss.
- ``loss`` — rank 0 arms a one-shot silent ``discard_apply`` (the real
  loss retry cannot absorb); rank 1's async stream leaves a seq hole
  that fires the ``audit_gap`` blackbox past ``-audit_grace_ms``.
- ``plain`` — launched with ``-audit=false``: every frame ships the
  PRE-AUDIT layout (no flag bit), adds still converge exactly, and the
  scraped report says ``armed: false`` — the version-tolerance proof.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import numpy as np  # noqa: E402

from multiverso_tpu_torch import native as nat  # noqa: E402

SIZE = 64
FAIL_SEND_ADDS = 3
DUP_ADDS = 2
ASYNC_BURST = 6


def main() -> int:
    mf, rank, mode = sys.argv[1], int(sys.argv[2]), sys.argv[3]
    trace_dir = sys.argv[4] if len(sys.argv) > 4 else ""
    extra = sys.argv[5:]
    args = [f"-machine_file={mf}", f"-rank={rank}", "-log_level=error",
            "-rpc_timeout_ms=20000", "-barrier_timeout_ms=60000",
            "-send_retries=3", "-send_backoff_ms=20",
            "-audit_grace_ms=250", *extra]
    if trace_dir:
        args.append(f"-trace_dir={trace_dir}")
    rt = nat.NativeRuntime(args=args)
    h = rt.new_array_table(SIZE)
    rt.barrier()

    delta = np.ones(SIZE, np.float32)
    if rank == 0 and mode == "loss":
        rt.set_fault_seed(11)
        rt.set_fault_n("discard_apply", 1)
    rt.barrier()

    if rank == 1:
        rt.set_fault_seed(7)
        if mode == "chaos":
            for _ in range(FAIL_SEND_ADDS):
                rt.set_fault_n("fail_send", 1)
                rt.array_add(h, delta)
            rt.clear_faults()
            # Exact convergence BEFORE the dup phase: every acked add
            # applied exactly once — retry absorbed the send failures.
            got = rt.array_get(h, SIZE)
            np.testing.assert_allclose(got, float(FAIL_SEND_ADDS))
            assert rt.query_monitor("net.retries") >= FAIL_SEND_ADDS
            print("CHAOS_ADDS_OK", flush=True)
            rt.set_fault_n("dup", DUP_ADDS)
            for _ in range(DUP_ADDS):
                rt.array_add(h, delta)
            rt.clear_faults()
            for _ in range(ASYNC_BURST):
                rt.array_add(h, delta, sync=False)
            rt.array_add(h, delta)     # the ack covers the tail (FIFO)
        elif mode == "loss":
            for _ in range(4):
                rt.array_add(h, delta, sync=False)
            rt.array_get(h, SIZE)      # drain the pipeline
            time.sleep(0.6)            # outlive -audit_grace_ms
        elif mode == "plain":
            for _ in range(3):
                rt.array_add(h, delta)
            got = rt.array_get(h, SIZE)
            np.testing.assert_allclose(got, 3.0)
            rep = rt.audit_report()
            assert rep["armed"] is False, rep
            print("PLAIN_OK", flush=True)
        ledger = rt.audit_report()["tables"][0]["worker"]
        print(f"LEDGER {json.dumps(ledger)}", flush=True)
    rt.barrier()

    if rank == 0:
        print(f"AUDIT_FLEET {rt.ops_fleet_report('audit')}", flush=True)
    rt.barrier()
    rt.shutdown()
    print(f"AUDIT_DEMO_WORKER_OK {rank}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
