"""Replication/failover fleet driver (not a pytest module;
docs/replication.md).

Run as ``python failover_worker.py <machine_file> <rank> [extra
flags...]``: joins an N-rank native fleet with ``-replication_factor=1
-repl_sync=true`` and a fast symmetric heartbeat lease, registers
ArrayTable 0 (12 elements — one 4-element shard per rank at N=3) and
MatrixTable 1 (12x4), does one acked warm add per rank, verifies
convergence, prints ``FAILOVER_READY`` — then serves stdin COMMANDS
until ``done`` (each acked with ``OK <cmd>`` so the pytest side
sequences without sleeps):

- ``sums``            print ``SUMS <json>`` — this rank's audit
                      checksums: own shard beacons, backup-shard
                      beacons, and which shard it backs
- ``repl``            print ``REPL <json>`` — routing epoch, shard
                      owners, replication stats
- ``waitdead <n>``    poll until >= n peers are lease-dead (15 s cap)
- ``waitowner <s> <r>``  poll until shard s routes to rank r
- ``add <v>``         acked add of ``v`` ones to BOTH tables, retried
                      through promotion races (bounded)
- ``get``             print ``VALUES <json>`` — array values + per-row
                      matrix sums
- ``barrier``         print ``BARRIER ok|failed`` (dead-leased ranks
                      are excused from the quorum with replication on)
- ``audit_fleet`` / ``repl_fleet``  print the fleet-scope report JSON
- ``mon <name>``      print ``MON <name>=<count>``
- ``fault <k> <n>`` / ``fault_rate <k> <r>`` / ``clear``  chaos knobs
- ``join <shard>``    MV_ReplJoin: become shard's backup live
- ``exit_hard``       ``os._exit(0)`` (rank-0-kill mode: no barrier
                      authority is left to shut down through)

The pytest side (tests/test_failover.py) SIGKILLs a rank mid-hold and
drives the survivors through detection, promotion, re-routed traffic,
and the mvaudit zero-lost-acked-adds diff.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import numpy as np  # noqa: E402

from multiverso_tpu_torch import native as nat  # noqa: E402

SIZE = 12
MROWS = 12
MCOLS = 4


def main() -> int:
    mf, rank = sys.argv[1], int(sys.argv[2])
    extra = sys.argv[3:]
    nranks = len(open(mf).read().split())
    rt = nat.NativeRuntime(args=[
        f"-machine_file={mf}", f"-rank={rank}", "-log_level=error",
        "-rpc_timeout_ms=3000", "-barrier_timeout_ms=20000",
        "-heartbeat_ms=100", "-heartbeat_timeout_ms=400",
        "-replication_factor=1", "-repl_sync=true", "-promote_auto=true",
        "-send_retries=2", "-send_backoff_ms=20",
        "-connect_retry_ms=500", "-ops_fleet_timeout_ms=1500", *extra])
    h = rt.new_array_table(SIZE)
    hm = rt.new_matrix_table(MROWS, MCOLS)
    rt.barrier()

    ones = np.ones(SIZE, np.float32)
    mones = np.ones((MROWS, MCOLS), np.float32)
    all_rows = list(range(MROWS))
    rt.array_add(h, ones)
    rt.matrix_add_rows(hm, all_rows, mones)
    rt.barrier()
    out = rt.array_get(h, SIZE)
    assert np.allclose(out, float(nranks)), out
    print("FAILOVER_READY", flush=True)

    def checked_add(v: float) -> None:
        # Blocking adds retried through the promotion window: a
        # dead-shard add fails fast (rc -3) until the epoch flip
        # re-routes it.  Whole-table adds are only exactness-safe once
        # every shard routes to a live rank, so callers sequence this
        # AFTER waitowner.
        for table_add in (
                lambda: rt.array_add(h, v * ones),
                lambda: rt.matrix_add_rows(hm, all_rows, v * mones)):
            for attempt in range(40):
                try:
                    table_add()
                    break
                except RuntimeError:
                    time.sleep(0.1)
            else:
                raise RuntimeError("add never succeeded post-failover")

    for line in sys.stdin:
        parts = line.split()
        if not parts or parts[0] == "done":
            break
        cmd = parts[0]
        if cmd == "sums":
            doc = rt.audit_report()
            t0 = doc["tables"][0]
            print("SUMS " + json.dumps({
                "backup_shard": doc.get("backup_shard", -1),
                "server": t0.get("checksums"),
                "backup": t0.get("backup_checksums"),
            }), flush=True)
        elif cmd == "repl":
            print("REPL " + json.dumps({
                "epoch": rt.routing_epoch(),
                "owners": [rt.shard_owner(s) for s in range(nranks)],
                "backup_shard": rt.backup_shard(),
                "stats": rt.replication_stats(),
            }), flush=True)
        elif cmd == "waitdead":
            want = int(parts[1])
            deadline = time.monotonic() + 15
            while time.monotonic() < deadline:
                if rt.dead_peer_count() >= want:
                    break
                time.sleep(0.05)
            print(f"DEAD {rt.dead_peer_count()}", flush=True)
        elif cmd == "waitowner":
            shard, want = int(parts[1]), int(parts[2])
            deadline = time.monotonic() + 15
            owner = -1
            while time.monotonic() < deadline:
                owner = rt.shard_owner(shard)
                if owner == want:
                    break
                time.sleep(0.05)
            print(f"OWNER {shard}={owner}", flush=True)
        elif cmd == "add":
            checked_add(float(parts[1]))
        elif cmd == "get":
            vals = rt.array_get(h, SIZE)
            rows = rt.matrix_get_rows(hm, all_rows, MCOLS)
            print("VALUES " + json.dumps({
                "array": [float(v) for v in vals],
                "row_sums": [float(s) for s in rows.sum(axis=1)],
            }), flush=True)
        elif cmd == "barrier":
            try:
                rt.barrier()
                print("BARRIER ok", flush=True)
            except RuntimeError:
                print("BARRIER failed", flush=True)
        elif cmd == "audit_fleet":
            print("AUDIT_FLEET " + rt.ops_fleet_report("audit"),
                  flush=True)
        elif cmd == "repl_fleet":
            print("REPL_FLEET " + rt.ops_fleet_report("replication"),
                  flush=True)
        elif cmd == "mon":
            print(f"MON {parts[1]}={rt.query_monitor(parts[1])}",
                  flush=True)
        elif cmd == "fault":
            rt.set_fault_seed(1234)
            rt.set_fault_n(parts[1], int(parts[2]))
        elif cmd == "fault_rate":
            rt.set_fault_seed(1234)
            rt.set_fault(parts[1], float(parts[2]))
        elif cmd == "clear":
            rt.clear_faults()
        elif cmd == "join":
            rt.repl_join(int(parts[1]))
        elif cmd == "exit_hard":
            sys.stdout.flush()
            os._exit(0)
        print(f"OK {cmd}", flush=True)
    rt.shutdown()
    print(f"FAILOVER_WORKER_OK {rank}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
