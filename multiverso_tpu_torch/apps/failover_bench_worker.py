"""bench_failover fleet (docs/replication.md; bench.py schema 18).

Run as ``python failover_bench_worker.py <machine_file> <rank>
[herd_threads] [reads_per_arm]``: a THREE-rank replicated epoll fleet
(``-replication_factor=1 -repl_sync=true``, fast symmetric leases).

- **rank 0** measures.  Phase A (healthy fleet): an in-process
  anonymous read herd against its own reactor, replication armed vs
  disarmed in interleaved arms (the A/B discipline — separate
  herds swing several-fold with host load) → ``repl_overhead_pct``
  (reads never forward, so the armed cost is one routed-table check).
  Phase B: a continuous blocking-add loop with per-success
  timestamps; rank 1 SIGKILLs itself mid-loop — the loop rides the
  blackout (fail-fast retries) through promotion and out the other
  side.  Keys: ``failover_detect_ms`` (last pre-blackout success →
  lease expiry seen locally), ``failover_promote_ms`` (→ shard 1
  routed at rank 2), ``failover_p99_blip_ms`` (widest gap between
  consecutive successful adds — the caller-visible outage),
  ``failover_lost_acked_adds`` (fleet ``"audit"`` diff over the rank
  wire: an acked add missing from the promoted shard's book would be
  the contract violation; failed attempts' seq holes are named gaps /
  unacked tails, never lost).
- **rank 1** is the victim: it waits out a beat of phase B, prints
  nothing more, and SIGKILLs itself (no goodbye).
- **rank 2** is shard 1's chained backup: it serves, promotes on the
  lease expiry, and rendezvouses with rank 0 at the end (the corpse
  is excused from the quorum).

Ranks 0 and 2 print ``FAILOVER_BENCH_OK``; rank 1 never does (the
bench's spawner exempts the victim).
"""

import json
import os
import signal
import sys
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import numpy as np  # noqa: E402

from multiverso_tpu_torch import native as nat  # noqa: E402

SIZE = 24


def _median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2] if xs else 0.0


def main() -> int:
    mf, rank = sys.argv[1], int(sys.argv[2])
    herd_threads = int(sys.argv[3]) if len(sys.argv) > 3 else 4
    reads_per_arm = int(sys.argv[4]) if len(sys.argv) > 4 else 150
    eps = open(mf).read().split()
    rt = nat.NativeRuntime(args=[
        f"-machine_file={mf}", f"-rank={rank}", "-log_level=error",
        "-rpc_timeout_ms=1500", "-barrier_timeout_ms=60000",
        "-heartbeat_ms=100", "-heartbeat_timeout_ms=400",
        "-replication_factor=1", "-repl_sync=true", "-promote_auto=true",
        "-send_retries=1", "-send_backoff_ms=10",
        "-connect_retry_ms=500", "-ops_fleet_timeout_ms=1500"])
    h = rt.new_array_table(SIZE)
    rt.barrier()
    ones = np.ones(SIZE, np.float32)
    rt.array_add(h, ones)
    rt.barrier()

    if rank == 1:
        # The victim: let phase A finish (it runs pre-kill, healthy),
        # ride one beat of the add loop, then die with no goodbye.
        rt.barrier()          # phase A done fleet-wide
        time.sleep(1.2)
        sys.stdout.flush()
        os.kill(os.getpid(), signal.SIGKILL)
        return 0              # unreachable

    if rank == 2:
        rt.barrier()          # phase A done fleet-wide
        # Serve through the kill + promotion; rank 0's final barrier
        # (corpse excused) releases us.
        rt.barrier()
        st = rt.replication_stats()
        print(f"rank=2 promotions={st['promotions']} "
              f"applied={st['applied']}", flush=True)
        rt.shutdown()
        print("FAILOVER_BENCH_OK 2", flush=True)
        return 0

    # ---------------- rank 0: phase A — read-path overhead A/B --------
    from multiverso_tpu_torch.serve.wire import AnonServeClient

    def herd_qps() -> float:
        counts = [0] * herd_threads
        errs = []

        def reader(i):
            try:
                c = AnonServeClient(eps[0], timeout=10.0, timing=False)
                for _ in range(reads_per_arm):
                    c.get_shard(h)
                    counts[i] += 1
                c.close()
            except (ConnectionError, OSError) as e:  # pragma: no cover
                errs.append(e)

        threads = [threading.Thread(target=reader, args=(i,))
                   for i in range(herd_threads)]
        t0 = time.monotonic()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        dt = time.monotonic() - t0
        if errs:
            raise errs[0]
        return sum(counts) / dt if dt > 0 else 0.0

    herd_qps()  # warm the sockets/route out of the measurement
    on_arms, off_arms = [], []
    for arm in ("on", "off", "on", "off", "on", "off"):
        rt.set_replication(arm == "on")
        (on_arms if arm == "on" else off_arms).append(herd_qps())
    rt.set_replication(True)
    qps_on, qps_off = _median(on_arms), _median(off_arms)
    overhead = ((qps_off - qps_on) / qps_off * 100.0) if qps_off else 0.0
    print(f"rank=0 repl_overhead_pct={max(overhead, 0.0):.3f} "
          f"repl_read_qps={qps_on:.1f}", flush=True)
    rt.barrier()              # release the victim's death timer

    # ---------------- phase B: add loop through the blackout ----------
    succ_ts = []              # monotonic stamps of successful adds
    lat = []                  # per-success add latency (s)
    t_dead = None
    t_owner = None
    fails = 0
    deadline = time.monotonic() + 25.0
    settled = 0
    while time.monotonic() < deadline:
        t0 = time.monotonic()
        try:
            rt.array_add(h, ones)
            succ_ts.append(time.monotonic())
            lat.append(succ_ts[-1] - t0)
        except RuntimeError:
            fails += 1
        if t_dead is None and rt.dead_peer_count() >= 1:
            t_dead = time.monotonic()
        if t_owner is None and rt.shard_owner(1) == 2:
            t_owner = time.monotonic()
        if t_owner is not None:
            settled += 1
            if settled >= 30:
                break
    assert t_dead is not None and t_owner is not None, \
        "failover never observed"
    assert fails > 0 or succ_ts, "add loop never ran"
    # Blackout anchored at the last success BEFORE the widest gap.
    gaps = [(succ_ts[i + 1] - succ_ts[i], succ_ts[i])
            for i in range(len(succ_ts) - 1)]
    blip_s, t_blackout = max(gaps) if gaps else (0.0, t_dead)
    detect_ms = max(t_dead - t_blackout, 0.0) * 1e3
    promote_ms = max(t_owner - t_blackout, 0.0) * 1e3
    lat_ms = sorted(x * 1e3 for x in lat)
    p50 = lat_ms[len(lat_ms) // 2] if lat_ms else 0.0

    # The auditor's verdict, assembled over the rank wire (the corpse
    # is silent; the PROMOTED shard's backup book answers for shard 1).
    from multiverso_tpu_torch.ops.audit import diff_fleet

    fleet = json.loads(rt.ops_fleet_report("audit"))
    lost = [f for f in diff_fleet(fleet) if f["kind"] == "lost"]

    print(f"rank=0 failover_detect_ms={detect_ms:.1f} "
          f"failover_promote_ms={promote_ms:.1f} "
          f"failover_p99_blip_ms={blip_s * 1e3:.1f} "
          f"failover_add_p50_ms={p50:.3f} "
          f"failover_adds_ok={len(succ_ts)} failover_add_fails={fails} "
          f"failover_lost_acked_adds={len(lost)}", flush=True)
    rt.barrier()              # survivor rendezvous (corpse excused)
    rt.shutdown()
    print("FAILOVER_BENCH_OK 0", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
