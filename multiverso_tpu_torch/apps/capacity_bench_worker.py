"""Capacity-plane benchmark worker (bench.py ``bench_capacity``; ``make
capacity-demo`` drives it too — docs/observability.md, "capacity
plane").

Run as ``python capacity_bench_worker.py <machine_file> <rank>
[nclients] [rows] [reqs] [demo]``: the ranks form a native epoll fleet
holding one row-sharded MatrixTable and one KV table; the LAST rank
then drives an anonymous zipf row-get herd against rank 0's reactor in
INTERLEAVED armed/disarmed sweeps (``MV_SetCapacityTracking``
coordinated through a KV flag table, three pairs, best-of per arm — the
audit-bench discipline: one persistent herd, so connect noise
cancels out of the A/B).  Each sweep also batch-inserts FRESH keys into
the KV table from the driver's worker stub — the one table path where
the capacity accounting actually rides the hot loop (matrix shards are
fixed-size).

Measured keys (driver rank prints them):

- ``capacity_overhead_pct`` — armed-vs-disarmed sweep cost
  (acceptance: < 1%; the armed delta is one relaxed load per op plus
  three relaxed bumps per NEW KV key).
- ``capacity_bytes_accuracy`` — fleet-scraped resident bytes of the
  matrix table over its ground truth (rows x cols x 4, the walkable
  shape) — acceptance within 10% of 1.0.
- ``capacity_kv_accuracy`` — same for the KV table against the
  documented per-entry formula (key + value + overhead).
- ``mvplan_spread_after`` — the placement advisor's projected
  per-shard byte spread over the scraped fleet (acceptance: <= 2x).

``demo=1`` (the capacity-demo mode) additionally loads a LARGE array
table on rank 0 mid-run and reports the RSS/arena movement the demo
asserts.  Every rank prints ``CAPACITY_BENCH_OK``.
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from multiverso_tpu_torch import native as nat  # noqa: E402
from multiverso_tpu_torch.ops.introspect import OpsClient  # noqa: E402
from multiverso_tpu_torch.apps.skew_bench_worker import (  # noqa: E402
    Herd, _zipf_ids)

from multiverso_tpu_torch.tools import mvplan  # noqa: E402

COLS = 8
KV_BATCH = 1024          # fresh keys inserted per sweep
SWEEP_PAIRS = 3          # interleaved on/off pairs
KV_OVERHEAD = 64         # native capacity::kKVEntryOverhead


def _await_flag(rt, h_kv, name, deadline_s=120):
    deadline = time.time() + deadline_s
    while rt.kv_get(h_kv, name) < 1.0:
        if time.time() > deadline:
            raise RuntimeError(f"flag {name} never raised")
        time.sleep(0.02)


def main() -> int:
    mf, rank = sys.argv[1], int(sys.argv[2])
    nclients = int(sys.argv[3]) if len(sys.argv) > 3 else 256
    rows = int(sys.argv[4]) if len(sys.argv) > 4 else 2048
    reqs = int(sys.argv[5]) if len(sys.argv) > 5 else 512
    demo = int(sys.argv[6]) if len(sys.argv) > 6 else 0
    eps = [ln.strip() for ln in open(mf) if ln.strip()]
    nranks = len(eps)
    driver = nranks - 1
    rt = nat.NativeRuntime(args=[
        f"-machine_file={mf}", f"-rank={rank}", "-log_level=error",
        "-rpc_timeout_ms=60000", "-barrier_timeout_ms=120000",
        "-capacity_history_ms=0"])
    assert rt.net_engine() == "epoll", rt.net_engine()
    h_mat = rt.new_matrix_table(rows, COLS)
    h_kv = rt.new_kv_table()       # the measured growing table
    h_flags = rt.new_kv_table()    # coordination flags
    rt.barrier()

    out = {}
    if rank == driver:
        rng = np.random.RandomState(11)
        shard = rows // nranks                 # rank 0's row block
        zipf_ids = _zipf_ids(reqs * 8, max(shard, 1), rng)
        herd = Herd(eps[0], nclients)
        herd.run_phase(h_mat, zipf_ids)        # full warmup sweep

        kv_keys = 0
        kv_bytes = 0

        def sweep(tag, sweep_no):
            """One timed sweep: a zipf get herd + a fresh-key insert
            batch (the armed hot paths)."""
            nonlocal kv_keys, kv_bytes
            keys = [f"{tag}-{sweep_no}-{i}" for i in range(KV_BATCH)]
            t0 = time.perf_counter()
            got, _ = herd.run_phase(h_mat, zipf_ids)
            rt.kv_add(h_kv, keys, np.ones(KV_BATCH, np.float32))
            dt = time.perf_counter() - t0
            kv_keys += KV_BATCH
            kv_bytes += sum(len(k) + 4 + KV_OVERHEAD for k in keys)
            return (got + KV_BATCH) / dt

        on_qps, off_qps = [], []
        for pair in range(SWEEP_PAIRS):
            # Armed sweep (both the server rank and this driver arm).
            rt.set_capacity_tracking(True)
            rt.kv_add(h_flags, f"arm-{pair}", 1.0)
            _await_flag(rt, h_flags, f"armed-{pair}")
            on_qps.append(sweep("on", pair))
            # Disarmed sweep.
            rt.set_capacity_tracking(False)
            rt.kv_add(h_flags, f"disarm-{pair}", 1.0)
            _await_flag(rt, h_flags, f"disarmed-{pair}")
            off_qps.append(sweep("off", pair))
        rt.set_capacity_tracking(True)
        rt.kv_add(h_flags, "rearm", 1.0)
        _await_flag(rt, h_flags, "rearmed")

        qps_on = max(on_qps)      # best-of: host noise errs the A/B
        qps_off = max(off_qps)
        out["capacity_qps_armed"] = qps_on
        out["capacity_qps_disarmed"] = qps_off
        out["capacity_overhead_pct"] = max(
            0.0, (qps_off - qps_on) / qps_off * 100.0)

        # Fleet scrape -> accuracy + the advisor's projected spread.
        # (Tracking was re-armed above, which RESYNCS the disarmed-
        # sweep inserts into the books — accuracy covers both paths.)
        with OpsClient(eps[0], timeout=30) as c:
            fleet = c.capacity(fleet=True)
        mat_bytes = kv_rep_bytes = 0
        for rep in (fleet.get("ranks") or {}).values():
            for t in (rep or {}).get("tables") or []:
                if not t.get("shard"):
                    continue
                if t["id"] == h_mat:
                    mat_bytes += t["shard"]["resident_bytes"]
                elif t["id"] == h_kv:
                    kv_rep_bytes += t["shard"]["resident_bytes"]
        out["capacity_bytes_accuracy"] = (
            mat_bytes / float(rows * COLS * 4))
        out["capacity_kv_accuracy"] = (
            kv_rep_bytes / float(max(kv_bytes, 1)))

        proposal = mvplan.propose(fleet)
        plan = proposal["tables"].get(str(h_mat))
        assert plan is not None, sorted(proposal["tables"])
        out["mvplan_spread_after"] = plan["spread_after"]["weight"]
        out["mvplan_moves"] = float(len(plan["moves"]))

        if demo:
            # (a) Skewed bucket BYTES: mine keys whose KVHash bucket
            # sits in [0, 8) (the Python sketch mirror is byte-
            # identical to the native hash) and insert them — the KV
            # table's resident bytes pile into 8 of 64 buckets.
            from multiverso_tpu_torch.sketch import key_hash

            mined, i = [], 0
            while len(mined) < 2048:
                k = f"hotbucket-{i}"
                i += 1
                if key_hash(k) % 64 < 8:
                    mined.append(k)
            rt.kv_add(h_kv, mined, np.ones(len(mined), np.float32))

            def scrape():
                with OpsClient(eps[0], timeout=30) as c:
                    return c.capacity(fleet=True)

            def fold_buckets(doc, tid, field):
                total = [0] * 64
                for rep in (doc.get("ranks") or {}).values():
                    for t in (rep or {}).get("tables") or []:
                        if t.get("id") != tid or not t.get("shard"):
                            continue
                        vals = t["shard"].get(field) or []
                        if field == "bucket_gets":
                            adds = t["shard"].get("bucket_adds") or []
                            vals = [g + a for g, a in zip(vals, adds)]
                        for b, v in enumerate(vals[:64]):
                            total[b] += v
                return total

            def skew(vals):
                mean = sum(vals) / float(len(vals) or 1)
                return max(vals) / mean if mean > 0 else 0.0

            before = scrape()
            out["demo_bytes_skew"] = skew(
                fold_buckets(before, h_kv, "bucket_bytes"))
            out["demo_load_skew"] = skew(
                fold_buckets(before, h_mat, "bucket_gets"))
            rss0 = before["ranks"]["0"]["proc"]["rss_bytes"]
            arena0 = before["ranks"]["0"]["gauges"].get(
                "host_arena.bytes", 0)
            # (b) Big table + arena buffer land on rank 0: RSS and the
            # arena gauge must MOVE in the next scrape.
            rt.kv_add(h_flags, "bigload", 1.0)
            _await_flag(rt, h_flags, "bigloaded")
            after = scrape()
            out["demo_rss_delta"] = float(
                after["ranks"]["0"]["proc"]["rss_bytes"] - rss0)
            out["demo_arena_delta"] = float(
                after["ranks"]["0"]["gauges"].get("host_arena.bytes", 0)
                - arena0)
            # The advisor over the post-load fleet: the rank-0-only big
            # table reads as observed imbalance; the proposal's
            # projected spread must still pack <= 2x.
            proposal = mvplan.propose(after)
            out["mvplan_spread_after"] = max(
                p["spread_after"]["weight"]
                for p in proposal["tables"].values())
            out["demo_observed_spread"] = mvplan.max_observed_spread(
                proposal)
        herd.close()
        rt.kv_add(h_flags, "herd_done", 1.0)
    else:
        deadline = time.time() + 600
        pair = 0
        state = "arm"
        while rt.kv_get(h_flags, "herd_done") < 1.0:
            if time.time() > deadline:
                raise RuntimeError("herd never finished")
            if pair < SWEEP_PAIRS and \
                    rt.kv_get(h_flags, f"{state}-{pair}") >= 1.0:
                rt.set_capacity_tracking(state == "arm")
                ack = "armed" if state == "arm" else "disarmed"
                if rank == 0:
                    rt.kv_add(h_flags, f"{ack}-{pair}", 1.0)
                if state == "arm":
                    state = "disarm"
                else:
                    state, pair = "arm", pair + 1
            if rt.kv_get(h_flags, "rearm") >= 1.0:
                rt.set_capacity_tracking(True)
                if rank == 0:
                    rt.kv_add(h_flags, "rearmed", 1.0)
            if demo and rank == 0 and \
                    rt.kv_get(h_flags, "bigload") >= 1.0 and \
                    rt.kv_get(h_flags, "bigloaded") < 1.0:
                # Demo: a big table + a pinned arena buffer land
                # mid-run — the next scrape's RSS and arena gauges
                # must move (the demo asserts the deltas fleet-side).
                big = rt.new_matrix_table(1 << 15, 64)  # ~8 MiB resident
                arena_buf = rt.arena().alloc(1 << 20)   # 4 MiB pinned
                arena_buf[:] = 1.0
                rep = rt.capacity_report()
                entry = rep["tables"][big]["shard"]
                print(f"DEMO_BIG_TABLE id={big} "
                      f"bytes={entry['resident_bytes']}", flush=True)
                rt.kv_add(h_flags, "bigloaded", 1.0)
            time.sleep(0.02)
        rt.set_capacity_tracking(True)

    rt.barrier()
    rt.shutdown()
    kv = " ".join(f"{k}={v:.6f}" for k, v in sorted(out.items()))
    print(f"CAPACITY_BENCH_OK rank={rank} {kv}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
