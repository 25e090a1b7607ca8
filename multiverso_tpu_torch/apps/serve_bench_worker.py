"""Serve-layer benchmark worker (bench.py's ``bench_serve`` section).

Run as ``python serve_bench_worker.py <machine_file> <rank>``: two of
these form a native TcpNet wire session; rank 0 measures the three
serve-layer read configurations on one sharded ArrayTable and prints a
``SERVE_BENCH_OK key=val ...`` line; rank 1 serves its shard and holds
the rendezvous barriers.

Configurations (docs/serving.md):

- **cold**  — cache disabled: every ``get()`` pays the full wire round
  trip (the reference's read path; the baseline denominator).
- **cached** — versioned cache + a held lease: repeat reads are served
  locally with zero wire messages.
- **coal8** — 8 concurrent uncached readers through the coalescing
  window: per-op latency amortizes one round trip over the batch.
"""

import os
import sys
import threading
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from multiverso_tpu_torch import native as nat  # noqa: E402
from multiverso_tpu_torch.serve import ServeClient  # noqa: E402

SIZE = 4096


def pct(times, q):
    return float(np.percentile(np.asarray(times) * 1e3, q))


def main() -> int:
    mf, rank = sys.argv[1], int(sys.argv[2])
    rt = nat.NativeRuntime(args=[f"-machine_file={mf}", f"-rank={rank}",
                                 "-log_level=error",
                                 "-rpc_timeout_ms=30000"])
    h = rt.new_array_table(SIZE)
    rt.barrier()
    out = {}
    if rank == 0:
        rt.array_add(h, np.ones(SIZE, np.float32))

        cold = ServeClient(rt, cache_entries=0, window_us=0.0)
        times = []
        for _ in range(50):
            t0 = time.perf_counter()
            cold.array_get(h, SIZE)
            times.append(time.perf_counter() - t0)
        out["cold_p50_ms"] = pct(times, 50)
        out["cold_p95_ms"] = pct(times, 95)
        out["cold_p99_ms"] = pct(times, 99)
        out["cold_qps"] = len(times) / sum(times)

        cached = ServeClient(rt, cache_entries=32, max_staleness=0,
                             lease_ms=60000.0, window_us=0.0)
        cached.array_get(h, SIZE)          # warm the entry + the lease
        times = []
        for _ in range(500):
            t0 = time.perf_counter()
            cached.array_get(h, SIZE)
            times.append(time.perf_counter() - t0)
        out["cached_p50_ms"] = pct(times, 50)
        out["cached_p95_ms"] = pct(times, 95)
        out["cached_p99_ms"] = pct(times, 99)
        out["cached_qps"] = len(times) / sum(times)

        coal = ServeClient(rt, cache_entries=0, window_us=200.0)
        all_times = [[] for _ in range(8)]
        start = threading.Barrier(8)

        def reader(i):
            start.wait()
            for _ in range(25):
                t0 = time.perf_counter()
                coal.array_get(h, SIZE)
                all_times[i].append(time.perf_counter() - t0)

        t0 = time.perf_counter()
        ts = [threading.Thread(target=reader, args=(i,)) for i in range(8)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        wall = time.perf_counter() - t0
        flat = [x for ts_ in all_times for x in ts_]
        out["coal8_p50_ms"] = pct(flat, 50)
        out["coal8_p95_ms"] = pct(flat, 95)
        out["coal8_p99_ms"] = pct(flat, 99)
        out["coal8_qps"] = len(flat) / wall
    rt.barrier()
    rt.shutdown()
    kv = " ".join(f"{k}={v:.6f}" for k, v in out.items())
    print(f"SERVE_BENCH_OK rank={rank} {kv}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
