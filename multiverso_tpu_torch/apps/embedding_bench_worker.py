"""Sparse-embedding serving benchmark worker (bench.py
``bench_embedding``; ``make embedding-demo`` drives it too —
docs/embedding.md).

Run as ``python embedding_bench_worker.py <machine_file> <rank> [rows]
[reqs] [demo]``: two of these form a native epoll fleet holding one
row-sharded embedding table (``rows`` x 32, shard-faithful scaled-down
stand-in for the O(10^7)-row recommender table — rank 0 owns the zipf
head, so the hot path is genuinely remote from the driving rank).
Rank 1 then measures the three serving tiers on an identical
zipf-hot-head row-get stream:

- **cold** — serve cache off, replica off: every lookup pays the full
  wire round trip (the carve-out this tentpole closes);
- **row-cached** — :class:`~multiverso_tpu_torch.serve.client.ServeClient`
  with the row-granular cache armed: each hot row is its own versioned
  entry, repeat lookups never touch the wire;
- **replica-hit** — the native hot-key replica armed
  (``-hotkey_replica``): the server pushes its SpaceSaving top-K rows
  and the worker stub serves row gets from the side table in one
  native call — no wire, no Python cache walk.

Plus: the full-zipf(1.0) tail latency through the row-cached client
(``zipf_p99_ms``), bytes/lookup for cold-tail (all-zero) rows with the
sparse reply codec off vs on, and the multi-shard borrowed-vs-staged
``AddRows`` issue-cost A/B (``addrows_borrow_speedup`` — the per-rank
staging copies the borrowed run-iovec path removes).

``demo=1`` adds the correctness assertions ``make embedding-demo``
reports: replica hits > 0, zero stale reads at staleness 0 after a
server-side add (the updated value must be observed within one
replica lease), and an anonymous-client replica pull that surfaces the
planted hot ids.

Rank 1 prints the measured keys; both ranks print ``EMBED_BENCH_OK``.
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from multiverso_tpu_torch import config, native as nat  # noqa: E402
from multiverso_tpu_torch.apps.dlrm import zipf_ids  # noqa: E402
from multiverso_tpu_torch.serve.client import ServeClient  # noqa: E402
from multiverso_tpu_torch.serve.wire import AnonServeClient  # noqa: E402

COLS = 32
IDS_PER_REQ = 8
HOT_K = 32            # the measured hot head (inside the top-K push)
TOPK = 64             # -hotkey_topk: what the server pushes


def _pcts(lat_s):
    lat = np.sort(np.asarray(lat_s, np.float64)) * 1e3
    return (float(lat[int(0.50 * (lat.size - 1))]),
            float(lat[int(0.95 * (lat.size - 1))]),
            float(lat[int(0.99 * (lat.size - 1))]))


def _measure(reqs, fn):
    """Per-request latencies of ``fn(i)`` over ``reqs`` calls."""
    lat = []
    t0 = time.perf_counter()
    for i in range(reqs):
        t = time.perf_counter()
        fn(i)
        lat.append(time.perf_counter() - t)
    wall = time.perf_counter() - t0
    return lat, reqs / wall


def main() -> int:
    mf, rank = sys.argv[1], int(sys.argv[2])
    rows = int(sys.argv[3]) if len(sys.argv) > 3 else 1 << 16
    reqs = int(sys.argv[4]) if len(sys.argv) > 4 else 512
    demo = int(sys.argv[5]) if len(sys.argv) > 5 else 0
    rt = nat.NativeRuntime(args=[
        f"-machine_file={mf}", f"-rank={rank}", "-log_level=error",
        "-rpc_timeout_ms=60000", "-barrier_timeout_ms=120000",
        f"-hotkey_topk={TOPK}", "-replica_lease_ms=1000"])
    assert rt.net_engine() == "epoll", rt.net_engine()
    h = rt.new_matrix_table(rows, COLS)
    h_kv = rt.new_kv_table()
    rt.barrier()

    out = {}
    shard = rows // 2                 # rank 0 owns rows [0, shard)
    if rank == 1:
        rng = np.random.RandomState(11)
        # Seed the hot head with nonzero values (blocking: visible
        # before any measured phase) and teach the server's SpaceSaving
        # sketch who is hot — the cold phase's traffic doubles as the
        # tracker warmup the replica push feeds on.
        rt.matrix_add_rows(
            h, np.arange(HOT_K, dtype=np.int32),
            np.ones((HOT_K, COLS), np.float32))
        hot_stream = zipf_ids(reqs * IDS_PER_REQ, HOT_K,
                              rng).astype(np.int32)
        full_stream = zipf_ids(reqs * IDS_PER_REQ, shard,
                               rng).astype(np.int32)

        def req_ids(stream, i):
            lo = (i % reqs) * IDS_PER_REQ
            return stream[lo:lo + IDS_PER_REQ]

        # --- phase A: cold — cache off, replica off, every get wire ---
        # window_us=0 on BOTH clients: a sequential driver's solo
        # requests must not pay the coalescing window as fake latency
        # (the speedup must come from the cache, not a handicap).
        cold_sc = ServeClient(rt, cache_entries=0, window_us=0.0)
        lat, qps = _measure(reqs, lambda i: cold_sc.matrix_get_rows(
            h, req_ids(hot_stream, i), COLS))
        p50, p95, p99 = _pcts(lat)
        out.update(cold_p50_ms=p50, cold_p95_ms=p95, cold_p99_ms=p99,
                   cold_qps=qps)

        # --- phase B: row-granular cache (docs/embedding.md) ----------
        config.set_flag("serve_row_cache", True)
        sc = ServeClient(rt, cache_entries=8192, max_staleness=0,
                         lease_ms=5000.0, window_us=0.0)
        for i in range(reqs):          # warm: every hot row cached once
            sc.matrix_get_rows(h, req_ids(hot_stream, i), COLS)
        lat, qps = _measure(reqs, lambda i: sc.matrix_get_rows(
            h, req_ids(hot_stream, i), COLS))
        p50, p95, p99 = _pcts(lat)
        out.update(rowcache_p50_ms=p50, rowcache_p99_ms=p99,
                   rowcache_qps=qps)
        out["rowcache_vs_cold_p50"] = out["cold_p50_ms"] / p50

        # Full-zipf(1.0) tail through the row-cached client: the
        # realistic serving mix (head hits, tail misses).
        lat, qps = _measure(reqs, lambda i: sc.matrix_get_rows(
            h, req_ids(full_stream, i), COLS))
        _, _, p99 = _pcts(lat)
        out.update(zipf_p99_ms=p99, zipf_qps=qps)

        # --- phase C: native hot-key replica --------------------------
        rt.set_hotkey_replica(True)
        rt.replica_refresh(h)
        base = rt.replica_stats(h)
        # A serving tier pins its request/reply buffers and calls the C
        # API directly (the replica's real consumers are native
        # frontends — the Lua binding, a C++ inference tier); the
        # Python wrapper's per-call argument validation (~7 us) is not
        # what this phase measures.  Each request copies its 8 ids into
        # the pinned id buffer, then one MV_GetMatrixTableByRows call
        # serves every row from the worker-local replica — zero wire.
        import ctypes

        ids_buf = np.zeros(IDS_PER_REQ, np.int32)
        reply_buf = np.zeros(IDS_PER_REQ * COLS, np.float32)
        fp = reply_buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
        ip = ids_buf.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))

        def replica_req(i):
            np.copyto(ids_buf, req_ids(hot_stream, i))
            rc = rt.lib.MV_GetMatrixTableByRows(h, fp, ip, IDS_PER_REQ,
                                                COLS)
            assert rc == 0, rc

        lat, qps = _measure(reqs, replica_req)
        p50, _, p99 = _pcts(lat)
        stats = rt.replica_stats(h)
        out.update(replica_p50_ms=p50, replica_p99_ms=p99,
                   replica_qps=qps,
                   replica_hits=float(stats["hits"] - base["hits"]),
                   replica_pushes=float(stats["pushes"]))
        out["replica_vs_rowcache_p50"] = out["rowcache_p50_ms"] / p50
        out["replica_hit_rate"] = (
            (stats["hits"] - base["hits"])
            / max(1.0, float(stats["hits"] - base["hits"]
                             + stats["misses"] - base["misses"])))
        rt.set_hotkey_replica(False)

        # --- phase D: bytes/lookup, sparse reply codec off vs on ------
        # Cold-tail ids: untrained (all-zero) rows — the reply payload
        # the lossless sparse codec collapses.
        tail = (shard // 2 + rng.randint(
            0, shard // 2, size=64 * IDS_PER_REQ)).astype(np.int32)
        for codec, key in (("raw", "bytes_per_lookup_raw"),
                           ("sparse", "bytes_per_lookup_sparse")):
            rt.set_table_codec(h, codec)
            before = rt.wire_stats()
            for i in range(64):
                lo = i * IDS_PER_REQ
                cold_sc.matrix_get_rows(h, tail[lo:lo + IDS_PER_REQ],
                                        COLS)
            after = rt.wire_stats()
            moved = (after["sent_bytes"] - before["sent_bytes"]
                     + after["recv_bytes"] - before["recv_bytes"])
            out[key] = moved / (64.0 * IDS_PER_REQ)
        rt.set_table_codec(h, "raw")
        out["sparse_bytes_ratio"] = (out["bytes_per_lookup_raw"]
                                     / max(out["bytes_per_lookup_sparse"],
                                           1e-9))

        # --- phase E: multi-shard borrowed vs staged AddRows ----------
        # Issue-cost A/B (docs/embedding.md): the borrowed run-iovec
        # path removes the per-rank staging copy AND the owning-Blob
        # copy from the caller's async-add path; ids span BOTH shards
        # so the multi-shard plan (not the single-shard fast path)
        # is what runs.  Timed: N async issues; the barrier drains the
        # wire between rounds (untimed) so rounds don't overlap.
        # 2048 rows x 32 cols = 256 KiB per add: big enough that the
        # staging path's two payload copies (per-rank vector + owning
        # Blob) dominate the fixed per-call overhead both paths share.
        K = min(2048, max(256, rows // 4))
        adds = 50
        # Skip rows 0/1: the demo's staleness probe needs the hot head
        # untouched by this phase's noise adds.  SORTED ids — the
        # embedding-friendly batch layout (pipelines already sort for
        # the dedup/segment-sum) — so each shard's rows form ONE
        # contiguous caller-order run and the borrowed path ships one
        # iovec per shard; unsorted hostile interleavings fall back to
        # staging (covered by the native unit, not measured here).
        ids = np.sort(2 + rng.randint(0, rows - 2, size=K)).astype(
            np.int32)
        arena = rt.arena()
        buf = arena.alloc((K, COLS))
        buf[:] = 0.001
        heap = np.full((K, COLS), 0.001, np.float32)

        def time_adds(borrowed):
            best = float("inf")
            for _ in range(3):
                t0 = time.perf_counter()
                for _ in range(adds):
                    rt.matrix_add_rows(h, ids,
                                       buf if borrowed else heap,
                                       sync=False, borrowed=borrowed)
                best = min(best, time.perf_counter() - t0)
                # Drain before the next round: one blocking get per
                # shard rides the per-connection FIFO BEHIND the async
                # adds (rank 0 is in its poll loop — a barrier here
                # would hang).
                rt.matrix_get_rows(h, [0, shard], COLS)
            return best

        t_staged = time_adds(False)
        t_borrow = time_adds(True)
        arena.release(buf)
        out["addrows_staged_ms"] = t_staged * 1e3
        out["addrows_borrowed_ms"] = t_borrow * 1e3
        out["addrows_borrow_speedup"] = t_staged / t_borrow

        if demo:
            assert out["replica_hits"] > 0, out
            # Anonymous-client replica pull: the planted hot ids must
            # surface from rank 0's shard push.
            eps = [ln.strip() for ln in open(mf) if ln.strip()]
            with AnonServeClient(eps[0], timeout=30) as anon:
                rep = anon.get_replica(h)
            hot_in_push = sum(1 for i in range(8) if i in rep)
            out["anon_replica_hot"] = float(hot_in_push)
            assert hot_in_push > 0, sorted(rep)[:10]
            # Staleness-0 cross-rank freshness: rank 0 bumps hot row 1
            # server-side; within one replica lease rank 1 must observe
            # the new value (zero stale reads at staleness 0).
            rt.set_hotkey_replica(True)
            rt.kv_add(h_kv, "poke", 1.0)
            deadline = time.time() + 60
            while rt.kv_get(h_kv, "poked") < 1.0:
                if time.time() > deadline:
                    raise RuntimeError("rank 0 never poked")
                time.sleep(0.02)
            time.sleep(1.2)           # one replica lease (1000 ms)
            fresh = rt.matrix_get_rows(h, [1], COLS)
            assert fresh[0, 0] == 101.0, fresh[0, :4]
            out["stale_reads"] = 0.0
            rt.set_hotkey_replica(False)
        rt.kv_add(h_kv, "done", 1.0)
    else:
        deadline = time.time() + 900
        poked = False
        while rt.kv_get(h_kv, "done") < 1.0:
            if time.time() > deadline:
                raise RuntimeError("driver never finished")
            if demo and not poked and rt.kv_get(h_kv, "poke") >= 1.0:
                # Server-side add from the OTHER rank: row 1 jumps to
                # 101 (1 from seeding + 100 here).
                rt.matrix_add_rows(
                    h, [1], np.full((1, COLS), 100.0, np.float32))
                rt.kv_add(h_kv, "poked", 1.0)
                poked = True
            time.sleep(0.02)

    rt.barrier()
    rt.shutdown()
    kv = " ".join(f"{k}={v:.6f}" for k, v in sorted(out.items()))
    print(f"EMBED_BENCH_OK rank={rank} {kv}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
