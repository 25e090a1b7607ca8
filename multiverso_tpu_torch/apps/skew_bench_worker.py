"""Workload-skew benchmark worker (bench.py ``bench_skew``; ``make
skew-demo`` drives it too — docs/observability.md, workload plane).

Run as ``python skew_bench_worker.py <machine_file> <rank> [nclients]
[rows] [reqs] [nan]``: two of these form a native epoll fleet with two
row-sharded MatrixTables; rank 1 then drives an ANONYMOUS client herd
(the serve wire protocol) of row-Gets against rank 0's reactor in three
phases:

- **zipf phase** — row ids drawn zipf(1.0) over rank 0's shard (the
  planted hot keys are the distribution head: ids 0..4).  The scraped
  ``"hotkeys"`` report must surface them in the top-K and show a
  bucket-load skew ratio well above 1.
- **uniform phase** — the same request count with uniform ids on the
  second table: its skew ratio must collapse toward 1 (the control).
- **overhead phase** — the zipf herd re-run with the workload
  accounting DISARMED on rank 0 (coordinated through a KV flag;
  ``MV_SetHotKeyTracking``): ``hotkey_track_overhead_pct`` is the
  armed-vs-disarmed QPS delta — the acceptance bar says the sketches
  cost < 2% of serve throughput.

``nan=1`` (the demo mode) finishes with rank 0 blocking-adding a
NaN-poisoned row delta to a scratch table: the update-health sentinel
must dump ``blackbox_rank0.json`` naming the table.

Rank 1 prints the measured keys; both ranks print ``SKEW_BENCH_OK``.
"""

import os
import selectors
import socket
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from multiverso_tpu_torch import native as nat  # noqa: E402
from multiverso_tpu_torch.ops.introspect import OpsClient  # noqa: E402
from multiverso_tpu_torch.serve.wire import (FrameDecoder, MSG,  # noqa: E402
                                       pack_frame, unpack_frame)

COLS = 8
HOT_KEYS = 5          # planted head of the zipf distribution: ids 0..4
IDS_PER_REQ = 8
WINDOW = 8            # outstanding requests while pacing the herd


def _zipf_ids(n, k, rng):
    """n draws from zipf(1.0) over [0, k) — p(i) ∝ 1/(i+1)."""
    p = 1.0 / np.arange(1, k + 1, dtype=np.float64)
    p /= p.sum()
    return rng.choice(k, size=n, p=p).astype(np.int32)


def _raise_fd_limit(need):
    import resource

    soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
    if soft < need:
        resource.setrlimit(resource.RLIMIT_NOFILE,
                           (min(max(need, soft), hard), hard))


class Herd:
    """nclients anonymous sockets driving paced row-Gets (the
    fanin_bench_worker pacing discipline: WINDOW outstanding)."""

    def __init__(self, endpoint, nclients):
        host, port = endpoint.rsplit(":", 1)
        _raise_fd_limit(nclients + 256)
        self.sel = selectors.DefaultSelector()
        self.socks = []
        for i in range(nclients):
            s = socket.socket()
            s.connect((host, int(port)))
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            s.setblocking(False)
            self.sel.register(s, selectors.EVENT_READ,
                              {"dec": FrameDecoder(), "id": i})
            self.socks.append(s)
        self._mid = 0

    def run_phase(self, table_id, ids, deadline_s=300):
        """Send one row-Get (IDS_PER_REQ ids) per request, paced WINDOW
        outstanding, cycling the id stream; returns (replies, secs)."""
        nreq = len(ids) // IDS_PER_REQ
        got = 0
        t0 = time.perf_counter()
        deadline = time.time() + deadline_s
        for base in range(0, nreq, WINDOW):
            batch = min(WINDOW, nreq - base)
            for j in range(batch):
                s = self.socks[(base + j) % len(self.socks)]
                self._mid += 1
                lo = (base + j) * IDS_PER_REQ
                blob = ids[lo:lo + IDS_PER_REQ].tobytes()
                s.sendall(pack_frame(MSG["RequestGet"], table_id,
                                     self._mid, blobs=[blob],
                                     qos=(0, 60_000_000_000)))
            need = got + batch
            while got < need and time.time() < deadline:
                for key, _ in self.sel.select(timeout=1.0):
                    data = key.data
                    try:
                        chunk = key.fileobj.recv(65536)
                    except BlockingIOError:
                        continue
                    if not chunk:
                        raise RuntimeError(f"conn {data['id']} died")
                    data["dec"].feed(chunk)
                    while True:
                        body = data["dec"].next_frame()
                        if body is None:
                            break
                        reply = unpack_frame(body)
                        assert reply["type_name"] == "ReplyGet", reply
                        got += 1
            if got < need:
                raise RuntimeError(
                    f"herd stalled: {got}/{need} replies")
        return got, time.perf_counter() - t0

    def close(self):
        for s in self.socks:
            self.sel.unregister(s)
            s.close()


def main() -> int:
    mf, rank = sys.argv[1], int(sys.argv[2])
    nclients = int(sys.argv[3]) if len(sys.argv) > 3 else 256
    rows = int(sys.argv[4]) if len(sys.argv) > 4 else 2048
    reqs = int(sys.argv[5]) if len(sys.argv) > 5 else 512
    nan = int(sys.argv[6]) if len(sys.argv) > 6 else 0
    trace_dir = os.environ.get("MVTPU_SKEW_TRACE_DIR", "")
    extra = [f"-trace_dir={trace_dir}"] if trace_dir else []
    rt = nat.NativeRuntime(args=[
        f"-machine_file={mf}", f"-rank={rank}", "-log_level=error",
        "-rpc_timeout_ms=60000", "-barrier_timeout_ms=120000",
        "-hotkey_topk=64", *extra])
    assert rt.net_engine() == "epoll", rt.net_engine()
    h_zipf = rt.new_matrix_table(rows, COLS)
    h_uni = rt.new_matrix_table(rows, COLS)
    h_kv = rt.new_kv_table()
    h_nan = rt.new_matrix_table(4, 2)     # NaN-sentinel scratch table
    rt.barrier()

    out = {}
    shard = rows // 2                     # rank 0 owns rows [0, shard)
    if rank == 1:
        eps = [ln.strip() for ln in open(mf) if ln.strip()]
        rng = np.random.RandomState(7)
        zipf_ids = _zipf_ids(reqs * IDS_PER_REQ, shard, rng)
        uni_ids = rng.randint(0, shard,
                              size=reqs * IDS_PER_REQ).astype(np.int32)

        # A few worker-stub gets so the observed-staleness histogram
        # has stamped samples (anonymous clients stamp no version).
        rt.matrix_add_rows(h_zipf, [1], np.ones((1, COLS), np.float32))
        for _ in range(4):
            rt.matrix_get_rows(h_zipf, [0, 1, 2], COLS)

        herd = Herd(eps[0], nclients)
        # A FULL warmup phase first: connections, reactor state, branch
        # predictors and the python client path all settle before either
        # measured phase runs — the armed-vs-disarmed delta must be the
        # sketches, not cold-start order effects.
        herd.run_phase(h_zipf, zipf_ids)
        n_armed, t_armed = herd.run_phase(h_zipf, zipf_ids)
        herd.run_phase(h_uni, uni_ids)

        with OpsClient(eps[0], timeout=30) as c:
            report = {t["id"]: t for t in c.hotkeys()}
        zt, ut = report[h_zipf], report[h_uni]
        out["skew_ratio_zipf"] = zt["skew_ratio"]
        out["skew_ratio_uniform"] = ut["skew_ratio"]
        top = [e["key"] for e in zt["hotkeys"]["topk"]]
        out["hot_expected"] = float(HOT_KEYS)
        out["hot_hits"] = float(
            sum(1 for i in range(HOT_KEYS) if str(i) in top))
        out["staleness_count"] = float(zt["staleness_count"])

        # Overhead A/B: rank 0 disarms, the identical zipf phase reruns.
        # Disarmed runs LAST (warmest), so any residual warmup drift
        # inflates qps_disarmed — the overhead estimate errs high, never
        # flatters the sketches.
        rt.kv_add(h_kv, "disarm", 1.0)
        deadline = time.time() + 60
        while rt.kv_get(h_kv, "disarmed") < 1.0:
            if time.time() > deadline:
                raise RuntimeError("rank 0 never disarmed")
            time.sleep(0.02)
        n_off, t_off = herd.run_phase(h_zipf, zipf_ids)
        herd.close()
        qps_on = n_armed / t_armed
        qps_off = n_off / t_off
        out["skew_qps_armed"] = qps_on
        out["skew_qps_disarmed"] = qps_off
        out["hotkey_track_overhead_pct"] = max(
            0.0, (qps_off - qps_on) / qps_off * 100.0)
        rt.kv_add(h_kv, "herd_done", 1.0)
    else:
        deadline = time.time() + 600
        disarmed = False
        while rt.kv_get(h_kv, "herd_done") < 1.0:
            if time.time() > deadline:
                raise RuntimeError("herd never finished")
            if not disarmed and rt.kv_get(h_kv, "disarm") >= 1.0:
                rt.set_hotkey_tracking(False)
                disarmed = True
                rt.kv_add(h_kv, "disarmed", 1.0)
            time.sleep(0.02)
        rt.set_hotkey_tracking(True)

    rt.barrier()
    if rank == 0 and nan:
        # Update-health sentinel: one NaN-poisoned blocking add to the
        # scratch table (row 0 lives on this rank) must trip the
        # flight recorder and dump blackbox_rank0.json naming it.
        poison = np.full((1, 2), np.nan, np.float32)
        rt.matrix_add_rows(h_nan, [0], poison)
        stats = rt.table_load_stats(h_nan)
        assert stats["nan_count"] >= 1, stats
        out["nan_count"] = float(stats["nan_count"])
        out["nan_table"] = float(h_nan)
    rt.barrier()
    rt.shutdown()
    kv = " ".join(f"{k}={v:.6f}" for k, v in sorted(out.items()))
    print(f"SKEW_BENCH_OK rank={rank} {kv}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
