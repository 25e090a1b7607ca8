"""Serve-tier fan-in benchmark worker (bench.py ``bench_serve_fanin``;
``make fanin-demo`` drives it too).

Run as ``python fanin_bench_worker.py <machine_file> <rank> [nclients]
[inflight_max] [chaos] [mode] [engine]``: two of these form a native
reactor fleet (``engine`` defaults to epoll; ``uring`` runs the same
protocol through the io_uring engine); rank 1 then drives ``nclients``
ANONYMOUS raw sockets (the serve wire protocol, ``serve/wire.py``)
against rank 0's reactor:

- **latency phase** — every client sends one header-only version probe,
  paced 8-outstanding so the p50/p99 measure the service path, not the
  self-inflicted queue;
- **overload phase** — every client fires a shard Get simultaneously;
  with ``-server_inflight_max=<inflight_max>`` the backlog trips the
  shed gate and the busy fraction is the measured shed rate.

``chaos=1`` (the demo mode) additionally has rank 0 run blocking adds
under injected send faults WHILE the herd hammers it — the retry
harness must land every add exactly once (zero lost adds), asserted
against the final table value.

``mode=ops`` (bench.py ``bench_ops``, docs/observability.md) runs the
latency phase TWICE — plain, then with a concurrent anonymous scraper
polling in-band ``OpsQuery(metrics)`` as fast as replies return — and
reports ``ops_scrape_p50_ms``/``ops_scrape_p99_ms`` (scrape latency
under the fan-in load) plus ``ops_overhead_pct``: the serve-probe QPS
the live scrape path cost, proving introspection is effectively free.

``mode=audit`` (bench.py ``bench_audit``, docs/observability.md "audit
plane") re-runs the probe herd twice — delivery auditing armed (the
default) then disarmed via MV_SetAudit — and reports
``audit_overhead_pct`` (the serve-probe QPS the always-on audit plane
cost; acceptance: < 1%) plus ``audit_add_overhead_pct`` (the same A/B
over an async add stream, the path the seq stamps actually ride) and
``audit_detect_ms``: one injected duplicate send → the wall time until
rank 0's in-band ``"audit"`` scrape names it.

``mode=health`` (bench.py ``bench_health``, docs/observability.md
"health plane") A/Bs the timed serve probe stream with the health
plane armed (default rule pack evaluating each flush + the watchdog
bump + the alerts push) vs disarmed → ``health_overhead_pct``
(acceptance: < 1%), then arms the demo-tightened burn-rate rule,
kv-signals rank 0 to seed a 25 ms apply delay, and reports
``health_alert_detect_ms``: the fault-to-FIRING wall time through the
real flush loop (plus ``health_alert_fired``, which must be 1).

``mode=latency`` (bench.py ``bench_latency``, docs/observability.md
"latency plane") runs the probe phase THREE times over the same herd —
untimed baseline, wire-stamped (per-stage p50/p99 breakdown from the
reply trails + ``timing_overhead_pct``), then wire-stamped WITH both
sampling profilers armed in the herd process (``profiler_overhead_pct``
— the "always-on" bar, < 1%).  ``stage_sum_ratio`` checks the
offset-corrected stages telescope back to the end-to-end latency.

``mode=tail`` (bench.py ``bench_tail``, docs/serving.md "tail") is the
tail-at-scale acceptance: a 10k-socket bulk Get storm (paced by the
ReplyBusy backoff contract) against per-class weighted admission
(``-qos_inflight_max=32``, ``bulk:1,gold:8``) while a gold prober runs
in its OWN child process (``gold_probe`` entry — client-side GIL
isolation, the scraper-child discipline) measuring both e2e and SERVER
RESIDENCY per probe; plus the seeded-straggler hedge phase, the
1 ns-budget deadline-shed phase, and the pre-packed stamp-overhead
A/B.  The RLIMIT_NOFILE guard degrades the herd with a logged reason
instead of dying with EMFILE.

Rank 1 prints the measured keys; both ranks print ``FANIN_BENCH_OK``.
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
from multiverso_tpu_torch.serve.wire import (AnonServeClient,  # noqa: E402
                                       FrameDecoder, MSG, pack_frame,
                                       unpack_frame)

SIZE = 1024
CHAOS_ADDS = 5
# mode=tail's hedged-read matrix table (docs/serving.md "tail"): hot
# rows live in rank 0's shard (the contacted endpoint).
MROWS = 64
MCOLS = 8


class _Scraper:
    """Anonymous in-band metrics scraper hammering OpsQuery while the
    herd runs — its reply latencies are the measured scrape p50/p99.

    Runs as a child PROCESS (``fanin_bench_worker.py scrape <ep>``), not
    a thread: the herd's selector loop owns this process's GIL, and a
    threaded scraper would measure Python scheduling jitter on the
    CLIENT, not the server's in-band service path."""

    def __init__(self, endpoint: str):
        import subprocess

        self._proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "scrape",
             endpoint],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
        self.latencies = []
        # Wait for the child to finish importing and CONNECT before the
        # herd starts — otherwise a fast herd outruns the scraper and
        # the "under load" latencies never get measured.
        ready = self._proc.stdout.readline()
        assert "SCRAPER_READY" in ready, ready

    def stop(self) -> None:
        self._proc.stdin.write("\n")
        self._proc.stdin.flush()
        out = self._proc.communicate(timeout=60)[0]
        for tok in out.split():
            self.latencies.append(float(tok))


def _scrape_child(endpoint: str) -> int:
    """Child body: scrape OpsQuery(metrics) continuously (1 ms pacing)
    until a line arrives on stdin, then print the latencies (seconds)."""
    import select

    client = AnonServeClient(endpoint, timeout=30)
    client.ops_report("health")       # connection warm before READY
    print("SCRAPER_READY", flush=True)
    lat = []
    while not select.select([sys.stdin], [], [], 0.001)[0]:
        t0 = time.perf_counter()
        text = client.ops_report("metrics")
        lat.append(time.perf_counter() - t0)
        assert text, "empty ops reply"
    client.close()
    print(" ".join(f"{v:.9f}" for v in lat), flush=True)
    return 0


def _latency_herd(endpoint: str, nclients: int, rt) -> dict:
    """mode=latency body: three probe sweeps over one socket herd.

    Sweep A (untimed) is the baseline QPS; sweep B stamps timing trails
    and aggregates the reply-side stage breakdown; sweep C repeats B
    with the native SIGPROF sampler AND the Python sampler thread armed
    in THIS (busy) process — the profiler_overhead_pct A/B."""
    import numpy as np

    from multiverso_tpu_torch import profiler as pyprof
    from multiverso_tpu_torch.serve.wire import (OffsetEstimator, ntp_sample,
                                           stage_durations)

    host, port = endpoint.rsplit(":", 1)
    _raise_fd_limit(nclients + 256)
    sel = selectors.DefaultSelector()
    socks = []
    for i in range(nclients):
        s = socket.socket()
        s.connect((host, int(port)))
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        s.setblocking(False)
        sel.register(s, selectors.EVENT_READ,
                     {"dec": FrameDecoder(), "id": i})
        socks.append(s)
    est = OffsetEstimator()

    def sweep(timing: bool, stages_out=None):
        done = 0
        t0 = time.perf_counter()
        window = 8
        mid = [0]
        for base in range(0, nclients, window):
            batch = socks[base:base + window]
            for s in batch:
                mid[0] += 1
                # Deadline propagation rides every probe (MV016):
                # the stamp matches the 60 s collect deadline below.
                s.sendall(pack_frame(MSG["RequestVersion"], 0, mid[0],
                                     timing=timing,
                                     qos=(0, 60_000_000_000)))
            deadline = time.time() + 60
            got = 0
            while got < len(batch) and time.time() < deadline:
                for key, _ in sel.select(timeout=1.0):
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
                        got += 1
                        trail = reply.get("timing")
                        if trail and stages_out is not None:
                            now = time.monotonic_ns()
                            sample = ntp_sample(trail, now)
                            if sample is not None:
                                est.update(*sample)
                            stages_out.append(stage_durations(
                                trail, now, est.offset_ns))
            if got < len(batch):
                raise RuntimeError(f"only {got}/{len(batch)} replies")
            done += got
        return done / (time.perf_counter() - t0)

    out = {"clients": float(nclients)}
    qps_plain = sweep(timing=False)
    stages = []
    qps_timed = sweep(timing=True, stages_out=stages)
    out["timing_overhead_pct"] = (
        max(0.0, (qps_plain - qps_timed) / qps_plain * 100.0)
        if qps_plain else 0.0)

    rt.set_profiler(97)
    sampler = pyprof.start(97)
    try:
        qps_profiled = sweep(timing=True, stages_out=[])
    finally:
        pyprof.stop(to_trace=False)
        rt.set_profiler(0)
    out["profiler_overhead_pct"] = (
        max(0.0, (qps_timed - qps_profiled) / qps_timed * 100.0)
        if qps_timed else 0.0)
    out["profiler_samples"] = float(sampler.samples)

    totals = np.asarray([s.get("total", 0.0) for s in stages]) * 1e3
    out["e2e_p50_ms"] = float(np.percentile(totals, 50))
    out["e2e_p99_ms"] = float(np.percentile(totals, 99))
    sums = np.asarray([sum(v for k, v in s.items() if k != "total")
                       for s in stages]) * 1e3
    ratios = sums[totals > 0] / totals[totals > 0]
    out["stage_sum_ratio"] = float(np.mean(ratios)) if len(ratios) else 0.0
    for name in ("queue", "wire_out", "mailbox", "apply", "reactor",
                 "wire_back"):
        vals = np.asarray([s.get(name, 0.0) for s in stages]) * 1e3
        out[f"stage_{name}_p50_ms"] = float(np.percentile(vals, 50))
        out[f"stage_{name}_p99_ms"] = float(np.percentile(vals, 99))
    for s in socks:
        sel.unregister(s)
        s.close()
    return out


def _audit_bench(endpoint: str, nclients: int, rt, h) -> dict:
    """mode=audit body (docs/observability.md "audit plane").

    Phase A re-runs the fan-in probe herd with auditing armed vs
    disarmed (MV_SetAudit): ``audit_overhead_pct`` is what the plane
    costs the serve tier.  Phase B A/Bs an async add stream — the path
    the seq stamps, ledger writes, and server books actually ride.
    Phase C injects ONE duplicate send and polls rank 0's in-band
    ``"audit"`` scrape until the dup is named: ``audit_detect_ms``."""
    import json

    out = {}
    # ONE persistent socket herd, interleaved probe sweeps: separate
    # 1000-connection herds swing several-fold run to run (connect
    # storms, TIME_WAIT pressure), which would drown the <1% bar the
    # A/B exists to measure.  Same discipline as mode=latency.
    host, port = endpoint.rsplit(":", 1)
    _raise_fd_limit(nclients + 256)
    sel = selectors.DefaultSelector()
    socks = []
    for i in range(nclients):
        s = socket.socket()
        s.connect((host, int(port)))
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        s.setblocking(False)
        sel.register(s, selectors.EVENT_READ,
                     {"dec": FrameDecoder(), "id": i})
        socks.append(s)
    mid = [0]

    def sweep():
        done = 0
        t0 = time.perf_counter()
        window = 8
        for base in range(0, nclients, window):
            batch = socks[base:base + window]
            for s in batch:
                mid[0] += 1
                s.sendall(pack_frame(MSG["RequestVersion"], 0, mid[0],
                                     qos=(0, 60_000_000_000)))
            deadline = time.time() + 60
            got = 0
            while got < len(batch) and time.time() < deadline:
                for key, _ in sel.select(timeout=1.0):
                    data = key.data
                    try:
                        chunk = key.fileobj.recv(65536)
                    except BlockingIOError:
                        continue
                    if not chunk:
                        raise RuntimeError(f"conn {data['id']} died")
                    data["dec"].feed(chunk)
                    while data["dec"].next_frame() is not None:
                        got += 1
            if got < len(batch):
                raise RuntimeError(f"only {got}/{len(batch)} replies")
            done += got
        return done / (time.perf_counter() - t0)

    sweep()                                   # warm sweep: discarded
    armed_sweeps, disarmed_sweeps = [], []
    for _ in range(3):
        rt.set_audit(False)
        disarmed_sweeps.append(sweep())
        rt.set_audit(True)
        armed_sweeps.append(sweep())
    for s in socks:
        sel.unregister(s)
        s.close()
    base = max(disarmed_sweeps)
    out["audit_overhead_pct"] = (
        max(0.0, (base - max(armed_sweeps)) / base * 100.0)
        if base else 0.0)
    out["audit_probe_qps"] = max(armed_sweeps)

    delta = np.ones(SIZE, np.float32)

    def add_stream(n=256):
        t0 = time.perf_counter()
        for _ in range(n - 1):
            rt.array_add(h, delta, sync=False)
        rt.array_add(h, delta, sync=True)   # the ack closes the window
        return n / (time.perf_counter() - t0)

    add_stream()                             # full warm sweep: the
    add_stream()                             # first streams pay the
    # post-herd backlog drain, not the audit plane — discard them.
    # Interleaved best-of-3 per arm: loopback add throughput swings
    # ~2x run to run (PERF.md), and slowdown noise is one-sided.
    armed_runs, disarmed_runs = [], []
    for _ in range(3):
        rt.set_audit(False)
        disarmed_runs.append(add_stream())
        rt.set_audit(True)
        armed_runs.append(add_stream())
    qps_armed = max(armed_runs)
    qps_disarmed = max(disarmed_runs)
    out["audit_add_overhead_pct"] = (
        max(0.0, (qps_disarmed - qps_armed) / qps_disarmed * 100.0)
        if qps_disarmed else 0.0)
    out["audit_add_qps"] = qps_armed

    def total_dups(rep) -> int:
        return sum(o.get("dups", 0)
                   for t in rep.get("tables", [])
                   if isinstance(t.get("server"), dict)
                   for o in t["server"].get("origins", []))

    with AnonServeClient(endpoint, timeout=30) as client:
        dups0 = total_dups(json.loads(client.ops_report("audit")))
        rt.set_fault_n("dup", 1)
        t0 = time.perf_counter()
        rt.array_add(h, delta)               # blocking: on the wire now
        detect = -1.0
        deadline = time.time() + 30
        while time.time() < deadline:
            rep = json.loads(client.ops_report("audit"))
            if total_dups(rep) > dups0:
                detect = (time.perf_counter() - t0) * 1e3
                break
            time.sleep(0.002)
        rt.clear_faults()
    out["audit_detect_ms"] = detect
    out["audit_dup_named"] = 1.0 if detect >= 0 else 0.0
    return out


def _health_bench(endpoint: str, nclients: int, rt, h, hk) -> dict:
    """mode=health body (docs/observability.md "health plane").

    Phase A re-runs the serve probe stream with the health plane armed
    (rule pack + flush-loop evaluation + the watchdog bump + the alerts
    push) vs disarmed, interleaved best-of-3:
    ``health_overhead_pct`` is what closed-loop watching costs the
    serve tier.  Phase B arms a demo-tightened latency burn-rate rule,
    kv-signals rank 0 to seed a 25 ms ``apply_delay`` fault, and drives
    timed probes until the alert FIRES: ``health_alert_detect_ms`` is
    the fault-to-firing wall time through the real flush loop."""
    from multiverso_tpu_torch import config, health, latency, metrics

    out = {}
    flush_ms = 100
    config.set_flag("health_latency_slo_ms", 10.0)
    metrics.reset()
    metrics.start_flush(flush_ms)

    def probes(n=64):
        t0 = time.perf_counter()
        with latency.attach_metrics(
                AnonServeClient(endpoint, timeout=30,
                                timing=True)) as client:
            for _ in range(n):
                client.get_shard(h)
        return n / (time.perf_counter() - t0)

    probes()                                  # warm: connect + JIT
    armed_runs, disarmed_runs = [], []
    for _ in range(3):
        health.disarm(rt)
        disarmed_runs.append(probes())
        health.arm(rules=health.default_rules(), runtime=rt)
        armed_runs.append(probes())
    base = max(disarmed_runs)
    out["health_overhead_pct"] = (
        max(0.0, (base - max(armed_runs)) / base * 100.0)
        if base else 0.0)
    out["health_probe_qps"] = max(armed_runs)

    # Phase B: demo-scale burn windows (the doctor-demo rule) so the
    # detection measures the flush loop, not a 300 s production window.
    health.arm(rules=[health.Rule(
        name="lat-slo-burn", metric="lat.slo.breach",
        op="burn_rate_gt", total_metric="lat.slo.total",
        threshold=2.0, objective=0.99, window_s=8.0,
        short_window_s=4.0, for_s=0.0, severity="critical")],
        runtime=rt)
    rt.kv_add(hk, "arm_delay", 1.0)
    while rt.kv_get(hk, "delay_armed") < 1.0:
        time.sleep(0.005)
    detect = -1.0
    t0 = time.perf_counter()
    deadline = time.time() + 30
    with latency.attach_metrics(
            AnonServeClient(endpoint, timeout=30,
                            timing=True)) as client:
        while time.time() < deadline:
            for _ in range(4):
                client.get_shard(h)           # ~25 ms each, all breaches
            doc = health.alerts_doc()
            if any(a["state"] == "firing" for a in doc["alerts"]):
                detect = (time.perf_counter() - t0) * 1e3
                break
    rt.kv_add(hk, "disarm_delay", 1.0)
    out["health_alert_detect_ms"] = detect
    out["health_alert_fired"] = 1.0 if detect >= 0 else 0.0
    health.disarm(rt)
    metrics.stop_flush()
    return out


def _raise_fd_limit(need: int) -> None:
    import resource

    soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
    if soft < need:
        resource.setrlimit(resource.RLIMIT_NOFILE,
                           (min(max(need, soft), hard), hard))


def _fd_budget(nclients: int, headroom: int = 256) -> int:
    """RLIMIT_NOFILE guard (docs/serving.md "tail"): raise the soft
    limit toward ``nclients + headroom``; when the hard limit cannot
    cover it, DEGRADE the herd to what fits (floor 64) with a logged
    reason instead of dying with EMFILE mid-connect — a low-ulimit
    host runs the 10k-socket phase at 1k, it does not die."""
    import resource

    need = nclients + headroom
    soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
    if soft < need:
        try:
            resource.setrlimit(resource.RLIMIT_NOFILE,
                               (min(need, hard) if hard > 0 else need,
                                hard))
        except (ValueError, OSError) as exc:
            print(f"fd_limit: setrlimit({need}) failed: {exc}",
                  flush=True)
        soft = resource.getrlimit(resource.RLIMIT_NOFILE)[0]
    if soft < need:
        usable = max(64, soft - headroom)
        print(f"fd_limit: RLIMIT_NOFILE soft={soft} hard={hard} cannot "
              f"cover {nclients} sockets + {headroom} headroom — "
              f"degrading herd to {usable}", flush=True)
        return usable
    return nclients


class _GoldProber:
    """Paced gold-class prober running as a child PROCESS
    (``fanin_bench_worker.py gold_probe <ep> <socks>``) — the herd's
    selector loop owns this process's GIL, so an in-process gold
    prober would measure Python scheduling jitter on the CLIENT, not
    the server's per-class isolation (the same discipline as the
    bench_ops scraper child)."""

    def __init__(self, endpoint: str, socks: int = 64):
        import subprocess

        self._proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "gold_probe",
             endpoint, str(socks)],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
        ready = self._proc.stdout.readline()
        assert "GOLD_READY" in ready, ready

    def stop(self):
        """(server_residency_ms, e2e_ms) arrays observed by the child.

        Residency = the trail's recv -> reply_send span, both stamps on
        the SERVER's clock — what the serve tier actually did to a gold
        read, immune to client-side scheduling on a shared host (the
        e2e numbers include the experiment's own CPU contention)."""
        self._proc.stdin.write("\n")
        self._proc.stdin.flush()
        out = self._proc.communicate(timeout=120)[0]
        res, e2e = [], []
        for line in out.splitlines():
            if line.startswith("RES "):
                res = [float(t) for t in line.split()[1:]]
            elif line.startswith("E2E "):
                e2e = [float(t) for t in line.split()[1:]]
        return np.asarray(res) * 1e3, np.asarray(e2e) * 1e3


def _gold_probe_child(endpoint: str, nsocks: int) -> int:
    """Child body: ``nsocks`` gold-class connections, paced
    8-outstanding version probes (each stamped class gold + a 30 s
    deadline budget) until a line arrives on stdin; prints the
    latencies (seconds)."""
    import select

    host, port = endpoint.rsplit(":", 1)
    _raise_fd_limit(nsocks + 64)
    sel = selectors.DefaultSelector()
    socks = []
    for i in range(nsocks):
        s = socket.socket()
        s.connect((host, int(port)))
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        s.setblocking(False)
        sel.register(s, selectors.EVENT_READ,
                     {"dec": FrameDecoder(), "t0": 0.0})
        socks.append(s)
    print("GOLD_READY", flush=True)
    lat = []       # client-observed e2e (includes host contention)
    res = []       # server residency: trail recv -> reply_send
    mid = 0
    window = 8
    cap = 120_000            # bounded output; probing continues
    # PACED probing (a paid reader, not a herd): one window per 10 ms.
    # A max-rate prober would saturate its own CPU share on a shared
    # host and measure scheduler contention, not the server's per-class
    # isolation.
    base = 0
    while not select.select([sys.stdin], [], [], 0.01)[0]:
        batch = socks[base:base + window]
        base = (base + window) % nsocks
        for s in batch:
            mid += 1
            sel.get_key(s).data["t0"] = time.perf_counter()
            s.sendall(pack_frame(MSG["RequestVersion"], 0, mid,
                                 timing=True, qos=(1, 30_000_000_000)))
        got = 0
        deadline = time.time() + 60
        while got < len(batch) and time.time() < deadline:
            for key, _ in sel.select(timeout=1.0):
                data = key.data
                try:
                    chunk = key.fileobj.recv(65536)
                except BlockingIOError:
                    continue
                if not chunk:
                    raise RuntimeError("gold conn died")
                data["dec"].feed(chunk)
                while True:
                    body = data["dec"].next_frame()
                    if body is None:
                        break
                    reply = unpack_frame(body)
                    trail = reply.get("timing")
                    if len(lat) < cap:
                        lat.append(time.perf_counter() - data["t0"])
                        if trail and trail[2] and trail[5]:
                            res.append((trail[5] - trail[2]) * 1e-9)
                    got += 1
        if got < len(batch):
            raise RuntimeError(f"gold probes stalled ({got})")
    for s in socks:
        s.close()
    print("RES " + " ".join(f"{v:.9f}" for v in res), flush=True)
    print("E2E " + " ".join(f"{v:.9f}" for v in lat), flush=True)
    return 0


def _tail_bench(endpoint: str, nclients: int, rt, hk, hm) -> dict:
    """mode=tail body (docs/serving.md "tail"; bench.py ``bench_tail``).

    A mixed-tenant load against one epoll reactor with
    ``-qos_inflight_max`` armed — the GOLD tenant probes from a child
    process (client-side GIL isolation), the BULK herd storms from this
    one:

    - **gold-alone phase** — the gold child probes an idle reactor →
      baseline p50/p99/p99.9;
    - **herd phase** — a continuous bulk Get storm across the whole
      herd (one outstanding Get per socket, re-fired on every reply;
      sheds tallied) while the gold child re-probes →
      ``tail_qos_isolation`` = gold p99 under the herd / alone
      (acceptance: < 2x — the bulk herd must not starve gold);
    - **hedge phase** — a seeded ``apply_delay`` straggler on the
      server while a gold ``HedgedReader`` row-reads a hot row set →
      ``tail_hedge_win_rate`` (> 0 under the straggler);
    - **deadline phase** — gets stamped with a 1 ns budget must shed at
      dequeue (``tail_deadline_shed`` > 0, named by the in-band
      scrape);
    - **overhead phase** — interleaved best-of-5 paced probes stamped
      vs unstamped on a quiet reactor → ``tail_overhead_pct`` (the
      QoS/deadline stamp's cost on the unhedged fast path; < 1%).
    """
    import json

    from multiverso_tpu_torch.serve.hedge import HedgedReader
    from multiverso_tpu_torch.serve.wire import AnonServeClient

    host, port = endpoint.rsplit(":", 1)
    nclients = _fd_budget(nclients)
    bulk_n = max(16, nclients - 64)   # gold lives in the 64-sock child
    budget_ns = 30_000_000_000        # the storm's propagated deadline

    sel = selectors.DefaultSelector()
    bulk = []
    for i in range(bulk_n):
        s = socket.socket()
        s.connect((host, int(port)))
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        s.setblocking(False)
        sel.register(s, selectors.EVENT_READ,
                     {"dec": FrameDecoder(), "id": i, "t0": 0.0})
        bulk.append(s)
    out = {"clients": float(bulk_n + 64), "bulk_clients": float(bulk_n),
           "gold_clients": 64.0}
    mid = [0]

    def fire(s):
        """One bulk Get, tolerant of a full send buffer (at 10k socks
        the kernel pushes back; a client that cannot send this round
        simply rejoins on its next reply)."""
        mid[0] += 1
        try:
            s.send(pack_frame(MSG["RequestGet"], 0, mid[0],
                              qos=(0, budget_ns)))
            return True
        except (BlockingIOError, InterruptedError):
            return False

    # The shed contract IS the pacing (docs/serving.md): a ReplyBusy
    # means "retry after backoff", so a shed bulk client re-fires after
    # a backoff window while a served one re-polls sooner.  A herd that
    # busy-looped on sheds instead would measure host-CPU starvation
    # (client and server share the machine), not admission isolation.
    BUSY_BACKOFF_S = 2.0
    SERVED_BACKOFF_S = 0.5

    def pct(arr, q):
        return float(np.percentile(arr, q)) if len(arr) else 0.0

    # --- phase A: gold alone -------------------------------------------
    gold = _GoldProber(endpoint)
    time.sleep(3.0)
    alone_res, alone_e2e = gold.stop()
    out["gold_p50_ms"] = pct(alone_res, 50)
    out["gold_alone_p99_ms"] = pct(alone_res, 99)
    out["gold_alone_p999_ms"] = pct(alone_res, 99.9)
    out["gold_alone_e2e_p99_ms"] = pct(alone_e2e, 99)

    # --- phase B: the bulk herd arrives --------------------------------
    import heapq

    gold = _GoldProber(endpoint)
    tally = {}
    bulk_lat = []
    due = []                      # (when, seq, sock) re-fire heap
    seq = [0]

    def schedule(s, delay):
        seq[0] += 1
        heapq.heappush(due, (time.perf_counter() + delay, seq[0], s))

    for s in bulk:
        sel.get_key(s).data["t0"] = time.perf_counter()
        fire(s)
    storm_stop = time.perf_counter() + 6.0
    refire = True
    while True:
        now = time.perf_counter()
        if refire and now >= storm_stop:
            refire = False
            herd_res, herd_e2e = gold.stop()  # gold sampled the storm
            drain_stop = now + 5.0
        if not refire and (time.perf_counter() >= drain_stop):
            break
        if refire:
            while due and due[0][0] <= now:
                _, _, s = heapq.heappop(due)
                sel.get_key(s).data["t0"] = time.perf_counter()
                fire(s)
        events = sel.select(timeout=0.05)
        if not events and not refire:
            break
        for key, _ in events:
            data = key.data
            try:
                chunk = key.fileobj.recv(65536)
            except BlockingIOError:
                continue
            if not chunk:
                raise RuntimeError(f"bulk conn {data['id']} died")
            data["dec"].feed(chunk)
            while True:
                body = data["dec"].next_frame()
                if body is None:
                    break
                reply = unpack_frame(body)
                tally[reply["type_name"]] = \
                    tally.get(reply["type_name"], 0) + 1
                served_reply = reply["type_name"] == "ReplyGet"
                if served_reply:
                    bulk_lat.append(time.perf_counter() - data["t0"])
                if refire:
                    schedule(key.fileobj, SERVED_BACKOFF_S if served_reply
                             else BUSY_BACKOFF_S)
    # Gated on SERVER RESIDENCY (the serve tier's contribution to a
    # gold read — mailbox wait + apply + reactor, one clock): on a
    # shared host the client-observed e2e includes the experiment's
    # own CPU contention, which no admission gate can remove.
    out["gold_p99_ms"] = pct(herd_res, 99)
    out["gold_p999_ms"] = pct(herd_res, 99.9)
    out["gold_e2e_p99_ms"] = pct(herd_e2e, 99)
    out["gold_e2e_p999_ms"] = pct(herd_e2e, 99.9)
    bulk_ms = np.asarray(bulk_lat) * 1e3
    out["bulk_p99_ms"] = pct(bulk_ms, 99)
    out["bulk_p999_ms"] = pct(bulk_ms, 99.9)
    served = tally.get("ReplyGet", 0)
    shed = tally.get("ReplyBusy", 0)
    out["bulk_served"] = float(served)
    out["bulk_shed"] = float(shed)
    out["bulk_shed_rate"] = shed / max(1.0, float(served + shed))
    out["qos_isolation"] = (out["gold_p99_ms"]
                            / max(out["gold_alone_p99_ms"], 1e-6))

    # --- phase C: hedged reads under a seeded straggler ----------------
    hot = list(range(8))  # rank 0's shard owns the low rows
    reader = HedgedReader(endpoint, hm, MCOLS, qos_class="gold",
                          hedge_min_us=2000, timeout=30.0)
    for _ in range(60):          # warm the SpaceSaving top-K + tracker
        reader.get_rows(hot)
    rt.kv_add(hk, "arm_delay", 1.0)      # rank 0 seeds apply_delay
    while rt.kv_get(hk, "delay_armed") < 1.0:
        time.sleep(0.02)
    for _ in range(240):
        reader.get_rows(hot)
    rt.kv_add(hk, "disarm_delay", 1.0)
    st = reader.stats()
    reader.close()
    out["hedge_issued"] = float(st["issued"])
    out["hedge_won"] = float(st["won"])
    out["hedge_wasted"] = float(st["wasted"])
    out["hedge_win_rate"] = st["win_rate"]

    # --- phase D: deadline sheds ---------------------------------------
    probe = AnonServeClient(endpoint, timeout=10.0)
    for i in range(20):
        # 1 ns budget: expired by the time the actor dequeues it — the
        # server must drop it, never burn an apply slot.  No reply
        # comes back; the probe socket stays healthy for the scrape.
        probe.send_raw(pack_frame(MSG["RequestGet"], 0,
                                  1_000_000 + i, qos=(0, 1)))
    deadline = time.time() + 10
    sheds = 0
    while time.time() < deadline:
        rep = json.loads(probe.ops_report("latency"))
        sheds = (rep.get("qos") or {}).get("deadline_shed", 0)
        if sheds >= 20:
            break
        time.sleep(0.05)
    out["deadline_shed"] = float(sheds)
    probe.close()

    # --- phase E: stamp overhead on the unhedged fast path -------------
    # Paced probes over 64 quiet sockets, interleaved best-of-5 per arm
    # (the bench_audit discipline: loopback QPS noise is one-sided, so
    # max-vs-max under interleaving is what can resolve a <1% bar).
    # Frames are PRE-PACKED outside the timed loop: the bar measures
    # what the stamp costs the WIRE + SERVER path, and on a shared host
    # every extra client-side pack cycle would also steal server time
    # (version probes ignore msg_id uniqueness, so one frame per arm
    # serves every probe).
    esocks = bulk[:64]
    frame_plain = pack_frame(MSG["RequestVersion"], 0, 1)  # mvlint: MV016-exempt(the unstamped A/B baseline arm)
    frame_qos = pack_frame(MSG["RequestVersion"], 0, 1,
                           qos=(0, budget_ns))

    def sweep(qos):
        frame = frame_qos if qos else frame_plain
        done = 0
        window = 8
        t0 = time.perf_counter()
        for _ in range(6):
            for base in range(0, len(esocks), window):
                batch = esocks[base:base + window]
                for s in batch:
                    s.sendall(frame)
                got = 0
                deadline = time.time() + 60
                while got < len(batch) and time.time() < deadline:
                    for key, _ in sel.select(timeout=1.0):
                        data = key.data
                        try:
                            chunk = key.fileobj.recv(65536)
                        except BlockingIOError:
                            continue
                        if not chunk:
                            raise RuntimeError("probe conn died")
                        data["dec"].feed(chunk)
                        while data["dec"].next_frame() is not None:
                            got += 1
                if got < len(batch):
                    raise RuntimeError("overhead probes stalled")
                done += got
        return done / (time.perf_counter() - t0)

    sweep(qos=False)                            # warm
    stamped_qps, plain_qps = [], []
    for _ in range(5):
        plain_qps.append(sweep(qos=False))
        stamped_qps.append(sweep(qos=True))
    base = max(plain_qps)
    out["overhead_pct"] = (max(0.0, (base - max(stamped_qps))
                           / base * 100.0) if base else 0.0)
    out["probe_qps"] = max(stamped_qps)

    for s in bulk:
        sel.unregister(s)
        s.close()
    return out


def _herd(endpoint: str, nclients: int, scrape: bool = False) -> dict:
    host, port = endpoint.rsplit(":", 1)
    _raise_fd_limit(nclients + 256)
    scraper = _Scraper(endpoint) if scrape else None
    sel = selectors.DefaultSelector()
    socks = []
    for i in range(nclients):
        s = socket.socket()
        s.connect((host, int(port)))
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        s.setblocking(False)
        sel.register(s, selectors.EVENT_READ,
                     {"dec": FrameDecoder(), "id": i, "t0": 0.0})
        socks.append(s)

    def collect(expected, deadline_s, on_reply):
        got = 0
        deadline = time.time() + deadline_s
        while got < expected and time.time() < deadline:
            for key, _ in sel.select(timeout=1.0):
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
                    on_reply(data, unpack_frame(body))
                    got += 1
        if got < expected:
            raise RuntimeError(f"only {got}/{expected} replies before "
                               f"the {deadline_s:.0f}s deadline")
        return got

    out = {"clients": float(nclients)}
    wall0 = time.perf_counter()

    # --- latency phase: 8-outstanding version probes --------------------
    lat = []
    window = 8
    for base in range(0, nclients, window):
        batch = socks[base:base + window]
        for j, s in enumerate(batch):
            sel.get_key(s).data["t0"] = time.perf_counter()
            s.sendall(pack_frame(MSG["RequestVersion"], 0, base + j,
                                 qos=(0, 60_000_000_000)))

        def note(data, reply):
            lat.append(time.perf_counter() - data["t0"])
        collect(len(batch), 60, note)
    lat_ms = np.asarray(lat) * 1e3
    out["p50_ms"] = float(np.percentile(lat_ms, 50))
    out["p99_ms"] = float(np.percentile(lat_ms, 99))
    # Pure latency-phase probe rate: the ops_overhead_pct numerator —
    # comparing it plain vs under a live scraper isolates what the
    # in-band introspection path costs the serve tier.
    out["probe_qps"] = len(lat) / (time.perf_counter() - wall0)
    if scraper is not None:
        # The scrape window is the FAN-IN load (1k-connection storm +
        # paced probes), not the deliberately pathological all-at-once
        # overload burst below — stop before it so ops_scrape_p99
        # measures scraping a busy-but-live server, the acceptance bar.
        scraper.stop()
        if scraper.latencies:
            sl = np.asarray(scraper.latencies) * 1e3
            out["ops_scrape_p50_ms"] = float(np.percentile(sl, 50))
            out["ops_scrape_p99_ms"] = float(np.percentile(sl, 99))
            out["ops_scrapes"] = float(len(sl))

    # --- overload phase: every client fires a Get at once ---------------
    counts = {"ReplyGet": 0, "ReplyBusy": 0}
    for i, s in enumerate(socks):
        s.sendall(pack_frame(MSG["RequestGet"], 0, 10000 + i,
                             qos=(0, 120_000_000_000)))

    def tally(_data, reply):
        counts[reply["type_name"]] = counts.get(reply["type_name"], 0) + 1
    replies = collect(nclients, 120, tally)
    wall = time.perf_counter() - wall0
    out["qps"] = (len(lat) + replies) / wall
    out["shed_rate"] = counts.get("ReplyBusy", 0) / float(replies)
    out["busy"] = float(counts.get("ReplyBusy", 0))
    for s in socks:
        sel.unregister(s)
        s.close()
    return out


def main() -> int:
    mf, rank = sys.argv[1], int(sys.argv[2])
    nclients = int(sys.argv[3]) if len(sys.argv) > 3 else 1000
    inflight_max = int(sys.argv[4]) if len(sys.argv) > 4 else 8
    chaos = int(sys.argv[5]) if len(sys.argv) > 5 else 0
    mode = sys.argv[6] if len(sys.argv) > 6 else ""
    engine = sys.argv[7] if len(sys.argv) > 7 else "epoll"
    args = [
        f"-machine_file={mf}", f"-rank={rank}", "-log_level=error",
        f"-net_engine={engine}",
        "-rpc_timeout_ms=60000", "-barrier_timeout_ms=120000",
        f"-server_inflight_max={inflight_max}",
        "-net_arena_bytes=8192", "-send_retries=3", "-send_backoff_ms=20"]
    if mode == "tail":
        # Tail plane (docs/serving.md "tail"): per-class weighted
        # admission armed — bulk owns ~1/9 of the read slots, gold the
        # rest, spare capacity borrowed in weight proportion.
        args += ["-qos_classes=bulk:1,gold:8", "-qos_inflight_max=32"]
    rt = nat.NativeRuntime(args=args)
    assert rt.net_engine() == engine, rt.net_engine()
    h = rt.new_array_table(SIZE)
    hk = rt.new_kv_table()
    hm = rt.new_matrix_table(MROWS, MCOLS)
    rt.barrier()
    if rank == 0:
        rt.array_add(h, np.ones(SIZE, np.float32))
        rt.matrix_add_rows(hm, list(range(MROWS)),
                           np.ones((MROWS, MCOLS), np.float32))
    rt.barrier()

    out = {}
    if rank == 0:
        rt.set_fault_seed(1234)
        if chaos:
            # harness under live fan-in: every blocking add eats an
            # injected send failure and must still land EXACTLY once.
            for _ in range(CHAOS_ADDS):
                rt.set_fault_n("fail_send", 1)
                rt.array_add(h, np.ones(SIZE, np.float32))
            rt.clear_faults()
            assert rt.query_monitor("net.retries") >= CHAOS_ADDS
        # Hold the serve tier up until the herd reports done; mode=tail
        # additionally arms/disarms the seeded apply_delay straggler on
        # the herd's kv signal (the hedge phase's chaos ingredient).
        armed = False
        deadline = time.time() + 600
        while rt.kv_get(hk, "herd_done") < 1.0:
            if mode in ("tail", "health"):
                if not armed and rt.kv_get(hk, "arm_delay") > 0:
                    rt.set_fault_seed(1234)
                    if mode == "health":
                        # Every apply eats 25 ms: each timed probe is
                        # an SLO breach, so the burn rate saturates
                        # within one flush of traffic (doctor-demo's
                        # fault shape).
                        rt.set_fault("delay_ms", 25)
                        rt.set_fault("apply_delay", 1.0)
                    else:
                        rt.set_fault("apply_delay", 0.05)
                    armed = True
                    rt.kv_add(hk, "delay_armed", 1.0)
                elif armed and rt.kv_get(hk, "disarm_delay") > 0:
                    rt.clear_faults()
                    armed = False
            if time.time() > deadline:
                raise RuntimeError("herd never finished")
            time.sleep(0.05)
        if armed:
            rt.clear_faults()
    else:
        eps = [ln.strip() for ln in open(mf) if ln.strip()]
        if mode == "latency":
            out = _latency_herd(eps[0], nclients, rt)
        elif mode == "tail":
            out = _tail_bench(eps[0], nclients, rt, hk, hm)
        elif mode == "audit":
            out = _audit_bench(eps[0], nclients, rt, h)
        elif mode == "health":
            out = _health_bench(eps[0], nclients, rt, h, hk)
        elif mode == "ops":
            # A/B the latency phase: plain, then under a live in-band
            # scraper — the delta is what introspection costs serving.
            plain = _herd(eps[0], nclients)
            out = _herd(eps[0], nclients, scrape=True)
            base = plain.get("probe_qps", 0.0)
            scraped = out.get("probe_qps", base)
            out["ops_overhead_pct"] = (
                max(0.0, (base - scraped) / base * 100.0) if base else 0.0)
        else:
            out = _herd(eps[0], nclients)
        rt.kv_add(hk, "herd_done", 1.0)
    rt.barrier()

    # Zero lost adds: the exact final value, read through the fleet
    # (busy-shed retries until admitted — sheds are retryable by
    # contract, rc -6 means the server did no work).  mode=audit skips
    # the exact-value check: its add streams (and the deliberately
    # injected duplicate, which double-applies by design) change the
    # total — the audit books, not the value, are its assertion.
    want = 1.0 + (CHAOS_ADDS if chaos else 0)
    for attempt in range(60):
        try:
            got = rt.array_get(h, SIZE)
            break
        except nat.BusyError:
            time.sleep(0.05)
    else:
        raise RuntimeError("get shed 60 times in a row")
    if mode != "audit":
        np.testing.assert_allclose(got, want)

    if rank == 0:
        st = rt.fanin_stats()
        out["accepted"] = float(st["accepted_total"])
        out["client_shed"] = float(st["client_shed"])
        out["adds_ok"] = 1.0
    rt.barrier()
    rt.shutdown()
    kv = " ".join(f"{k}={v:.6f}" for k, v in sorted(out.items()))
    print(f"FANIN_BENCH_OK rank={rank} {kv}", flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "scrape":
        sys.exit(_scrape_child(sys.argv[2]))
    if len(sys.argv) > 1 and sys.argv[1] == "gold_probe":
        sys.exit(_gold_probe_child(sys.argv[2], int(sys.argv[3])))
    sys.exit(main())
