"""A rank of the port's native runtime whose peer has already shut down
finishes ``MV_ShutDown`` promptly, on every engine with a connect loop.

Two ranks with heartbeats on: rank 0 shuts down first and exits; rank 1
enters its shutdown just after a wake of its stall watchdog's checker
(``-watchdog_stall_ms=4000`` wakes it once a second), so disarming the
watchdog holds rank 1 for most of a second after the shutdown's barrier.
Its heartbeat sender (every 20 ms) meanwhile finds rank 0 gone and enters
the transport's reconnect loop, whose budget is ``-connect_retry_ms``
(15 s) on each of ``-send_retries`` + 1 attempts.  The shutdown joins
that sender: it must end within ``BOUND_S``, not wait out the budget.
"""

import os
import socket
import subprocess
import sys
import textwrap
import time

import pytest

from multiverso_tpu_torch import native as nat

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOUND_S = 5.0
DEADLINE_S = 60
_BIND_RACE = ("Address already in use", "Failed to bind", "bind failed",
              "EADDRINUSE")

_RANK = textwrap.dedent("""
    import math, sys, time
    from multiverso_tpu_torch import native as nat

    mf, rank, engine = sys.argv[1], int(sys.argv[2]), sys.argv[3]
    survivor = rank == 1
    rt = nat.NativeRuntime(args=[
        f"-machine_file={mf}", f"-rank={rank}", "-log_level=error",
        f"-net_engine={engine}", "-heartbeat_ms=20",
        "-heartbeat_timeout_ms=60000", "-barrier_timeout_ms=60000",
        f"-watchdog_stall_ms={4000 if survivor else 0}"])
    armed = time.monotonic()       # the checker starts at the end of init
    effective = rt.net_engine()
    rt.barrier()
    if survivor:
        # 0.15 s past a checker wake, at least 0.2 s from now.
        k = math.ceil(time.monotonic() - armed + 0.2)
        time.sleep(max(0.0, armed + k + 0.15 - time.monotonic()))
    t0 = time.monotonic()
    rt.shutdown()
    print(f"SHUTDOWN rank={rank} engine={effective} "
          f"seconds={time.monotonic() - t0:.3f}", flush=True)
""")


def _machine_file(tmp_path, n):
    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    eps = [f"127.0.0.1:{s.getsockname()[1]}" for s in socks]
    for s in socks:
        s.close()
    mf = tmp_path / "machines"
    mf.write_text("\n".join(eps) + "\n")
    return str(mf)


def _launch(mf, engine):
    """Both ranks run to their end or the deadline: each one's exit code
    and output, ``None`` for a rank still running at the deadline."""
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK, mf, str(r), engine], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    t0 = time.monotonic()
    outs = []
    try:
        for p in procs:
            left = max(1.0, DEADLINE_S - (time.monotonic() - t0))
            try:
                outs.append(p.communicate(timeout=left)[0])
            except subprocess.TimeoutExpired:
                outs.append(None)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [None if out is None else (p.returncode, out)
            for p, out in zip(procs, outs)]


def _shutdown_seconds(tmp_path, engine, attempts=3):
    """Each rank's (effective engine, shutdown seconds); a rank still in
    its shutdown at the deadline reads as the deadline.  A launch whose
    rank lost its port to another process is retried on fresh ports."""
    nat.ensure_built()
    for attempt in range(attempts):
        ranks = _launch(_machine_file(tmp_path, 2), engine)
        raced = [r for r in ranks if r and r[0] != 0
                 and any(m in r[1] for m in _BIND_RACE)]
        if not raced or attempt == attempts - 1:
            break
    got = []
    for rank in ranks:
        if rank is None:
            got.append((engine, float(DEADLINE_S)))
            continue
        rc, out = rank
        assert rc == 0, out[-3000:]
        line = next(ln for ln in out.splitlines()
                    if ln.startswith("SHUTDOWN "))
        fields = dict(f.split("=") for f in line.split()[1:])
        got.append((fields["engine"], float(fields["seconds"])))
    return got


@pytest.mark.parametrize("engine", ["tcp", "epoll", "uring"])
def test_shutdown_after_the_peer_left_is_prompt(tmp_path, engine):
    got = _shutdown_seconds(tmp_path, engine)
    want = engine
    if engine == "uring" and not nat.load().MV_UringSupported():
        want = "epoll"      # the runtime degrades, as it logs
    assert [e for e, _ in got] == [want, want], got
    assert all(s < BOUND_S for _, s in got), got
