"""The port's native workers over a real 2-rank TcpNet session, and
``ServeClient`` over the port's native runtime, on the CPU.

``lr_native_worker.py`` and ``w2v_native_worker.py`` (the north-star
jobs the fused rates are measured against) run as 2 processes of
``tests/torch_native_rec.py``, which records what each rank pulled and
pushed; numpy then replays them: every push is the worker's gradient of
what that rank pulled, bit for bit, and each table ends as its start
minus the step size times the sum of every rank's pushes (the wire and
the server's sgd updater applied each push once), within 1e-5 of the
table's scale (the server sums pushes in arrival order).  The loss
falls: LR's printed final loss is below ln 10 (the zero start's), and
word2vec's first batch scores lower on the final rows than on the rows
it pulled.  ``serve_bench_worker.py`` runs as 2 ranks: the cached read's
p50 is below the cold read's.  In one process: ``ServeClient``'s cache
is mutation-proof, a miss stores the runtime's own array and copies it
once for its caller, and a scripted ``BusyError`` storm is retried.

Each launch binds free loopback ports and retries on a fresh set when a
rank lost the port to another process; each has its own deadline.
"""

import math
import os
import re
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

from multiverso_tpu_torch import fault, metrics, native as nat
from multiverso_tpu_torch.apps import w2v_native_worker as w2v
from multiverso_tpu_torch.serve import ServeClient

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
APPS = os.path.join(REPO, "multiverso_tpu_torch", "apps")
DEADLINE_S = 240
_BIND_RACE = ("Address already in use", "Failed to bind", "bind failed",
              "EADDRINUSE")
LR_STEPS, LR_BATCH, LR_RATE = 6, 64, 0.1
W2V_STEPS, W2V_BATCH, W2V_SEED = 4, 64, 5


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


def _launch(tmp_path, argv_of_rank, n=2, attempts=3):
    """Run ``n`` ranks (``argv_of_rank(mf, r)`` each) to their end under
    one deadline; returns every rank's output."""
    nat.ensure_built()
    env = dict(os.environ, PYTHONPATH=REPO)
    for attempt in range(attempts):
        mf = _machine_file(tmp_path, n)
        procs = [subprocess.Popen(
            [sys.executable, *argv_of_rank(mf, r)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(n)]
        t0 = time.monotonic()
        outs = []
        try:
            for p in procs:
                left = max(1.0, DEADLINE_S - (time.monotonic() - t0))
                outs.append(p.communicate(timeout=left)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        failed = [r for r, p in enumerate(procs) if p.returncode != 0]
        if failed and attempt < attempts - 1 and all(
                any(m in outs[r] for m in _BIND_RACE) for r in failed):
            continue
        for r, (p, out) in enumerate(zip(procs, outs)):
            assert p.returncode == 0, f"rank {r}:\n{out[-4000:]}"
        return outs


def _recorded(tmp_path, worker, seed, args):
    outs = _launch(tmp_path, lambda mf, r: [
        os.path.join(HERE, "torch_native_rec.py"), worker,
        str(tmp_path / f"rank{r}.npz"), str(seed), mf, str(r),
        *map(str, args)])
    logs = []
    for r in range(2):
        with np.load(tmp_path / f"rank{r}.npz") as z:
            n = len(z.files) // 4
            logs.append([(str(z[f"{i}_kind"]), int(z[f"{i}_h"]),
                          z[f"{i}_ids"], z[f"{i}_val"]) for i in range(n)])
    return outs, logs


def _softmax_grad_and_loss(x, y, w):
    """The LR worker's gradient and loss, the same numpy ops."""
    logits = x @ w
    logits -= logits.max(axis=1, keepdims=True)
    p = np.exp(logits)
    p /= p.sum(axis=1, keepdims=True)
    return (x.T @ (p - y) / x.shape[0],
            float(-(y * np.log(p + 1e-12)).sum(axis=1).mean()))


def test_lr_native_worker_two_ranks_replayed(tmp_path):
    features, classes = 784, 10
    outs, logs = _recorded(tmp_path, "lr_native_worker", 0,
                           [LR_STEPS, LR_BATCH])
    pushes, finals = [], []
    for r, (out, log) in enumerate(zip(outs, logs)):
        assert f"NATIVE_LR_OK rank={r}" in out, out[-2000:]
        rng = np.random.default_rng(r)
        x = rng.standard_normal((LR_BATCH, features)).astype(np.float32)
        w_plant = rng.standard_normal((features, classes)).astype(
            np.float32)
        y = np.eye(classes, dtype=np.float32)[(x @ w_plant).argmax(1)]
        kinds = [k for k, *_ in log]
        assert kinds == ["get", "add"] * LR_STEPS + ["get"]
        for i in range(LR_STEPS):
            w = log[2 * i][3].reshape(features, classes)
            grad, _ = _softmax_grad_and_loss(x, y, w)
            assert np.array_equal(log[2 * i + 1][3], grad.reshape(-1))
            pushes.append(log[2 * i + 1][3])
        final = log[-1][3]
        finals.append(final)
        _, loss = _softmax_grad_and_loss(x, y,
                                         final.reshape(features, classes))
        printed = float(re.search(r"loss=([0-9.]+)", out).group(1))
        assert printed == pytest.approx(loss, abs=1e-6)
        assert printed < math.log(classes)
    assert np.array_equal(finals[0], finals[1])
    want = -np.float32(LR_RATE) * np.sum(pushes, axis=0, dtype=np.float64)
    assert np.max(np.abs(finals[0] - want)) <= 1e-5 * np.max(np.abs(want))


def _sgns_loss(w_in, w_out, c_loc, o_loc, neg_loc):
    v = w_in[c_loc]
    s_pos = np.einsum("bd,bd->b", v, w_out[o_loc])
    s_neg = np.einsum("bd,bkd->bk", v, w_out[neg_loc])
    return float(-np.log(w2v._sigmoid(s_pos)).mean()
                 - np.log(w2v._sigmoid(-s_neg)).sum(1).mean())


@pytest.mark.parametrize("prefetch", [1, 0])
def test_w2v_native_worker_two_ranks_replayed(tmp_path, prefetch):
    outs, logs = _recorded(tmp_path, "w2v_native_worker", W2V_SEED,
                           [W2V_STEPS, W2V_BATCH, prefetch])
    handles = sorted({h for log in logs for _, h, _, _ in log})
    assert len(handles) == 2                # the input and output tables
    total = [np.zeros((w2v.VOCAB, w2v.DIM), np.float64) for _ in handles]
    finals = []
    for r, (out, log) in enumerate(zip(outs, logs)):
        assert f"NATIVE_W2V_OK rank={r}" in out, out[-2000:]
        assert f"prefetch={prefetch}" in out
        batches = w2v.make_batches(np.random.default_rng(r), W2V_STEPS,
                                   W2V_BATCH)
        steps = [e for e in log if e[0] != "final"]
        assert [k for k, *_ in steps] == ["get", "get", "add",
                                          "add"] * W2V_STEPS
        for i, (rows_in, rows_out, c_loc, o_loc, neg_loc) in enumerate(
                batches):
            g_in, g_out, a_in, a_out = steps[4 * i:4 * i + 4]
            assert [e[1] for e in (g_in, g_out, a_in, a_out)] == handles * 2
            assert np.array_equal(g_in[2], rows_in)
            assert np.array_equal(g_out[2], rows_out)
            d_in, d_out = w2v.sgns_row_grads(g_in[3], g_out[3], c_loc,
                                             o_loc, neg_loc)
            assert np.array_equal(a_in[3], d_in)
            assert np.array_equal(a_out[3], d_out)
            np.add.at(total[0], rows_in, d_in)
            np.add.at(total[1], rows_out, d_out)
        fin = {h: (ids, val) for k, h, ids, val in log if k == "final"}
        finals.append([fin[h] for h in handles])
        # The first batch scores lower on the final rows than on the rows
        # it pulled.
        rows_in, rows_out, c_loc, o_loc, neg_loc = batches[0]
        (ids_in, fin_in), (ids_out, fin_out) = finals[-1]
        before = _sgns_loss(steps[0][3], steps[1][3], c_loc, o_loc, neg_loc)
        after = _sgns_loss(fin_in[np.searchsorted(ids_in, rows_in)],
                           fin_out[np.searchsorted(ids_out, rows_out)],
                           c_loc, o_loc, neg_loc)
        assert after < before, (before, after)
    rng = np.random.default_rng(W2V_SEED)
    for t in range(2):
        init = rng.normal(0, 0.1, (w2v.VOCAB, w2v.DIM)).astype(np.float32)
        for rank_finals in finals:
            ids, val = rank_finals[t]
            want = init[ids] - np.float32(w2v.LR) * total[t][ids]
            assert np.max(np.abs(val - want)) <= 1e-5 * np.max(np.abs(init))


def test_serve_bench_worker_two_ranks(tmp_path):
    outs = _launch(tmp_path, lambda mf, r: [
        os.path.join(APPS, "serve_bench_worker.py"), mf, str(r)])
    for r, out in enumerate(outs):
        assert f"SERVE_BENCH_OK rank={r}" in out, out[-2000:]
    got = {m.group(1): float(m.group(2))
           for m in re.finditer(r"(\w+)=([0-9.]+)", outs[0])}
    for key in ("cold", "cached", "coal8"):
        assert got[f"{key}_p50_ms"] > 0 and got[f"{key}_qps"] > 0
    assert got["cached_p50_ms"] < got["cold_p50_ms"]


# ------------------------------------------- ServeClient in one process

@pytest.fixture(scope="module")
def srt():
    r = nat.NativeRuntime(args=["-updater_type=default",
                                "-log_level=error"])
    yield r
    r.shutdown()


class _Counting:
    """The runtime, with each ``array_get`` result kept: what the
    client's cache holds can be compared with what the wire returned."""

    def __init__(self, rt):
        self.rt, self.fetched = rt, []

    def array_get(self, handle, size):
        self.fetched.append(self.rt.array_get(handle, size))
        return self.fetched[-1]

    def __getattr__(self, name):
        return getattr(self.rt, name)


def test_serve_client_one_copy_per_miss_and_mutation_proof(srt):
    metrics.reset()
    h = srt.new_array_table(16)
    srt.array_add(h, np.ones(16, np.float32))
    rt = _Counting(srt)
    c = ServeClient(rt, cache_entries=8, max_staleness=0, window_us=0.0,
                    lease_ms=60000)
    first = c.array_get(h, 16)
    assert len(rt.fetched) == 1
    stored, _ = c.cache.lookup((h, "array", 16), min_version=0)
    assert stored is rt.fetched[0]          # the wire array itself ...
    assert not stored.flags.writeable       # ... stored read-only
    assert first is not stored and first.flags.writeable
    first[:] = -99.0                        # the caller's own copy
    again = c.array_get(h, 16)              # a hit: pristine
    assert len(rt.fetched) == 1 and np.all(again == 1.0)
    assert metrics.counter("serve.cache.hit").value >= 1
    c.array_add(h, np.ones(16, np.float32))  # write-through
    assert np.all(c.array_get(h, 16) == 2.0)
    assert len(rt.fetched) == 2


def test_serve_client_retries_a_busy_storm(srt):
    metrics.reset()
    c = ServeClient(srt, cache_entries=32)
    h = srt.new_array_table(8)
    srt.array_add(h, np.ones(8, np.float32))
    fault.configure(sites={"serve.busy": {"times": 2,
                                          "error": nat.BusyError}})
    try:
        np.testing.assert_allclose(c.array_get(h, 8), 1.0)
        assert fault.count("retry.attempts") >= 2
    finally:
        fault.reset()
    fault.configure(sites={"serve.busy": {"times": 100,
                                          "error": nat.BusyError}})
    try:
        with pytest.raises(nat.BusyError):
            ServeClient(srt, cache_entries=0).array_get(h, 8)
    finally:
        fault.reset()


def test_embedding_bench_worker_two_ranks(tmp_path):
    """ServeClient's other user: the epoll fleet's cold, row-cached and
    replica tiers at a small table (4,096 rows, 64 requests)."""
    outs = _launch(tmp_path, lambda mf, r: [
        os.path.join(APPS, "embedding_bench_worker.py"), mf, str(r),
        "4096", "64"])
    for r, out in enumerate(outs):
        assert "EMBED_BENCH_OK" in out, out[-2000:]
    line = next(o for o in outs if "rank=1" in o)
    got = {m.group(1): float(m.group(2))
           for m in re.finditer(r"(\w+)=([0-9.]+)", line)}
    assert got["cold_p50_ms"] > 0 and got["rowcache_p50_ms"] > 0
