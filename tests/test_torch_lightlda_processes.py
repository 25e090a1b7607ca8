"""What the JAX package's LightLDA does under several processes, the
record behind the port's refusal of its device sweeps there.

Two OS processes join one ``jax.distributed`` job on the CPU through the
harness of ``test_multiprocess.py`` (its capability probe and port
retry) and run ``tests/mp_lda_worker.py``: one sweep of each kind from
the same start.  The eager sweep (``sample_pass``) runs and conserves
its counts, so the job itself works; the device sweeps
(``run_fused_pass``, ``run_mh_pass``) raise, because they fetch an
array sharded over both processes' devices to the host.  The port's
``make_fused_pass`` and ``make_mh_pass`` refuse under a process group
for that reason (``test_torch_shards.py``'s refusal test).
"""

import json
import os
import subprocess
import sys

import pytest

from test_multiprocess import (_BIND_RACE_MARKERS, _deadline, _free_port,
                               _require_mp_collectives)

_HERE = os.path.dirname(os.path.abspath(__file__))
NPROCS = 2
DEVICE_SWEEPS = ("run_fused_pass", "run_mh_pass")


def _spawn(port):
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env.pop("XLA_FLAGS", None)
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(_HERE, "mp_lda_worker.py"),
         str(port), str(i), str(NPROCS)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env) for i in range(NPROCS)]
    left = _deadline(240.0)
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=left())[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return procs, outs


@pytest.fixture(scope="module")
def results():
    """Each rank's ``LDA_RESULT``, from one two-process job."""
    _require_mp_collectives()
    for attempt in range(3):
        procs, outs = _spawn(_free_port())
        failed = [i for i, p in enumerate(procs) if p.returncode != 0]
        if failed and attempt < 2 and all(
                any(m in outs[i] for m in _BIND_RACE_MARKERS)
                for i in failed):
            continue
        got = []
        for i, (p, out) in enumerate(zip(procs, outs)):
            assert p.returncode == 0 and f"WORKER_OK {i}" in out, (
                f"worker {i} failed (rc={p.returncode}):\n{out[-4000:]}")
            line = next(ln for ln in out.splitlines()
                        if ln.startswith("LDA_RESULT "))
            got.append(json.loads(line[len("LDA_RESULT "):]))
        return got


def test_eager_sweep_runs_across_processes(results):
    for rank in results:
        got = rank["sample_pass"]
        assert got["ran"], got
        # Each rank's doc counts cover its documents; the global tables
        # agree with each other.
        assert got["doc_topic"] == got["tokens"]
        assert got["word_topic"] == got["topic_sum"] > 0


@pytest.mark.parametrize("sweep", DEVICE_SWEEPS)
def test_device_sweep_raises_across_processes(results, sweep):
    for rank in results:
        got = rank[sweep]
        assert not got["ran"], got
        assert got["error"] == "RuntimeError", got
        assert "non-addressable" in got["message"], got
