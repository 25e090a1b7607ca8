"""Two processes of the port, over gloo on the CPU.

Each rank adds its own delta to a BSP ``ArrayTable``; after ``barrier()``
both ranks ``get()`` the same vector, and it equals what the JAX package
holds after the stacked ``[d0, d1]`` add in one process.  The same
holds for an ASP table (the eager add is a collective sum) and for the
1-bit add (each rank's payload gathered and decoded on every rank), and
``multihost_allgather_list`` returns unequal per-rank lengths trimmed.
On a ``MatrixTable`` the ranks ``add_rows`` different, overlapping id
sets and then ``get_rows`` different ids (the row-union collectives):
both ranks then hold what the JAX package holds after one add of the
union of both batches, and so does a ``SparseMatrixTable`` whose host
mirror held the rows before the adds.

The ranks run as subprocesses under a hard timeout and are killed on
expiry, so a hang fails this test instead of the suite.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 40
TOL = 1e-6
TIMEOUT_S = 120

RANK = textwrap.dedent("""
    import sys

    import numpy as np
    import torch.distributed as dist

    import multiverso_tpu_torch as mv
    from multiverso_tpu_torch.tables import (multihost_allgather_list,
                                             multihost_sum)

    rank, store, out, n = (int(sys.argv[1]), sys.argv[2], sys.argv[3],
                           int(sys.argv[4]))
    mv.init(device="cpu", distributed=True, backend="gloo",
            init_method="file://" + store, world_size=2, rank=rank)
    assert mv.workers_num() == 2 and mv.worker_id() == rank
    d = np.random.RandomState(rank).randn(n).astype(np.float32)

    bsp = mv.ArrayTable(n, sync=True, name="bsp", updater_type="adagrad")
    bsp.add(d, option=mv.AddOption(learning_rate=0.5))
    before = bsp.get()
    mv.barrier()
    after = bsp.get()

    asp = mv.ArrayTable(n, name="asp", updater_type="sgd")
    asp.add(d)
    q = mv.ArrayTable(n, name="q")
    q.add(d, compress="1bit")
    try:
        asp.get(device=True)
        device_get = "served"
    except RuntimeError:
        device_get = "refused"
    rows = ROW_IDS[rank]
    g = np.random.RandomState(10 + rank).randn(len(rows), 4).astype(
        np.float32)
    m = mv.MatrixTable(13, 4, name="rows", updater_type="adagrad")
    m.add_rows(rows, g)
    got_rows = m.get_rows(GET_IDS[rank])
    sp = mv.SparseMatrixTable(13, 4, name="sparse", updater_type="adagrad")
    sp.get_rows(GET_IDS[rank])          # warms this rank's host mirror
    sp.add_rows(rows, g)
    sparse_rows = sp.get_rows(GET_IDS[rank])
    parts = multihost_allgather_list(np.arange(rank + 3, dtype=np.float32))
    total = multihost_sum(np.full(3, rank + 1.0, np.float32))
    np.savez(out, before=before, after=after, asp=asp.get(), q=q.get(),
             part0=parts[0], part1=parts[1], total=total,
             device_get=device_get, rows=got_rows, matrix=m.get(),
             sparse_rows=sparse_rows)
    mv.shutdown()
    dist.destroy_process_group()
""")


# Each rank's row batch (overlapping, with a duplicate) and its reads.
ROW_IDS = [[0, 3, 5, 5, 12], [5, 7, 3, 11]]
GET_IDS = [[3, 5, 7, 1], [12, 0, 11]]


def _run_ranks(tmp_path):
    script = tmp_path / "rank.py"
    script.write_text(f"ROW_IDS = {ROW_IDS!r}\nGET_IDS = {GET_IDS!r}\n"
                      + RANK)
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(r), str(tmp_path / "store"),
         str(tmp_path / f"out{r}.npz"), str(N)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=str(tmp_path)) for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT_S)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        pytest.fail(f"ranks did not finish within {TIMEOUT_S} s")
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log[-4000:]}"
    return [np.load(tmp_path / f"out{r}.npz") for r in range(2)]


def _jax_stacked(mv, updater, option, sync, deltas):
    """The JAX package's table after the stacked [d0, d1] add."""
    mv.init(sync=sync, updater_type=updater)
    t = mv.ArrayTable(N, name=f"ref_{updater}")
    t.add(np.stack(deltas), option=option)
    mv.barrier()
    got = t.get()
    mv.shutdown()
    return got


@pytest.fixture(scope="module")
def outs(tmp_path_factory):
    """One run of the two ranks, read by every test here."""
    return _run_ranks(tmp_path_factory.mktemp("ranks"))


def test_two_ranks_share_one_table(mv, outs):
    from multiverso_tpu_torch.util.quantization import (dequantize_1bit,
                                                        quantize_1bit)

    deltas = [np.random.RandomState(r).randn(N).astype(np.float32)
              for r in range(2)]
    want_bsp = _jax_stacked(mv, "adagrad", mv.AddOption(learning_rate=0.5),
                            True, deltas)
    want_asp = _jax_stacked(mv, "sgd", None, False, deltas)
    want_q = sum(dequantize_1bit(*quantize_1bit(d)[:3], N) for d in deltas)
    for out in outs:
        np.testing.assert_allclose(out["before"], 0.0)
        np.testing.assert_allclose(out["after"], want_bsp, rtol=TOL,
                                   atol=TOL)
        np.testing.assert_allclose(out["asp"], want_asp, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(out["q"], want_q, rtol=TOL, atol=TOL)
        np.testing.assert_array_equal(out["part0"], np.arange(3))
        np.testing.assert_array_equal(out["part1"], np.arange(4))
        np.testing.assert_array_equal(out["total"], np.full(3, 3.0))
        assert str(out["device_get"]) == "refused"
    np.testing.assert_array_equal(outs[0]["after"], outs[1]["after"])


def test_two_ranks_add_and_read_row_unions(mv, outs):
    mv.init(updater_type="adagrad")
    ref = mv.MatrixTable(13, 4, name="ref_rows")
    ref.add_rows(np.concatenate(ROW_IDS), np.concatenate(
        [np.random.RandomState(10 + r).randn(len(ROW_IDS[r]), 4).astype(
            np.float32) for r in range(2)]))
    want = ref.get()
    mv.shutdown()
    for r, out in enumerate(outs):
        np.testing.assert_allclose(out["matrix"], want, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(out["rows"], want[GET_IDS[r]], rtol=TOL,
                                   atol=TOL)
        # The peer's adds reached rows this rank had cached: the sparse
        # table invalidates its whole mirror under several processes.
        np.testing.assert_allclose(out["sparse_rows"], want[GET_IDS[r]],
                                   rtol=TOL, atol=TOL)
