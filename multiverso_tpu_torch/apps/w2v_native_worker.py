"""N-process native-wire word2vec worker — the measured stand-in for
the reference's distributed word-embedding baseline.

``BASELINE.json`` frames the ≥8× north star as "LR + word2vec"; the LR
half got its 8-process native-wire denominator in round 4
(``lr_native_worker.py``), and this worker closes the word2vec half.
The reference app (SURVEY.md §2.36, ``Microsoft/distributed_word_embedding``
linking ``libmultiverso``) shards the embedding matrices across servers
as row-partitioned MatrixTables; each worker pulls only the rows its
batch touches (``GetMatrixTableByRows``), computes skip-gram
negative-sampling gradients locally, and pushes row deltas back
(``AddMatrixTableByRows``).  This worker reproduces that mechanism on
this repo's native runtime: worker+server rank over TcpNet, touched-row
pull → numpy SGNS gradient → row-delta push through the C API into the
C++ sgd updater.

Per batch of B (center, context) pairs with K negatives the touched set
is ``unique(centers)`` on the input table and ``unique(contexts ∪
negatives)`` on the output table — the sparse-access pattern that makes
a parameter server the right shape for this model (dense pulls of a
100k×128 table per batch would be ~100× more wire traffic).

Deltas go back through NON-blocking adds (``MV_AddAsyncMatrixTableByRows``
— the reference app's ASP push mode; the trailing barrier flushes the
pipeline so every delta lands inside the timed window), and with
``prefetch=True`` the next batch's rows are pulled through the async
Get handles (``MV_GetAsyncMatrixTableByRows``) issued right after this
batch's delta pushes — the reference's AsyncBuffer double-buffer idiom
(SURVEY.md §2.24) expressed over the wire.  The pushes go first so the
ordered connection applies them before the gets are served: prefetch-on
and prefetch-off then read under the SAME staleness regime and the A/B
isolates the overlap mechanism (both tables' gets pipelined behind the
in-flight adds) rather than overlap plus extra staleness.

Run: ``python w2v_native_worker.py <machine_file> <rank> <steps>
<batch> [prefetch]`` (spawned by ``bench.py``; stands alone for
debugging).
"""

import os
import sys
import time

# Before ANY multiverso/jax import: this process must not touch the TPU
# the spawning bench run holds (same seam as tests/mp_worker.py).
os.environ["JAX_PLATFORMS"] = "cpu"

import numpy as np  # noqa: E402

VOCAB = 100_000
DIM = 128
NEGATIVES = 5
LR = 0.025


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


def make_batches(rng, steps, batch):
    """Pre-drawn (center, context, negatives) index batches plus the
    per-table unique row sets and local scatter indices — all the
    id-wrangling hoisted out of the timed loop, mirroring how the
    reference app's data pipeline pre-tokenizes outside the wire path."""
    batches = []
    for _ in range(steps):
        c = rng.integers(VOCAB, size=batch).astype(np.int32)
        o = rng.integers(VOCAB, size=batch).astype(np.int32)
        neg = rng.integers(VOCAB, size=(batch, NEGATIVES)).astype(np.int32)
        rows_in, c_loc = np.unique(c, return_inverse=True)
        out_ids = np.concatenate([o, neg.reshape(-1)])
        rows_out, out_loc = np.unique(out_ids, return_inverse=True)
        o_loc = out_loc[:batch].astype(np.int32)
        neg_loc = out_loc[batch:].reshape(batch, NEGATIVES).astype(np.int32)
        batches.append((rows_in.astype(np.int32), rows_out.astype(np.int32),
                        c_loc.astype(np.int32), o_loc, neg_loc))
    return batches


def sgns_row_grads(w_in, w_out, c_loc, o_loc, neg_loc):
    """Skip-gram negative-sampling gradients over the LOCAL row blocks.

    ``w_in``/``w_out`` hold only the batch's touched rows; ``*_loc``
    index into them.  Returns dense per-row delta blocks (scatter-added
    over duplicate tokens) ready for AddMatrixTableByRows."""
    v = w_in[c_loc]                          # [B, D] center vectors
    u_o = w_out[o_loc]                       # [B, D] positive context
    u_n = w_out[neg_loc]                     # [B, K, D] negatives
    g_o = _sigmoid(np.einsum("bd,bd->b", v, u_o)) - 1.0      # [B]
    g_n = _sigmoid(np.einsum("bd,bkd->bk", v, u_n))          # [B, K]
    d_v = g_o[:, None] * u_o + np.einsum("bk,bkd->bd", g_n, u_n)
    d_in = np.zeros_like(w_in)
    np.add.at(d_in, c_loc, d_v)
    d_out = np.zeros_like(w_out)
    np.add.at(d_out, o_loc, g_o[:, None] * v)
    np.add.at(d_out, neg_loc.reshape(-1),
              (g_n[:, :, None] * v[:, None, :]).reshape(-1, v.shape[1]))
    return d_in, d_out


def main(argv) -> None:
    mf, rank = argv[0], int(argv[1])
    steps, batch = int(argv[2]), int(argv[3])
    prefetch = len(argv) > 4 and argv[4] not in ("", "0", "false")

    from multiverso_tpu_torch import native as nat

    rt = nat.NativeRuntime(args=[f"-machine_file={mf}", f"-rank={rank}",
                                 "-updater_type=sgd", "-log_level=error"])
    h_in = rt.new_matrix_table(VOCAB, DIM)
    h_out = rt.new_matrix_table(VOCAB, DIM)
    rt.set_add_option(learning_rate=LR)

    rng = np.random.default_rng(rank)
    batches = make_batches(rng, steps, batch)

    def fetch(i):
        rows_in, rows_out = batches[i][0], batches[i][1]
        if not prefetch:
            return (rt.matrix_get_rows(h_in, rows_in, DIM),
                    rt.matrix_get_rows(h_out, rows_out, DIM))
        return (rt.matrix_get_rows_async(h_in, rows_in, DIM),
                rt.matrix_get_rows_async(h_out, rows_out, DIM))

    def resolve(pair):
        return (pair[0].wait(), pair[1].wait()) if prefetch else pair

    rt.barrier()              # all ranks timed over the same window
    t0 = time.perf_counter()
    pending = fetch(0)
    for i in range(steps):
        w_in, w_out = resolve(pending)
        rows_in, rows_out, c_loc, o_loc, neg_loc = batches[i]
        d_in, d_out = sgns_row_grads(w_in, w_out, c_loc, o_loc, neg_loc)
        # Push THIS batch's deltas before issuing the next pull: the
        # async gets ride the same ordered connection as the async adds,
        # so batch i+1 reads post-add rows — the same staleness regime
        # the prefetch-off path sees — and the A/B isolates the overlap
        # mechanism itself (gets for both tables pipelined behind the
        # in-flight adds) rather than overlap + extra staleness.
        rt.matrix_add_rows(h_in, rows_in, d_in, sync=False)
        rt.matrix_add_rows(h_out, rows_out, d_out, sync=False)
        if i + 1 < steps:
            pending = fetch(i + 1)
    rt.barrier()              # every rank's adds applied
    dt = time.perf_counter() - t0

    print(f"NATIVE_W2V_OK rank={rank} dt={dt:.6f} steps={steps} "
          f"batch={batch} prefetch={int(prefetch)}", flush=True)
    rt.shutdown()


if __name__ == "__main__":
    main(sys.argv[1:])
