"""Multi-process worker for the JAX package's LightLDA sweeps (not a
pytest module).

Run as ``python mp_lda_worker.py <port> <pid> <nprocs>``.  Each process
joins a ``jax.distributed`` job over localhost as ``mp_worker.py`` does
(CPU backend, 2 local devices each), builds the same documents, and runs
one sweep of each kind from the same start: the eager push-pull sweep
(``sample_pass``) and the two device sweeps (``run_fused_pass``,
``run_mh_pass``).  It prints one line ``LDA_RESULT <json>``: for each
sweep either ``{"ran": true, ...}`` with the sums of its counts, or
``{"ran": false, "error": <type>, "message": <text>}``.
"""

import json
import os
import sys

port, pid, nprocs = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import multiverso_tpu as mv  # noqa: E402

mv.init(distributed=True,
        coordinator_address=f"127.0.0.1:{port}",
        num_processes=nprocs, process_id=pid)
assert jax.process_count() == nprocs, jax.process_count()

from multiverso_tpu.apps import LightLDA, synthetic_documents  # noqa: E402

docs, _ = synthetic_documents(16, 40, 4, doc_len=32, seed=5)
results = {}
for sweep in ("sample_pass", "run_fused_pass", "run_mh_pass"):
    lda = LightLDA(40, 4, name=f"lda_{sweep}")
    dt = lda.initialize_counts(docs, seed=5)
    try:
        dt = np.asarray(getattr(lda, sweep)(docs, dt))
        results[sweep] = {
            "ran": True, "tokens": int((docs >= 0).sum()),
            "doc_topic": float(dt.sum()),
            "word_topic": float(lda.word_topic.get().sum()),
            "topic_sum": float(lda.topic_sum.get().sum())}
    except Exception as e:  # noqa: BLE001 - the result is the exception
        results[sweep] = {"ran": False, "error": type(e).__name__,
                          "message": str(e)}
    mv.barrier()
    lda.close()

print("LDA_RESULT " + json.dumps(results), flush=True)
mv.barrier()
mv.shutdown()
print(f"WORKER_OK {pid}", flush=True)
