"""One rank of a ported native worker (``multiverso_tpu_torch/apps/
<name>.py``) run under a runtime that records what the rank pulled and
pushed, for ``tests/test_torch_native_fleet.py`` to replay in numpy.

    python tests/torch_native_rec.py <worker> <out.npz> <seed> <args...>

``<args...>`` are the worker's own (machine file, rank, ...).  The
worker's ``main`` runs unchanged; the runtime it makes is a subclass of
the port's ``NativeRuntime`` that logs each array or row pull (after its
``wait()`` for an async one) and each push, in the worker's order.  With
``<seed>`` > 0, rank 0 fills every matrix table with
``normal(0, 0.1)`` rows from that seed at the worker's first barrier
(through the sgd updater, so the table holds them up to rounding); the
word2vec worker's tables start at zero otherwise, where every gradient
is zero.  At shutdown each rank pulls the final values of the rows it
touched, and the ranks meet at a barrier before they stop.
"""

import importlib
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from multiverso_tpu_torch import native as nat  # noqa: E402


def recording_runtime(out_path, seed, log):
    base = nat.NativeRuntime

    class Recording(base):
        def __init__(self, args=None, build=True):
            super().__init__(args, build)
            self.rank = next(int(a.split("=")[1]) for a in args
                             if a.startswith("-rank="))
            self.matrices = {}
            self.lr = None
            self.seeded = False

        def _log(self, kind, h, ids, val):
            i = len(log) // 4
            log[f"{i}_kind"] = np.array(kind)
            log[f"{i}_h"] = np.array(h)
            log[f"{i}_ids"] = np.asarray(ids, np.int32)
            log[f"{i}_val"] = np.array(val, np.float32, copy=True)

        def set_add_option(self, learning_rate=0.1, **kw):
            self.lr = learning_rate
            super().set_add_option(learning_rate=learning_rate, **kw)

        def new_matrix_table(self, rows, cols):
            h = super().new_matrix_table(rows, cols)
            self.matrices[h] = (rows, cols)
            return h

        def barrier(self):
            if seed and not self.seeded and self.rank == 0:
                rng = np.random.default_rng(seed)
                for h, (rows, cols) in sorted(self.matrices.items()):
                    init = rng.normal(0, 0.1, (rows, cols)).astype(
                        np.float32)
                    super().matrix_add_all(h, -init / np.float32(self.lr))
            self.seeded = True
            super().barrier()

        def array_get(self, h, size, out=None):
            got = super().array_get(h, size, out=out)
            self._log("get", h, [], got)
            return got

        def array_add(self, h, delta, sync=True, borrowed=False):
            self._log("add", h, [], delta)
            super().array_add(h, delta, sync=sync, borrowed=borrowed)

        def matrix_get_rows(self, h, ids, cols, out=None):
            got = super().matrix_get_rows(h, ids, cols, out=out)
            self._log("get", h, ids, got)
            return got

        def matrix_get_rows_async(self, h, ids, cols, out=None,
                                  arena=None):
            pending = super().matrix_get_rows_async(h, ids, cols, out=out,
                                                    arena=arena)
            rt = self

            class Logged:
                def wait(self):
                    got = pending.wait()
                    rt._log("get", h, ids, got)
                    return got

            return Logged()

        def matrix_add_rows(self, h, ids, delta, sync=True,
                            borrowed=False):
            self._log("add", h, ids, delta)
            super().matrix_add_rows(h, ids, delta, sync=sync,
                                    borrowed=borrowed)

        def shutdown(self):
            touched = {h: np.unique(np.concatenate(
                [log[k] for k in list(log) if k.endswith("_ids")
                 and log[k[:-4] + "_h"] == h]))
                for h in self.matrices}
            for h, (_, cols) in sorted(self.matrices.items()):
                final = base.matrix_get_rows(self, h, touched[h], cols)
                self._log("final", h, touched[h], final)
            base.barrier(self)
            np.savez(out_path, **log)
            super().shutdown()

    return Recording


def main(argv) -> int:
    worker, out_path, seed = argv[0], argv[1], int(argv[2])
    mod = importlib.import_module(f"multiverso_tpu_torch.apps.{worker}")
    nat.NativeRuntime = recording_runtime(out_path, seed, {})
    mod.main(argv[3:])
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
