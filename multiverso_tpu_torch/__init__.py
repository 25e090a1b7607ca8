"""multiverso_tpu_torch — the PyTorch/CUDA port of multiverso_tpu.

A second package beside the JAX one, for one NVIDIA H100 (Hopper) per
process.  It carries

- the paper's own training loop: ``init()`` → ``ArrayTable.get()`` →
  local gradient → ``add()`` through a server-side updater →
  ``barrier()``, in ASP, BSP and SSP, with the 1-bit compressed add and
  the device-resident add/get, and the logistic-regression app on its
  push-pull and fused paths (SURVEY.md §3.2-3.4);
- the row path: ``MatrixTable``/``SparseMatrixTable`` ``get_rows`` →
  local gradient → ``add_rows`` through the updaters' in-place row
  scatter, the host-resident ``KVTable`` and ``create_table``, and the
  word2vec (``SkipGram``) and DLRM apps on it;
- checkpoints (``checkpoint``) whose files the JAX package reads and
  writes too;
- LightLDA, the skip-gram mixture and ResNet-20 with its parameter
  managers (``apps``, ``ext``);
- the transformer trainer, with mixture-of-experts layers, remat and the
  state offload, on one card or on a dp/sp/tp/pp/ep mesh of processes
  (``models``, ``parallel``), and the three flash-attention kernels
  written by hand in CUDA C++ for ``sm_90a`` (``ops/csrc/``);
- tables sharded across ranks, and the native C++ runtime with its serve
  tier, its workers, the Lua binding and the operator CLIs (``native``,
  ``serve``, ``binding``, ``tools``);
- the host planes: flags, logging, metrics, tracing, the dashboard, the
  fault injector, the flight recorder, the health and latency planes and
  the capacity gauges.

Every module of the JAX package has its counterpart here (ROADMAP.md,
Queue 1).

It imports ``torch`` and never ``jax``, and nothing of ``multiverso_tpu``.
Entry points run on the card unless the caller passes ``device="cpu"``
(to ``init`` for the tables and apps); on a CPU tensor every kernel runs
its plain PyTorch version.

Top-level API mirrors the JAX package's (``multiverso_tpu/__init__.py``)
for what the port has.
"""

from __future__ import annotations

from . import (apps, checkpoint, config, dashboard, fault, io, metrics,
               models, ops, serve, tracing)
from .core import (
    BarrierTimeout,
    barrier,
    clock,
    get_context,
    init,
    initialized,
    is_master_worker,
    num_replicas,
    server_id,
    servers_num,
    shutdown,
    worker_id,
    workers_num,
)
from .device import resolve_device
from .log import Log
from .tables import (
    ArrayTable,
    KVTable,
    MatrixTable,
    SparseMatrixTable,
    Table,
    create_table,
)
from .updaters import AddOption, GetOption, get_updater

__version__ = "0.1.0"

# Binding-parity handler aliases (reference ``tables.py``: TableHandler /
# ArrayTableHandler with .get()/.add(data, sync=...)).  The tables already
# speak that exact surface, so handlers are the tables themselves.
TableHandler = Table
ArrayTableHandler = ArrayTable


class MatrixTableHandler(MatrixTable):
    """Reference ``MatrixTableHandler`` surface (SURVEY.md §2.29).

    Adds the reference's ``*_by_rows`` method names over MatrixTable.
    """

    def get_all(self):
        return self.get()

    def add_all(self, delta, option=None, sync: bool = False):
        return self.add(delta, option=option, sync=sync)

    def get_by_rows(self, row_ids, option=None):
        return self.get_rows(row_ids, option=option)

    def add_by_rows(self, delta, row_ids, option=None, sync: bool = False):
        return self.add_rows(row_ids, delta, option=option, sync=sync)


__all__ = [
    "init", "shutdown", "initialized", "barrier", "clock",
    "worker_id", "workers_num", "server_id", "servers_num",
    "is_master_worker", "num_replicas", "get_context",
    "Table", "ArrayTable", "MatrixTable", "SparseMatrixTable", "KVTable",
    "create_table", "TableHandler", "ArrayTableHandler", "MatrixTableHandler",
    "AddOption", "GetOption", "get_updater",
    "apps", "checkpoint", "config", "dashboard", "Log", "io", "fault",
    "metrics",
    "models", "ops", "resolve_device", "serve", "tracing",
    "BarrierTimeout",
]
