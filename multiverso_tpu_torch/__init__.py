"""multiverso_tpu_torch — the PyTorch/CUDA port of multiverso_tpu.

A second package beside the JAX one, for one NVIDIA H100 (Hopper) per
process.  It carries

- the paper's own training loop: ``init()`` → ``ArrayTable.get()`` →
  local gradient → ``add()`` through a server-side updater →
  ``barrier()``, in ASP, BSP and SSP, with the 1-bit compressed add and
  the device-resident add/get, and the logistic-regression app on its
  push-pull and fused paths (SURVEY.md §3.2-3.4);
- the transformer trainer, with the three flash-attention kernels
  written by hand in CUDA C++ for ``sm_90a`` (``ops/csrc/``);
- the host planes it needs: flags, logging, metrics, tracing, the
  dashboard, the fault injector, the flight recorder and the capacity
  gauges.

The row tables (Matrix, SparseMatrix, KV), word2vec and the other apps
come in later slices (ROADMAP.md).

It imports ``torch`` and never ``jax``, and nothing of ``multiverso_tpu``.
Entry points run on the card unless the caller passes ``device="cpu"``
(to ``init`` for the tables and apps); on a CPU tensor every kernel runs
its plain PyTorch version.

Top-level API mirrors the JAX package's (``multiverso_tpu/__init__.py``)
for what the port has.
"""

from __future__ import annotations

from . import (apps, config, dashboard, fault, io, metrics, models, ops,
               serve, tracing)
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
from .tables import ArrayTable, Table
from .updaters import AddOption, GetOption, get_updater

__version__ = "0.1.0"

# Binding-parity handler aliases (reference ``tables.py``: TableHandler /
# ArrayTableHandler with .get()/.add(data, sync=...)).  The tables already
# speak that exact surface, so handlers are the tables themselves.
# ``MatrixTableHandler`` comes with the row path.
TableHandler = Table
ArrayTableHandler = ArrayTable

__all__ = [
    "init", "shutdown", "initialized", "barrier", "clock",
    "worker_id", "workers_num", "server_id", "servers_num",
    "is_master_worker", "num_replicas", "get_context",
    "Table", "ArrayTable", "TableHandler", "ArrayTableHandler",
    "AddOption", "GetOption", "get_updater",
    "apps", "config", "dashboard", "Log", "io", "fault", "metrics",
    "models", "ops", "resolve_device", "serve", "tracing",
    "BarrierTimeout",
]
