"""Torch module parameters behind one table — the port of
``multiverso_tpu/ext/torch_ext.py``.

Reference (SURVEY.md §2.33, ``binding/lua/``): the Lua/Torch binding's
``MVNetParamManager`` flattens a network's parameters into ONE
ArrayTable; each worker trains locally and delta-syncs every iteration.

PyTorch: the module, the table and the delta all stay on the table's
device.  The flat vector is one ``torch.cat`` of the parameters, the
push is the table's device add, the pull ``get(device=True)``, and the
write-back one ``torch._foreach_copy_`` of views of the merged tensor,
so the uncompressed sync makes no host copy and never waits for the
device.  A module on another device than the table raises; it is never
moved quietly.  Under several processes the table is sharded: the push
is the collective add, and the pull the collective ``get()`` (the
reference's own pull), placed back on the table's device.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from ..core import context as core_context
from ..tables import ArrayTable
from ..tables.base import host_put, is_multiprocess

__all__ = ["TorchParamManager"]


def table_holding(flat: torch.Tensor, name: Optional[str]) -> ArrayTable:
    """An ASP ArrayTable (``updater_type="default"``, ``sync=False``:
    the push-then-pull delta protocol needs adds visible at once, even
    under a BSP runtime) whose value is the float32 vector ``flat`` —
    the JAX package's ``ArrayTable(init=flat)`` without a host hop."""
    table = ArrayTable(flat.numel(), updater_type="default", sync=False,
                       name=name)
    table.raw_assign(table.local_part(
        flat.to(table.device, torch.float32)).clone())
    return table


def pull(table: ArrayTable) -> torch.Tensor:
    """The table's value as a fresh tensor on its device:
    ``get(device=True)`` in one process, the collective ``get()`` placed
    on the device under several (every rank calls it together)."""
    if is_multiprocess():
        return host_put(table.get(), table.device)
    return table.get(device=True)


def delta_sync(table: ArrayTable, flat: torch.Tensor, synced: torch.Tensor,
               average: bool = True, peers: Optional[int] = None,
               compress: Optional[str] = None) -> torch.Tensor:
    """The delta-sync protocol (reference ``mv_sync``): push ``(flat -
    synced) · scale`` through ``table``'s add and return the merged value
    pulled with :func:`pull` — the new ``synced``.  ``scale`` is
    ``1/peers`` when ``average`` (``peers`` defaults to
    ``workers_num()``), else 1.  ``compress="1bit"``: sign-bit wire
    format with error feedback, through the table's compressed add (its
    quantizer runs on the host)."""
    peers = peers or core_context.workers_num()
    scale = (1.0 / peers) if average else 1.0
    table.add((flat - synced) * scale, compress=compress)
    return pull(table)


def _on_device(params: List[torch.Tensor], device: torch.device) -> None:
    for p in params:
        if p.device != device:
            raise ValueError(
                f"module parameter on {p.device}, table on {device}: move "
                f"the module to the table's device first")


class TorchParamManager:
    """Sync a ``torch.nn.Module``'s parameters through one ArrayTable."""

    def __init__(self, module, name: Optional[str] = None,
                 average: bool = True, table: Optional[ArrayTable] = None,
                 peers: Optional[int] = None):
        """``table``: share another worker's table (multi-worker-in-process
        mode, the reference's degenerate test layout) instead of creating
        one; the module must have the same parameter count, and adopts
        the table's weights.  ``peers``: total number of workers
        contributing to the table — defaults to ``workers_num()``
        (process count), which undercounts when several in-process
        managers share one table, so shared-table users must pass it for
        true averaging."""
        self.module = module
        self._params = list(module.parameters())
        self._average = average
        self._peers = peers
        device = (table.device if table is not None
                  else torch.device(core_context.get_context().device))
        _on_device(self._params, device)
        flat = self._flatten()
        if table is not None:
            if table.size != flat.numel():
                raise ValueError(
                    f"shared table holds {table.size} params, module has "
                    f"{flat.numel()}")
            self.table = table
            self._synced = pull(table)
            self._write_back(self._synced)  # adopt the shared weights
        else:
            self.table = table_holding(flat, name)
            self._synced = flat

    def _flatten(self) -> torch.Tensor:
        """The parameters as one fresh float32 vector on their device."""
        return torch.cat([p.detach().reshape(-1) for p in self._params]
                         ).to(torch.float32)

    def _write_back(self, flat: torch.Tensor) -> None:
        views = [v.view(p.shape) for v, p in zip(
            flat.split([p.numel() for p in self._params]), self._params)]
        with torch.no_grad():
            torch._foreach_copy_(self._params, views)

    def sync_all_param(self, compress: Optional[str] = None) -> None:
        """Push local progress, pull merged params into the module.

        Reference protocol (Lua binding docs): each worker contributes
        ``(local - last_synced) / workers``; the merged value overwrites the
        module's parameters in place.  ``compress``: see ``delta_sync``.
        """
        self._synced = delta_sync(self.table, self._flatten(), self._synced,
                                  self._average, self._peers, compress)
        self._write_back(self._synced)
