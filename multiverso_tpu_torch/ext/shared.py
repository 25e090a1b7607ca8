"""Shared variables and a tree param manager — the torch counterpart of
``multiverso_tpu/ext/jax_ext.py``.

Reference (SURVEY.md §2.30–2.31): ``theano_ext/sharedvar.py`` wraps a
Theano shared variable over an ArrayTable — the worker trains locally, then
``mv_sync()`` pushes ``value - last_synced`` and pulls the merged value;
``lasagne_ext/param_manager.py`` (``MVNetParamManager``) does the same for
every parameter of a network through ONE table.

PyTorch: the same delta-sync protocol over a tensor, or over a tree of
tensors (dicts, lists and tuples, walked with ``util.tree``).  Values are
float32 tensors on the table's device, and ``get_value``, ``mv_sync`` and
``sync`` return tensors there.  A tree's leaves lie in the table in
``jax.tree_util``'s order (dict keys sorted), so a table written by
either package holds the same vector.
"""

from __future__ import annotations

import threading
from typing import Any, List, Optional

import torch

from ..core import context as core_context
from ..util.tree import tree_map, tree_map_with_path
from .torch_ext import delta_sync, table_holding

__all__ = ["mv_shared", "MVSharedVariable", "SharedParamManager",
           "sync_all_mv_shared_vars"]

_ALL_SHARED: List["MVSharedVariable"] = []
_ALL_LOCK = threading.Lock()


def _device() -> torch.device:
    return torch.device(core_context.get_context().device)


def _f32(value, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(value, dtype=torch.float32, device=device)


class MVSharedVariable:
    """One tensor behind an ArrayTable with delta-sync (ref ``mv_shared``).

    Protocol (reference ``MVSharedVariable.mv_sync``): push
    ``(value - last_synced) / workers`` as the worker's contribution, pull
    the merged global value, overwrite the local copy.  Division by the
    worker count makes N identical workers converge to the same average
    the reference's example scripts get.
    """

    def __init__(self, value, name: Optional[str] = None,
                 average: bool = True):
        arr = _f32(value, _device())
        self.shape = tuple(arr.shape)
        self._average = average
        self.table = table_holding(arr.reshape(-1), name)
        self._value = arr.clone()
        self._synced = arr.clone()
        with _ALL_LOCK:
            _ALL_SHARED.append(self)

    def get_value(self) -> torch.Tensor:
        return self._value.clone()

    def set_value(self, value) -> None:
        self._value = _f32(value, self.table.device).reshape(self.shape)

    def mv_sync(self, compress: Optional[str] = None) -> torch.Tensor:
        """Push local delta, pull merged value (reference protocol).

        ``compress="1bit"`` sends the delta as sign bits + scales with
        error feedback (1/32 the wire bytes) — the delta-sync is exactly
        the wire-bound path the quantizer targets."""
        merged = delta_sync(self.table, self._value.reshape(-1),
                            self._synced.reshape(-1), self._average,
                            compress=compress).reshape(self.shape)
        self._value = merged.clone()
        self._synced = merged.clone()
        return merged


def mv_shared(value, name: Optional[str] = None,
              average: bool = True) -> MVSharedVariable:
    """Reference ``sharedvar.mv_shared`` constructor."""
    return MVSharedVariable(value, name=name, average=average)


def sync_all_mv_shared_vars(compress: Optional[str] = None) -> None:
    """Sync every shared variable (reference helper of the same name).

    Variables created under an earlier (shut-down) runtime are pruned —
    their tables died with that context.  ``compress`` forwards to each
    variable's ``mv_sync`` (e.g. ``"1bit"``).
    """
    live = core_context._CONTEXT
    with _ALL_LOCK:
        _ALL_SHARED[:] = [s for s in _ALL_SHARED if s.table._ctx is live]
        shared = list(_ALL_SHARED)
    for s in shared:
        s.mv_sync(compress=compress)


def _leaves(tree: Any) -> list:
    """``[(path, leaf)]`` of ``tree`` in ``jax.tree_util``'s order: a
    depth-first walk with each dict's keys sorted."""
    found: list = []
    tree_map_with_path(lambda path, leaf: found.append((path, leaf)), tree)
    found.sort(key=lambda pl: pl[0])
    return found


class SharedParamManager:
    """Whole-tree manager (reference ``MVNetParamManager``; §2.31).

    Flattens a tree of tensors (a ``state_dict``, plain dicts, lists) into
    ONE ArrayTable and delta-syncs it per step:

        mgr = SharedParamManager(params)
        ...
        params = mgr.sync(params)   # push local progress, pull merged
    """

    def __init__(self, params: Any, name: Optional[str] = None,
                 average: bool = True):
        device = _device()
        found = _leaves(params)
        leaves = [_f32(leaf, device) for _, leaf in found]
        self._paths = [path for path, _ in found]
        self._shapes = [tuple(leaf.shape) for leaf in leaves]
        self._sizes = [leaf.numel() for leaf in leaves]
        self._skeleton = tree_map(lambda _: None, params)
        self._average = average
        flat = torch.cat([leaf.reshape(-1) for leaf in leaves])
        self.table = table_holding(flat, name)
        self._synced = flat

    def _flatten(self, params: Any) -> torch.Tensor:
        return torch.cat([_f32(leaf, self.table.device).reshape(-1)
                          for _, leaf in _leaves(params)])

    def _unflatten(self, flat: torch.Tensor) -> Any:
        by_path = {path: part.view(shape) for path, part, shape in zip(
            self._paths, flat.split(self._sizes), self._shapes)}
        return tree_map_with_path(lambda path, _: by_path[path],
                                  self._skeleton)

    def sync(self, params: Any, compress: Optional[str] = None) -> Any:
        """Push ``(params - last_synced)/workers``, pull the merged tree.

        The returned leaves are views of one fresh tensor, so a caller
        that updates them in place leaves the manager's copy alone.
        ``compress="1bit"``: see ``MVSharedVariable.mv_sync``."""
        merged = delta_sync(self.table, self._flatten(params), self._synced,
                            self._average, compress=compress)
        self._synced = merged
        return self._unflatten(merged.clone())
