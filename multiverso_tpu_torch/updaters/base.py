"""Updater base + registry + the default (plain add) updater.

Port of ``multiverso_tpu/updaters/base.py``.  Reference:
``include/multiverso/updater/updater.h`` — base ``Update``/``Access``
virtuals and the ``GetUpdater`` factory switch (SURVEY.md §2.16).

The hooks stay functional — ``(w, state, delta, opt) -> (w', state')``
— so the trainer and the tests read the same as the JAX package.  The
dense path returns fresh tensors.  The row path scatters IN PLACE into
the ``w`` and state tensors it is given and returns them: where the JAX
package donates the table to a jitted scatter, a row add here costs what
the rows cost, never a copy of the whole table.

One semantic seam differs: the JAX row path sends padding to row
``num_rows`` and relies on ``.at[].add(mode="drop")`` to skip it, while
an out-of-range index is a device-side assert in CUDA.  ``_kept_rows``
therefore aims every dropped entry (masked off, or outside
``[0, num_rows)``) at a real row and the updaters zero its delta, all on
the device: filtering with a boolean index would make the host wait for
the device on every row apply.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, NamedTuple, Optional, Tuple, Type

import torch

__all__ = ["AddOption", "GetOption", "Updater", "register_updater",
           "get_updater", "updater_names", "aggregate_rows",
           "scatter_apply", "masked", "effective_rows"]


@dataclass(frozen=True)
class AddOption:
    """Per-Add hyper-parameters (reference ``AddOption``; SURVEY.md §2.10)."""

    learning_rate: float = 0.1
    momentum: float = 0.9
    rho: float = 0.9          # smoothing coefficient (smooth_gradient)
    eps: float = 1e-8         # adagrad denominator floor
    worker_id: int = -1       # carried for parity; unused by math


@dataclass(frozen=True)
class GetOption:
    """Per-Get options (reference ``GetOption``); reserved for parity."""

    worker_id: int = -1


State = Tuple[torch.Tensor, ...]


class Updater:
    """Functional updater. Subclasses override the three hooks."""

    name = "default"
    num_slots = 0  # state tensors, each shaped like the table
    # True iff apply is linear in the delta, i.e. scatter-adding duplicate
    # rows equals applying their pre-aggregated sum.  Non-linear updaters
    # require duplicate rows to be segment-summed first (aggregate_rows).
    linear = True

    # -- state --------------------------------------------------------------
    def init_state(self, shape, dtype=torch.float32,
                   device=None) -> State:
        return tuple(torch.zeros(shape, dtype=dtype, device=device)
                     for _ in range(self.num_slots))

    # -- dense path ---------------------------------------------------------
    def apply_dense(self, w: torch.Tensor, state: State, delta: torch.Tensor,
                    opt: AddOption) -> Tuple[torch.Tensor, State]:
        return w + delta, state

    # -- sparse (row) path --------------------------------------------------
    def apply_rows(self, w: torch.Tensor, state: State, rows: torch.Tensor,
                   delta: torch.Tensor, opt: AddOption,
                   mask: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, State]:
        """Scatter-apply to ``w[rows]``, in place.

        ``rows``: int [k]; ``delta``: [k, cols]; ``mask``: bool [k] marks
        valid entries (padding rows carry mask=False and must not touch
        state). Default: plain scatter-add, duplicate rows accumulate.
        """
        kept = _kept_rows(rows, mask, w.shape[0])
        return w.index_add_(0, kept.target, kept.zeroed(delta, w)), state


_REGISTRY: Dict[str, Type[Updater]] = {}


def register_updater(cls: Type[Updater]) -> Type[Updater]:
    _REGISTRY[cls.name] = cls
    return cls


register_updater(Updater)  # "default"
_REGISTRY["add"] = Updater  # alias


def get_updater(name: str) -> Updater:
    """Factory — reference ``Updater<T>::GetUpdater`` switch."""
    try:
        return _REGISTRY[name]()
    except KeyError:
        raise ValueError(
            f"unknown updater_type '{name}'; known: {sorted(_REGISTRY)}")


def updater_names():
    return sorted(_REGISTRY)


def aggregate_rows(rows: torch.Tensor, delta: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Static-shape segment-sum of duplicate row ids.

    Sorts the batch, sums each duplicate group into its first slot, and
    returns ``(uniq_rows [k], agg_delta [k, ...], mask [k])`` where surplus
    slots carry ``mask=False`` — the same triple as the JAX package, so
    ``Updater.apply_rows`` takes it unchanged.
    """
    order = torch.argsort(rows, stable=True)
    r = rows[order]
    d = delta[order]
    is_new = torch.ones(r.shape, dtype=torch.bool, device=r.device)
    is_new[1:] = r[1:] != r[:-1]
    seg = torch.cumsum(is_new, 0) - 1
    agg = torch.zeros_like(d).index_add_(0, seg, d)
    uniq = torch.zeros_like(r).scatter_(0, seg, r)
    mask = torch.zeros(r.shape, dtype=torch.bool,
                       device=r.device).index_fill_(0, seg, True)
    return uniq, agg, mask


def scatter_apply(upd: "Updater", data, state, rows, delta, opt: AddOption):
    """Row scatter with the linear/non-linear dispatch: linear updaters
    scatter duplicates directly (adds commute); non-linear ones get
    duplicates segment-summed first via ``aggregate_rows``."""
    if upd.linear:
        return upd.apply_rows(data, state, rows, delta, opt)
    uniq, agg, mask = aggregate_rows(rows, delta)
    return upd.apply_rows(data, state, uniq, agg, opt, mask=mask)


def masked(delta: torch.Tensor, mask: Optional[torch.Tensor]
           ) -> torch.Tensor:
    """Zero out padding rows so they cannot perturb weights or state."""
    if mask is None:
        return delta
    return torch.where(mask[:, None], delta, torch.zeros_like(delta))


def effective_rows(rows: torch.Tensor, mask: Optional[torch.Tensor],
                   num_rows: int) -> torch.Tensor:
    """Redirect padding entries to the out-of-bounds index ``num_rows``
    (the JAX package's convention; the port's own scatters never index
    such a row: ``_kept_rows`` aims it at a real one)."""
    if mask is None:
        return rows
    return torch.where(mask, rows, torch.full_like(rows, num_rows))


class _Kept(NamedTuple):
    """Where each entry of a row batch scatters, decided on the device."""

    target: torch.Tensor   # int64 [k]: a row inside the table, always
    keep: torch.Tensor     # bool [k]: the entry applies
    last: Optional[torch.Tensor]   # int64 [1]: the last kept entry

    def _col(self, like: torch.Tensor) -> torch.Tensor:
        return self.keep.view((-1,) + (1,) * (like.dim() - 1))

    def zeroed(self, values: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """``values`` in ``w``'s dtype, with dropped entries zero: what
        an additive scatter of them at ``target`` leaves unchanged."""
        values = values.to(w.dtype)
        return torch.where(self._col(values), values, 0)

    def put_(self, t: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
        """``t[target] = values`` in place, duplicates resolved by order:
        the last entry aimed at a row wins.  Dropped entries aim at the
        last kept entry's row (``anchored``) and write that entry's own
        value there, so they change nothing; with no entry kept they
        rewrite row 0 with itself.

        Every entry writes its row's winning value, so duplicate writes
        agree: ``index_put_`` leaves the order of writes to one row
        undefined on CUDA, and on the CPU once it splits a batch between
        threads.  The winner is found on the device, by a stable sort on
        the row and the last entry of each run of equal rows."""
        values = values.to(t.dtype)
        fill = torch.where(self.keep.any(),
                           values.index_select(0, self.last), t[:1])
        values = torch.where(self._col(values), values, fill)
        order = torch.argsort(self.target, stable=True)
        rows = self.target[order]
        k = rows.shape[0]
        # Sorted positions that end a run keep their own index; the rest
        # take the nearest run end to their right.
        inside = torch.zeros(k, dtype=torch.bool, device=rows.device)
        inside[:-1] = rows[1:] == rows[:-1]
        ends = torch.arange(k, device=rows.device).masked_fill(inside, k)
        ends = torch.cummin(ends.flip(0), 0).values.flip(0)
        return t.index_put_((rows,),
                            values.index_select(0, order[ends]))


def _kept_rows(rows: torch.Tensor, mask: Optional[torch.Tensor],
               num_rows: int, anchored: bool = False) -> _Kept:
    """The entries a ``mode="drop"`` scatter would apply — not masked off
    and inside ``[0, num_rows)`` — as a mask, and a row inside the table
    for EVERY entry, so no index ever leaves it and the host never waits
    for the device.  A dropped entry aims at row 0, or with ``anchored``
    (set-type scatters) at the row of the last kept entry.  Order is
    kept, so last-write-wins updaters resolve duplicates as the JAX
    package does on the CPU."""
    rows = rows.long()
    keep = (rows >= 0) & (rows < num_rows)
    if mask is not None:
        keep = keep & mask
    if not anchored:
        return _Kept(torch.where(keep, rows, 0), keep, None)
    k = rows.shape[0]
    if k == 0:
        return _Kept(rows, keep, rows)
    last = ((k - 1) - torch.argmax(keep.flip(0).to(torch.int32))).view(1)
    anchor = torch.where(keep.any(), rows.index_select(0, last), 0)
    return _Kept(torch.where(keep, rows, anchor), keep, last)
