"""Assign updater — ``w = delta`` (last-write-wins).

Port of ``multiverso_tpu/updaters/assign.py``: a table under this updater
is a bit-exact store, not an accumulator.  Duplicates in one row batch
resolve last-write-wins (order within the batch), and ``apply_rows`` is
NOT linear — padding goes through the masked filter so it cannot clobber
real rows.
"""

from __future__ import annotations

from .base import AddOption, Updater, _kept_rows, register_updater

__all__ = ["AssignUpdater"]


@register_updater
class AssignUpdater(Updater):
    name = "assign"
    num_slots = 0
    # Not linear: assign(sum of duplicates) != last duplicate assigned.
    linear = False

    def apply_dense(self, w, state, delta, opt: AddOption):
        return delta.to(w.dtype), state

    def apply_rows(self, w, state, rows, delta, opt: AddOption,
                   mask=None):
        kept = _kept_rows(rows, mask, w.shape[0], anchored=True)
        return kept.put_(w, delta), state
