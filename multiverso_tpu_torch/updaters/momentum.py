"""Momentum updater — reference ``updater/momentum_updater.h`` (SURVEY.md §2.16).

Port of ``multiverso_tpu/updaters/momentum.py``."""

from __future__ import annotations

from typing import Optional

import torch

from .base import AddOption, Updater, _kept_rows, register_updater


@register_updater
class MomentumUpdater(Updater):
    """v = mu*v + lr*g ; w -= v."""

    name = "momentum"
    num_slots = 1
    linear = False  # duplicate rows must be segment-summed before apply

    def apply_dense(self, w, state, delta, opt: AddOption):
        (v,) = state
        v = opt.momentum * v + opt.learning_rate * delta
        return w - v, (v,)

    def apply_rows(self, w, state, rows, delta, opt: AddOption,
                   mask: Optional[torch.Tensor] = None):
        (v,) = state
        rows, d = _kept_rows(rows, delta, mask, w.shape[0])
        v_rows = opt.momentum * v[rows] + opt.learning_rate * d
        v = v.index_put((rows,), v_rows)
        return w.index_add(0, rows, -v_rows), (v,)
