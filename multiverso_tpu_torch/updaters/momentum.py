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
        kept = _kept_rows(rows, mask, w.shape[0], anchored=True)
        d = kept.zeroed(delta, w)
        v_rows = (opt.momentum * v.index_select(0, kept.target)
                  + opt.learning_rate * d)
        w.index_add_(0, kept.target, kept.zeroed(v_rows, w), alpha=-1)
        kept.put_(v, v_rows)
        return w, (v,)
