"""SGD updater — reference ``updater/sgd_updater.h`` (SURVEY.md §2.16).

Port of ``multiverso_tpu/updaters/sgd.py``."""

from __future__ import annotations

from typing import Optional

import torch

from .base import AddOption, Updater, _kept_rows, register_updater


@register_updater
class SGDUpdater(Updater):
    """w -= lr * g (delta is a gradient)."""

    name = "sgd"
    num_slots = 0

    def apply_dense(self, w, state, delta, opt: AddOption):
        return w - opt.learning_rate * delta, state

    def apply_rows(self, w, state, rows, delta, opt: AddOption,
                   mask: Optional[torch.Tensor] = None):
        kept = _kept_rows(rows, mask, w.shape[0])
        return w.index_add_(0, kept.target, kept.zeroed(delta, w),
                            alpha=-opt.learning_rate), state
