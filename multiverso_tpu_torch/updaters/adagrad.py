"""AdaGrad updater — reference ``updater/adagrad_updater.h`` (SURVEY.md §2.16).

Port of ``multiverso_tpu/updaters/adagrad.py``: per-row accumulator state
is updated with the same scatter as the weights.
"""

from __future__ import annotations

from typing import Optional

import torch

from .base import AddOption, Updater, _kept_rows, register_updater


@register_updater
class AdaGradUpdater(Updater):
    """h += g^2 ; w -= lr * g / (sqrt(h) + eps)."""

    name = "adagrad"
    num_slots = 1
    linear = False  # duplicate rows must be segment-summed before apply

    def apply_dense(self, w, state, delta, opt: AddOption):
        (h,) = state
        h = h + delta * delta
        w = w - opt.learning_rate * delta / (torch.sqrt(h) + opt.eps)
        return w, (h,)

    def apply_rows(self, w, state, rows, delta, opt: AddOption,
                   mask: Optional[torch.Tensor] = None):
        (h,) = state
        kept = _kept_rows(rows, mask, w.shape[0])
        d = kept.zeroed(delta, w)
        # State accumulates by scatter-add (exact for uniques,
        # accumulate-then-read for duplicates), as in the JAX package.
        h.index_add_(0, kept.target, d * d)
        step = opt.learning_rate * d / (
            torch.sqrt(h.index_select(0, kept.target)) + opt.eps)
        return w.index_add_(0, kept.target, step, alpha=-1), (h,)
