"""Smooth-gradient updater — reference ``updater/smooth_gradient_updater.h``
(SURVEY.md §2.16): exponential smoothing of incoming gradients before the
descent step.  Port of ``multiverso_tpu/updaters/smooth_gradient.py``."""

from __future__ import annotations

from typing import Optional

import torch

from .base import AddOption, Updater, _kept_rows, register_updater


@register_updater
class SmoothGradientUpdater(Updater):
    """s = rho*s + (1-rho)*g ; w -= lr*s."""

    name = "smooth_gradient"
    num_slots = 1
    linear = False  # duplicate rows must be segment-summed before apply

    def apply_dense(self, w, state, delta, opt: AddOption):
        (s,) = state
        s = opt.rho * s + (1.0 - opt.rho) * delta
        return w - opt.learning_rate * s, (s,)

    def apply_rows(self, w, state, rows, delta, opt: AddOption,
                   mask: Optional[torch.Tensor] = None):
        (s,) = state
        kept = _kept_rows(rows, mask, w.shape[0], anchored=True)
        d = kept.zeroed(delta, w)
        s_rows = (opt.rho * s.index_select(0, kept.target)
                  + (1.0 - opt.rho) * d)
        w.index_add_(0, kept.target, kept.zeroed(s_rows, w),
                     alpha=-opt.learning_rate)
        kept.put_(s, s_rows)
        return w, (s,)
