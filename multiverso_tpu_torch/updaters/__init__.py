"""Server-side updaters for the PyTorch port.

Port of ``multiverso_tpu/updaters`` (SURVEY.md §2.16): ``get_updater``
returns one of default/add, SGD, AdaGrad, Momentum, SmoothGradient or
Assign; each is a pair of functions ``(weights, state, delta, option) ->
(weights', state')`` over tensors, dense and row-sparse.

Delta convention (as in the JAX package):
- ``default``: delta IS the increment — ``w += delta``.
- ``sgd|adagrad|momentum|smooth_gradient``: delta is a *gradient*; the
  updater performs the descent step with ``AddOption`` hyper-params.
"""

from __future__ import annotations

from .base import (AddOption, GetOption, Updater, aggregate_rows,
                   effective_rows, get_updater, masked, register_updater,
                   scatter_apply, updater_names)
from . import sgd as _sgd            # noqa: F401  (registration side effect)
from . import adagrad as _adagrad    # noqa: F401
from . import momentum as _momentum  # noqa: F401
from . import smooth_gradient as _sg # noqa: F401
from . import assign as _assign      # noqa: F401

__all__ = [
    "AddOption",
    "GetOption",
    "Updater",
    "aggregate_rows",
    "effective_rows",
    "get_updater",
    "masked",
    "register_updater",
    "scatter_apply",
    "updater_names",
]
