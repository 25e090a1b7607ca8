"""Framework integration extensions — the port of ``multiverso_tpu/ext``.

Parity targets (SURVEY.md §2.30–2.33): the reference's Theano
``sharedvar``/Lasagne ``MVNetParamManager`` Python extensions and the
Lua/Torch binding — thin layers that put an existing model's parameters
behind one table and sync them per step.  Here:

- ``shared`` — shared variables and a tree param manager over tensors
  (the counterpart of the JAX package's ``jax_ext``), with
  ``sync_all_mv_shared_vars``;
- ``torch_ext`` — ``TorchParamManager`` for a ``torch.nn.Module`` whose
  parameters, table and deltas stay on the card.
"""

from .shared import MVSharedVariable, SharedParamManager, mv_shared

__all__ = ["mv_shared", "MVSharedVariable", "SharedParamManager"]
