"""Distributed logistic regression — the north-star parity app.

Port of ``multiverso_tpu/apps/logistic_regression.py``.  Reference
(SURVEY.md §2.32, §3.4,
``binding/python/examples/theano/logistic_regression.py``): an LR model
whose parameters live in an ArrayTable; each worker trains on its data
shard and syncs via ``add(delta)`` / ``get()`` per batch.

PyTorch: the model is plain tensor math on the table's device.  Two
training paths:

- ``train_batch`` — the literal reference loop: pull, local grad, push.
  Useful for API parity and as the semantics oracle.
- ``make_fused_step`` — one step over the table's own tensors: loss and
  gradient, then the updater applies on the device, with no host hop
  and no host sync.  It runs eagerly (no ``torch.compile``, no CUDA
  graph).  Under several processes, as in the JAX package, the caller's
  batch is the global batch (every rank passes the same one): each rank
  gathers the table's blocks, computes the step's gradient, and applies
  its own block of it, so the blocks equal one process's table.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import numpy as np
import torch

from ..tables import ArrayTable
from ..updaters import AddOption

__all__ = ["LogisticRegression", "synthetic_classification"]


def synthetic_classification(num_samples: int, num_features: int,
                             num_classes: int, seed: int = 0,
                             noise: float = 0.1
                             ) -> Tuple[np.ndarray, np.ndarray]:
    """Linearly-separable-ish synthetic data: an MNIST-shaped stand-in for
    tests and benchmarks that needs no dataset download.  The same draws
    as the JAX package's, seed for seed."""
    rng = np.random.RandomState(seed)
    true_w = rng.randn(num_features, num_classes).astype(np.float32)
    x = rng.randn(num_samples, num_features).astype(np.float32)
    logits = x @ true_w + noise * rng.randn(num_samples, num_classes)
    y = logits.argmax(axis=1).astype(np.int32)
    return x, y


def _loss_fn(w_flat: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
             num_features: int, num_classes: int) -> torch.Tensor:
    """Softmax cross-entropy; parameters packed flat [(F+1)*C] (W then b)."""
    W = w_flat[: num_features * num_classes].reshape(num_features,
                                                     num_classes)
    b = w_flat[num_features * num_classes:
               (num_features + 1) * num_classes]
    logits = x @ W + b
    logz = torch.logsumexp(logits, dim=-1)
    ll = logits.gather(-1, y.long()[:, None])[:, 0]
    return (logz - ll).mean()


def _value_and_grad(loss_fn):
    """``(w, x, y) -> (loss, dloss/dw)`` by plain autograd — the JAX
    package's ``jax.value_and_grad``.  ``torch.func.grad_and_value``
    computes the same through a heavier host dispatch, which the fused
    step, bound by its launches, would pay on every step."""
    def value_and_grad(w, x, y):
        w = w.detach().requires_grad_()
        loss = loss_fn(w, x, y)
        (grad,) = torch.autograd.grad(loss, w)
        return loss.detach(), grad

    return value_and_grad


class LogisticRegression:
    """ArrayTable-backed multinomial logistic regression."""

    def __init__(self, num_features: int, num_classes: int,
                 learning_rate: float = 0.1,
                 updater_type: str = "sgd",
                 name: str = "lr",
                 seed: int = 0):
        self.num_features = int(num_features)
        self.num_classes = int(num_classes)
        self.param_size = (self.num_features + 1) * self.num_classes
        self.option = AddOption(learning_rate=learning_rate)
        rng = np.random.RandomState(seed)
        init = (0.01 * rng.randn(self.param_size)).astype(np.float32)
        init[self.num_features * self.num_classes:] = 0.0  # zero bias
        self.table = ArrayTable(self.param_size, init=init,
                                updater_type=updater_type, name=name,
                                default_option=self.option)
        self.device = self.table.device
        self._loss = partial(_loss_fn, num_features=self.num_features,
                             num_classes=self.num_classes)
        self._grad_fn = _value_and_grad(self._loss)
        self._fused_cache = {}

    def _on_device(self, a) -> torch.Tensor:
        return torch.as_tensor(a).to(self.device)

    # ------------------------------------------------ parity push-pull path
    def train_batch(self, x: np.ndarray, y: np.ndarray) -> float:
        """Reference loop body (§3.4): get → local grad → add(grad)."""
        w = self._on_device(self.table.get())
        loss, grad = self._grad_fn(w, self._on_device(x), self._on_device(y))
        self.table.add(grad.cpu().numpy(), option=self.option)
        return float(loss)

    def evaluate(self, x: np.ndarray, y: np.ndarray) -> Tuple[float, float]:
        w = self._on_device(self.table.get())
        xd = self._on_device(x)
        loss = float(self._loss(w, xd, self._on_device(y)))
        W = w[: self.num_features * self.num_classes].reshape(
            self.num_features, self.num_classes)
        b = w[self.num_features * self.num_classes:]
        acc = float(((xd @ W + b).argmax(dim=1).cpu().numpy()
                     == y).mean())
        return loss, acc

    # ----------------------------------------------------------- fused path
    def make_fused_step(self, batch_axis: str = "worker"):
        """Build the whole step over the table's tensors.

        Returns ``step(data, state, x, y) -> (data, state, loss)`` plus
        the closure that places inputs on the table's device.  The caller
        drives:

            step, place = lr.make_fused_step()
            data, state = lr.table.raw_value()
            data, state, loss = step(data, state, place(x), place(y))
            lr.table.raw_assign(data, state)

        The loss stays a device tensor: nothing in the step waits for
        the device, so consecutive steps queue back to back.  Sharded,
        ``data``/``state`` are this rank's blocks and the step gathers
        the blocks (one collective): every rank computes the whole
        batch's gradient, so no gradient crosses ranks.
        """
        cached = self._fused_cache.get(batch_axis)
        if cached is not None:
            return cached
        from ..parallel.sharding import batch_placer
        _, place = batch_placer(self.device, batch_axis)
        table = self.table
        updater = table.updater
        grad_fn = self._grad_fn
        opt = self.option
        n = self.param_size

        def step(data, state, x, y):
            loss, grad = grad_fn(table.full_value(data)[:n], x, y)
            data, state = updater.apply_dense(data, state,
                                              table.local_part(grad), opt)
            return data, state, loss

        self._fused_cache[batch_axis] = (step, place)
        return step, place

    def train_epoch_fused(self, x: np.ndarray, y: np.ndarray,
                          batch_size: int) -> float:
        """Drive the fused step over an epoch; returns the last batch loss."""
        step, place = self.make_fused_step()
        data, state = self.table.raw_value()
        n = (x.shape[0] // batch_size) * batch_size
        if n == 0:
            raise ValueError(
                f"no full batch: {x.shape[0]} samples < batch_size "
                f"{batch_size} (tail samples are dropped, as in the JAX "
                f"package's static shapes)")
        loss = torch.zeros(())
        for i in range(0, n, batch_size):
            xb = place(x[i:i + batch_size])
            yb = place(y[i:i + batch_size])
            data, state, loss = step(data, state, xb, yb)
        self.table.raw_assign(data, state)
        return float(loss)
