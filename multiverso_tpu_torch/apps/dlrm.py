"""DLRM-style sparse-embedding recommender (docs/embedding.md).

Port of ``multiverso_tpu/apps/dlrm.py``.  Reference lineage:
Multiverso's native habitat is huge sparse embedding tables (PAPER.md
§0 — word embedding, LightLDA); the modern shape of that workload is
recommender serving: one embedding table with O(10^7+) ids,
zipf-skewed id traffic, training via sparse row adds and serving via
cached row reads.

- **the table** — one :class:`~multiverso_tpu_torch.tables.MatrixTable`
  holding user AND item embeddings (items live at ``num_users + item``),
  trained with ``add_rows`` — only touched rows move;
- **training** — dot-product + sigmoid click prediction with binary
  cross-entropy; the per-row gradients come from plain autograd over
  the gathered rows and push back as one batched ``add_rows`` per side;
- **serving** — ``scores`` reads rows through the row-granular serve
  cache (docs/embedding.md);
- **traffic** — :func:`zipf_ids` draws the zipf(s) id stream, the same
  draws as the JAX package's, seed for seed.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import numpy as np
import torch

from ..tables import MatrixTable
from ..updaters import AddOption

__all__ = ["DLRMRecommender", "zipf_ids", "synthetic_clicks"]


def zipf_ids(n: int, k: int, rng, s: float = 1.0) -> np.ndarray:
    """``n`` draws from zipf(``s``) over ``[0, k)`` — ``p(i) ∝ 1/(i+1)^s``.

    The distribution head (ids 0, 1, 2, …) is the planted hot set."""
    p = 1.0 / np.arange(1, k + 1, dtype=np.float64) ** s
    p /= p.sum()
    return rng.choice(k, size=n, p=p).astype(np.int64)


def synthetic_clicks(batch: int, num_users: int, num_items: int,
                     rng, s: float = 1.0
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One zipf-skewed interaction batch: (user ids, item ids, labels).

    Labels follow a planted preference (hot users like hot items) so
    training has signal to descend."""
    users = zipf_ids(batch, num_users, rng, s)
    items = zipf_ids(batch, num_items, rng, s)
    labels = ((users + items) % 3 == 0).astype(np.float32)
    return users, items, labels


def _bce_value_and_grad(u, v, y):
    """Mean binary cross-entropy of the logits ``sum(u * v)`` (the
    numerically stable form) and its gradients w.r.t. ``u`` and ``v``,
    by plain autograd."""
    u, v = (t.detach().requires_grad_() for t in (u, v))
    logits = (u * v).sum(-1)
    loss = (torch.clamp_min(logits, 0) - logits * y
            + torch.log1p(torch.exp(-logits.abs()))).mean()
    du, dv = torch.autograd.grad(loss, (u, v))
    return loss.detach(), (du, dv)


class DLRMRecommender:
    """Dot-product click model over one embedding table.

    ``num_users + num_items`` rows of dimension ``dim``; row
    ``num_users + i`` is item ``i``.
    """

    def __init__(self, num_users: int, num_items: int, dim: int = 16,
                 learning_rate: float = 0.05, name: str = "dlrm",
                 seed: int = 0, serve_cache: Optional[int] = None,
                 max_staleness: Optional[int] = None):
        self.num_users = int(num_users)
        self.num_items = int(num_items)
        self.dim = int(dim)
        self.option = AddOption(learning_rate=learning_rate)
        rng = np.random.RandomState(seed)
        rows = self.num_users + self.num_items
        init = (0.05 * rng.randn(rows, self.dim)).astype(np.float32)
        kw = {}
        if serve_cache is not None:
            kw["serve_cache"] = serve_cache
        if max_staleness is not None:
            kw["max_staleness"] = max_staleness
        self.table = MatrixTable(rows, self.dim, init=init, name=name,
                                 updater_type="sgd",
                                 default_option=self.option, **kw)
        self.device = self.table.device

    # ------------------------------------------------------------- training
    def train_step(self, user_ids, item_ids, labels) -> float:
        """Pull touched rows, one gradient, push sparse updates.

        The reference training-loop shape (§3.4) at row granularity:
        gather → grad → ``add_rows`` — ONE batched add per side, never a
        Python loop over ids."""
        users = np.asarray(user_ids, np.int64)
        items = np.asarray(item_ids, np.int64) + self.num_users
        y = torch.from_numpy(np.asarray(labels, np.float32)).to(self.device)
        u_rows = torch.from_numpy(self.table.get_rows(users)).to(self.device)
        v_rows = torch.from_numpy(self.table.get_rows(items)).to(self.device)
        loss, (du, dv) = _bce_value_and_grad(u_rows, v_rows, y)
        self.table.add_rows(users, du)
        self.table.add_rows(items, dv)
        return float(loss)

    # -------------------------------------------------------------- serving
    def scores(self, user_id: int, item_ids) -> np.ndarray:
        """Serve scores for one user against candidate items — every
        row read rides the row-granular serve cache."""
        items = np.asarray(item_ids, np.int64) + self.num_users
        u = self.table.get_rows(np.asarray([user_id], np.int64))[0]
        v = self.table.get_rows(items)
        return (v @ u).astype(np.float32)

    def hot_report(self) -> dict:
        """The table's workload report (hot ids, skew) — what placement
        feeds on (docs/observability.md)."""
        return self.table.workload_report()

    def train_epoch(self, batches: int, batch: int, seed: int = 0,
                    s: float = 1.0) -> list:
        """Convenience loop for tests/demos: zipf traffic, returns the
        per-batch loss trajectory."""
        rng = np.random.RandomState(seed)
        make = partial(synthetic_clicks, batch, self.num_users,
                       self.num_items, rng, s)
        losses = []
        for _ in range(batches):
            users, items, y = make()
            losses.append(self.train_step(users, items, y))
        return losses

    def close(self) -> None:
        self.table.close()
