"""Distributed word embedding (skip-gram negative sampling).

Port of ``multiverso_tpu/apps/word2vec.py``.  Reference (SURVEY.md
§2.36, ``Microsoft/distributed_word_embedding`` linking libmultiverso):
embeddings live in (Sparse)MatrixTables row-sharded over servers;
workers pull the rows a batch touches (`Get(rows)`), compute SGNS
gradients locally, and push row deltas (`Add(rows)`), with an
AsyncBuffer overlapping the next pull with compute.

PyTorch: both embedding matrices are ``MatrixTable`` tensors on the
table device.  Two training paths:

- ``train_batch`` — the literal reference loop: ``get_rows``, the SGNS
  gradients, ``add_rows``.
- ``make_fused_step`` — the whole pull→grad→push round trip over the
  tables' own tensors: row gathers, the SGNS gradients, and the
  updaters' in-place row scatter (``scatter_apply``).  It runs eagerly
  (no ``torch.compile``, no CUDA graph) and never waits for the device,
  so consecutive steps queue back to back.  Under several processes the
  caller's batch is the global batch, as in the JAX package: the rows
  reach every rank by one sum of owner-filled buffers per table
  (``MatrixTable.rows_of``), every rank computes the batch's gradients,
  and each applies the rows it owns (``MatrixTable.scatter_rows``).

Both take the SGNS loss and gradients from ``ops.sgns.sgns_grads``: one
CUDA kernel on the card, which writes the output rows' gradients in the
order the output table's row scatter takes them; its closed form in
plain tensor ops on the CPU.  ``_sgns_value_and_grad`` (autograd over
``_sgns_loss``) stays as the reference the tests hold it against.

Negatives are pre-sampled on the host (the reference samples on the
worker too), from the same ``RandomState`` seeds as the JAX package, so
both packages start from identical tables and see identical batches.
"""

from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import tracing
from ..ops.sgns import sgns_grads
from ..tables import MatrixTable
from ..updaters import AddOption
from ..util import AsyncBuffer

__all__ = ["SkipGram", "synthetic_corpus"]


def synthetic_corpus(num_tokens: int, vocab_size: int, seed: int = 0,
                     zipf_a: float = 1.1) -> np.ndarray:
    """Zipf-distributed token stream (text8 stand-in; no dataset egress).
    The same draws as the JAX package's, seed for seed."""
    rng = np.random.RandomState(seed)
    ranks = rng.zipf(zipf_a, size=num_tokens)
    return ((ranks - 1) % vocab_size).astype(np.int32)


def _sgns_loss(vc: torch.Tensor, uo: torch.Tensor,
               un: torch.Tensor) -> torch.Tensor:
    """Skip-gram negative-sampling loss.

    ``vc`` [B,D] center (input) embeddings, ``uo`` [B,D] positive context
    (output) embeddings, ``un`` [B,K,D] negative samples.
    """
    pos = (vc * uo).sum(-1)
    neg = torch.bmm(un, vc[:, :, None])[:, :, 0]
    return -(F.logsigmoid(pos).sum()
             + F.logsigmoid(-neg).sum()) / vc.shape[0]


def _sgns_value_and_grad(vc, uo, un):
    """``(loss, (dvc, duo, dun))`` by plain autograd: the reference the
    tests hold ``ops.sgns.sgns_grads`` against."""
    vc, uo, un = (t.detach().requires_grad_() for t in (vc, uo, un))
    loss = _sgns_loss(vc, uo, un)
    grads = torch.autograd.grad(loss, (vc, uo, un))
    return loss.detach(), grads


def _check_ids(a, vocab_size: int) -> None:
    """Ids of a host batch must index the tables: on the card an id past
    the end is a device-side assert, not an error.  A tensor already on
    the card is not read (that would wait for the device): its ids are
    the caller's to keep in range."""
    if isinstance(a, torch.Tensor):
        if a.device.type != "cpu":
            return
        a = a.numpy()
    a = np.asarray(a)
    if a.size and (a.min() < 0 or a.max() >= vocab_size):
        raise ValueError(
            f"token ids must lie in [0, {vocab_size}); got "
            f"[{a.min()}, {a.max()}]")


class SkipGram:
    """Word2vec SGNS over two MatrixTables."""

    def __init__(self, vocab_size: int, dim: int,
                 learning_rate: float = 0.025,
                 negatives: int = 5,
                 window: int = 5,
                 updater_type: str = "sgd",
                 name: str = "w2v",
                 seed: int = 0):
        self.vocab_size = int(vocab_size)
        self.dim = int(dim)
        self.negatives = int(negatives)
        self.window = int(window)
        self.option = AddOption(learning_rate=learning_rate)
        rng = np.random.RandomState(seed)
        init_in = ((rng.rand(vocab_size, dim) - 0.5) / dim).astype(np.float32)
        self.table_in = MatrixTable(vocab_size, dim, init=init_in,
                                    updater_type=updater_type,
                                    name=f"{name}_in",
                                    default_option=self.option)
        self.table_out = MatrixTable(vocab_size, dim,
                                     updater_type=updater_type,
                                     name=f"{name}_out",
                                     default_option=self.option)
        self.device = self.table_in.device
        self._fused_cache = {}

    # ------------------------------------------------------------- batching
    def batches(self, corpus: np.ndarray, batch_size: int,
                seed: int = 0) -> Iterator[Tuple[np.ndarray, np.ndarray,
                                                 np.ndarray]]:
        """Static-shaped (centers [B], contexts [B], negatives [B,K])."""
        _check_ids(corpus, self.vocab_size)
        rng = np.random.RandomState(seed)
        n = corpus.shape[0]
        centers, contexts = [], []
        for i in range(n):
            w = 1 + rng.randint(self.window)
            for j in range(max(0, i - w), min(n, i + w + 1)):
                if j != i:
                    centers.append(corpus[i])
                    contexts.append(corpus[j])
            while len(centers) >= batch_size:
                c = np.asarray(centers[:batch_size], np.int32)
                o = np.asarray(contexts[:batch_size], np.int32)
                del centers[:batch_size], contexts[:batch_size]
                neg = rng.randint(self.vocab_size,
                                  size=(batch_size, self.negatives)
                                  ).astype(np.int32)
                yield c, o, neg

    # ------------------------------------------------ parity push-pull path
    def _on_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def train_batch(self, centers: np.ndarray, contexts: np.ndarray,
                    negatives: np.ndarray) -> None:
        """Reference loop body: Get(rows) → local grads → Add(rows)."""
        vc = self._on_device(self.table_in.get_rows(centers))
        out_rows = np.concatenate([contexts, negatives.reshape(-1)])
        out_emb = self._on_device(self.table_out.get_rows(out_rows))
        _, dvc, dout = sgns_grads(vc, out_emb, negatives.shape[1])
        self.table_in.add_rows(centers, dvc, option=self.option)
        self.table_out.add_rows(out_rows, dout, option=self.option)

    def train_epoch(self, corpus: np.ndarray, batch_size: int,
                    seed: int = 0, prefetch: bool = True) -> int:
        """Parity epoch with AsyncBuffer overlapping batch prep (§2.24)."""
        it = self.batches(corpus, batch_size, seed=seed)
        steps = 0
        if not prefetch:
            for c, o, neg in it:
                self.train_batch(c, o, neg)
                steps += 1
        else:
            with AsyncBuffer(lambda: next(it, None)) as buf:
                while True:
                    batch = buf.get()
                    if batch is None:
                        break
                    self.train_batch(*batch)
                    steps += 1
        if steps == 0:
            raise ValueError(
                f"corpus of {corpus.shape[0]} tokens produced no full batch "
                f"of {batch_size} pairs (partial batches are dropped for "
                "static shapes)")
        return steps

    # ----------------------------------------------------------- fused path
    def make_fused_step(self, batch_axis: str = "worker"):
        """The whole step over the tables' tensors: gather rows, SGNS
        grads, scatter-apply the updater in place.

        Returns ``step(din, sin, dout, sout, c, o, neg) -> (din, sin,
        dout, sout, loss)`` and a placer for the index arrays (it checks
        host ids against the vocabulary, then moves them to the device as
        int64).  The loss stays a device tensor.  Ids handed over already
        on the card are not checked: one past the vocabulary is a
        device-side assert there, which ends the process's CUDA context.
        """
        cached = self._fused_cache.get(batch_axis)
        if cached is not None:
            return cached
        from ..parallel.sharding import batch_placer

        _, put = batch_placer(self.device, batch_axis, dtype=torch.int64)
        vocab = self.vocab_size

        def place(a):
            _check_ids(a, vocab)
            return put(a)

        t_in, t_out = self.table_in, self.table_out
        opt = self.option

        def step(din, sin, dout, sout, c, o, neg):
            with tracing.span("SkipGram::step"):
                with tracing.span("SkipGram::gather"):
                    vc = t_in.rows_of(din, c)
                    out_rows = torch.cat([o, neg.reshape(-1)])
                    out_emb = t_out.rows_of(dout, out_rows)
                with tracing.span("SkipGram::sgns"):
                    loss, dvc, out_delta = sgns_grads(vc, out_emb,
                                                      neg.shape[1])
                with tracing.span("SkipGram::scatter"):
                    din, sin = t_in.scatter_rows(din, sin, c, dvc, opt)
                    dout, sout = t_out.scatter_rows(dout, sout, out_rows,
                                                    out_delta, opt)
                return din, sin, dout, sout, loss

        self._fused_cache[batch_axis] = (step, place)
        return step, place

    def train_epoch_fused(self, corpus: np.ndarray, batch_size: int,
                          seed: int = 0) -> Tuple[int, float]:
        from ..util import prefetch_to_device

        step, place = self.make_fused_step()
        din, sin = self.table_in.raw_value()
        dout, sout = self.table_out.raw_value()
        loss = torch.zeros(())
        steps = 0
        # Index batches go to the device up to two steps ahead of the
        # step (pinned staging, a side stream); the placer then only
        # casts them there.  ``batches`` checked the corpus's ids.
        for c, o, neg in prefetch_to_device(
                self.batches(corpus, batch_size, seed=seed), size=2,
                sharding=self.device):
            din, sin, dout, sout, loss = step(
                din, sin, dout, sout, place(c), place(o), place(neg))
            steps += 1
        if steps == 0:
            raise ValueError(
                f"corpus of {corpus.shape[0]} tokens produced no full batch "
                f"of {batch_size} pairs (partial batches are dropped for "
                "static shapes)")
        self.table_in.raw_assign(din, sin)
        self.table_out.raw_assign(dout, sout)
        return steps, float(loss)

    # ------------------------------------------------------------- analysis
    def most_similar(self, token: int, topk: int = 5) -> np.ndarray:
        emb = self.table_in.get()
        v = emb[token] / (np.linalg.norm(emb[token]) + 1e-8)
        norms = emb / (np.linalg.norm(emb, axis=1, keepdims=True) + 1e-8)
        sims = norms @ v
        sims[token] = -np.inf
        return np.argsort(-sims)[:topk]
