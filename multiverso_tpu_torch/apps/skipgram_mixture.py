"""Distributed multi-sense word embedding (skip-gram mixture).

Port of ``multiverso_tpu/apps/skipgram_mixture.py``.  Reference
(SURVEY.md §2.36, ``Microsoft/distributed_skipgram_mixture`` linking
libmultiverso): each word owns S sense vectors plus a sense-prior
vector, all parameter-server-resident; workers pull the rows a batch
touches, run an EM step — E: posterior responsibility of each sense
given the occurrence's WHOLE context window; M: responsibility-weighted
SGNS gradients and prior counts — and push row deltas back.

PyTorch: three ``MatrixTable`` tensors on the table device —

- ``table_sense`` [V·S, D]: sense (input) vectors, word w's senses in
  rows ``w·S … w·S+S-1``;
- ``table_out`` [V, D]: context (output) vectors, single-sense;
- ``table_prior`` [V, S]: responsibility counts under the plain-add
  updater (counts accumulate, they are not gradients).

Batches are whole occurrences: center [B], context bag [B, C] + validity
mask (C = 2·window, padded with the id ``vocab_size``), negatives [B, K].
``train_batch`` is the reference loop (``get_rows``, EM step, ``add_rows``);
the fused step runs the same round trip over the tables' own tensors with
the updaters' in-place row scatters and never waits for the device.  The
E-step runs in float32 without gradients (exactly EM); the M-step's
gradients come from plain autograd.

The padding id ``vocab_size`` lies past ``table_out``.  The fused step
clamps it for the gather only (its slot is masked, so its gradient is
exactly zero) and hands it unclamped to the scatters, which drop it: a
clamped scatter would hand row V-1 a zero delta that a stateful updater
(momentum) still applies.  Batches, corpora and seeds are the JAX
package's, so both packages train the same tables from the same start.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..tables import MatrixTable
from ..updaters import AddOption
from .word2vec import _check_ids

__all__ = ["SkipGramMixture", "synthetic_homonym_corpus"]


def synthetic_homonym_corpus(num_tokens: int, vocab_size: int,
                             homonym: int = 0, groups=((1, 10), (11, 20)),
                             seed: int = 0) -> np.ndarray:
    """Token stream where ``homonym`` appears in two disjoint context
    worlds (group-A neighbours vs group-B neighbours) — the canonical
    two-sense test corpus.  Other tokens are drawn uniformly inside their
    own group, so each has one sense.  The same draws as the JAX
    package's, seed for seed."""

    hi_max = max(hi for _, hi in groups)
    if hi_max >= vocab_size:
        raise ValueError(
            f"group token {hi_max} >= vocab_size {vocab_size}; wrapping "
            "would alias group tokens onto other ids (even the homonym)")
    rng = np.random.RandomState(seed)
    out = np.empty(num_tokens, np.int64)
    i = 0
    while i < num_tokens:
        lo, hi = groups[rng.randint(len(groups))]
        run = min(rng.randint(4, 9), num_tokens - i)
        seg = rng.randint(lo, hi + 1, size=run)
        seg[rng.randint(run)] = homonym       # plant the homonym mid-run
        out[i:i + run] = seg
        i += run
    return out.astype(np.int32)


def _loglik(vs, uc, un, mask):
    """Per-sense log-likelihood [B,S] in float32 of ``vs`` [B,S,D] sense
    vectors against the context bag ``uc`` [B,C,D] (``mask`` [B,C]
    marks its valid slots) and the negatives ``un`` [B,K,D]."""
    pos = torch.bmm(vs, uc.transpose(1, 2)).float()       # [B, S, C]
    neg = torch.bmm(vs, un.transpose(1, 2)).float()       # [B, S, K]
    return ((F.logsigmoid(pos) * mask.float()[:, None, :]).sum(-1)
            + F.logsigmoid(-neg).sum(-1))


def _mixture_stats(vs, uc, un, mask, log_prior):
    """E-step over a context bag: (resp [B,S] f32 detached, loglik [B,S]
    f32).  Float32 throughout — posterior odds underflow in bf16."""
    loglik = _loglik(vs, uc, un, mask)
    resp = torch.softmax(loglik + log_prior, -1)
    return resp.detach(), loglik


def _weighted_sgns_loss(vs, uc, un, mask, resp):
    """M-step objective: responsibility-weighted SGNS loss (mean/batch)."""
    return -(resp * _loglik(vs, uc, un, mask)).sum() / vs.shape[0]


def _em_step(vs, uc, un, mask, prior):
    """The E-step without gradients, then the M-step's loss and its
    gradients: ``(resp, loss, (dvs, duc, dun))``."""
    with torch.no_grad():
        log_prior = torch.log(prior / prior.sum(-1, keepdim=True))
        resp, _ = _mixture_stats(vs, uc, un, mask, log_prior)
    vs, uc, un = (t.detach().requires_grad_() for t in (vs, uc, un))
    loss = _weighted_sgns_loss(vs, uc, un, mask, resp)
    return resp, loss.detach(), torch.autograd.grad(loss, (vs, uc, un))


class SkipGramMixture:
    """Multi-sense word2vec over sense/context/prior MatrixTables."""

    def __init__(self, vocab_size: int, dim: int, senses: int = 2,
                 learning_rate: float = 0.05,
                 negatives: int = 5,
                 window: int = 5,
                 updater_type: str = "sgd",
                 name: str = "sgmix",
                 seed: int = 0):
        self.vocab_size = int(vocab_size)
        self.dim = int(dim)
        self.senses = int(senses)
        self.negatives = int(negatives)
        self.window = int(window)
        self.option = AddOption(learning_rate=learning_rate)
        rng = np.random.RandomState(seed)
        # Senses must start apart — identical init keeps responsibilities
        # symmetric forever (EM's classic degenerate fixed point).
        init_sense = (rng.randn(vocab_size * senses, dim)
                      / np.sqrt(dim)).astype(np.float32)
        self.table_sense = MatrixTable(vocab_size * senses, dim,
                                       init=init_sense,
                                       updater_type=updater_type,
                                       name=f"{name}_sense",
                                       default_option=self.option)
        # Output vectors start random too (zero scores → uniform
        # posteriors → identical sense gradients, forever).
        init_out = (rng.randn(vocab_size, dim)
                    / np.sqrt(dim)).astype(np.float32)
        self.table_out = MatrixTable(vocab_size, dim, init=init_out,
                                     updater_type=updater_type,
                                     name=f"{name}_out",
                                     default_option=self.option)
        # Dirichlet(1) prior counts; plain add (counts, not gradients).
        self.table_prior = MatrixTable(vocab_size, senses,
                                       init=np.ones((vocab_size, senses),
                                                    np.float32),
                                       updater_type="default",
                                       name=f"{name}_prior")
        self.device = self.table_sense.device
        self._fused_cache = {}

    # ------------------------------------------------------------- batching
    @property
    def bag_width(self) -> int:
        return 2 * self.window

    def batches(self, corpus: np.ndarray, batch_size: int, seed: int = 0):
        """Whole-occurrence examples, static shapes: center [B], context
        bag [B, C] (C = 2·window), mask [B, C], negatives [B, K].

        Padding slots carry ``vocab_size`` — past the table's rows, so
        their (zero-masked) scatter is dropped instead of touching word
        0's state under a non-linear updater."""
        _check_ids(corpus, self.vocab_size)
        rng = np.random.RandomState(seed)
        n = corpus.shape[0]
        C = self.bag_width
        cs, bags, masks = [], [], []
        for i in range(n):
            w = 1 + rng.randint(self.window)
            ctx = np.concatenate([corpus[max(0, i - w):i],
                                  corpus[i + 1:min(n, i + w + 1)]])
            bag = np.full(C, self.vocab_size, np.int32)
            m = np.zeros(C, bool)
            bag[:ctx.shape[0]] = ctx
            m[:ctx.shape[0]] = True
            cs.append(corpus[i]); bags.append(bag); masks.append(m)
            if len(cs) == batch_size:
                neg = rng.randint(self.vocab_size,
                                  size=(batch_size, self.negatives)
                                  ).astype(np.int32)
                yield (np.asarray(cs, np.int32), np.stack(bags),
                       np.stack(masks), neg)
                cs, bags, masks = [], [], []

    def _sense_rows(self, centers: np.ndarray) -> np.ndarray:
        """[B] word ids → [B·S] sense-row ids (w·S + s)."""
        return (centers.astype(np.int64)[:, None] * self.senses
                + np.arange(self.senses)).reshape(-1)

    # ------------------------------------------------ parity push-pull path
    def _on_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.asarray(a)).to(self.device)

    def train_batch(self, centers: np.ndarray, bags: np.ndarray,
                    mask: np.ndarray, negatives: np.ndarray) -> None:
        """Reference loop body: Get rows → EM step → Add row deltas."""
        B, K = negatives.shape
        C = bags.shape[1]
        S, D = self.senses, self.dim
        sense_rows = self._sense_rows(centers)
        vs = self._on_device(self.table_sense.get_rows(sense_rows)
                             ).reshape(B, S, D)
        out_rows = np.concatenate([bags.reshape(-1), negatives.reshape(-1)])
        out_emb = self._on_device(self.table_out.get_rows(out_rows))
        uc = out_emb[:B * C].reshape(B, C, D)
        un = out_emb[B * C:].reshape(B, K, D)
        prior = self._on_device(self.table_prior.get_rows(centers))
        resp, _, (dvs, duc, dun) = _em_step(
            vs, uc, un, self._on_device(np.asarray(mask, bool)), prior)
        self.table_sense.add_rows(sense_rows, dvs.reshape(B * S, D),
                                  option=self.option)
        self.table_out.add_rows(
            out_rows, torch.cat([duc.reshape(B * C, D),
                                 dun.reshape(B * K, D)]),
            option=self.option)
        self.table_prior.add_rows(centers, resp)

    # ----------------------------------------------------------- fused path
    def make_fused_step(self, batch_axis: str = "worker"):
        """The whole EM step over the tables' tensors: row gathers, the
        E-step, weighted grads, in-place scatter-apply.

        Returns ``step(ds, ss, do, so, dp, sp_, c, bags, mask, neg) ->
        (ds, ss, do, so, dp, sp_, loss)`` over the (sense, out, prior)
        tables' tensors, and a placer for the index arrays: it checks
        host ids against ``[0, vocab_size]`` (the padding id included)
        and moves them to the device as int64.  ``mask`` is a bool
        tensor on the device.  The loss stays a device tensor."""
        cached = self._fused_cache.get(batch_axis)
        if cached is not None:
            return cached
        from ..parallel.sharding import batch_placer

        _, put = batch_placer(self.device, batch_axis, dtype=torch.int64)
        V = self.vocab_size

        def place(a):
            _check_ids(a, V + 1)
            return put(a)

        t_sense, t_out = self.table_sense, self.table_out
        t_prior = self.table_prior
        opt = self.option
        opt_prior = self.table_prior.default_option
        S, D = self.senses, self.dim
        sense_offsets = torch.arange(S, device=self.device)

        def step(ds, ss, do, so, dp, sp_, c, bags, mask, neg):
            B, K = neg.shape
            C = bags.shape[1]
            sense_rows = (c[:, None] * S + sense_offsets).reshape(-1)
            vs = t_sense.rows_of(ds, sense_rows).reshape(B, S, D)
            # The padding id V is clamped for the gather only: its slot
            # is masked, so its gradient is exactly zero.
            out_emb = t_out.rows_of(do, torch.cat(
                [bags.reshape(-1).clamp(max=V - 1), neg.reshape(-1)]))
            uc = out_emb[:B * C].reshape(B, C, D)
            un = out_emb[B * C:].reshape(B, K, D)
            resp, loss, (dvs, duc, dun) = _em_step(
                vs, uc, un, mask, t_prior.rows_of(dp, c))
            ds, ss = t_sense.scatter_rows(ds, ss, sense_rows,
                                          dvs.reshape(B * S, D), opt)
            out_rows = torch.cat([bags.reshape(-1), neg.reshape(-1)])
            out_delta = torch.cat([duc.reshape(B * C, D),
                                   dun.reshape(B * K, D)])
            do, so = t_out.scatter_rows(do, so, out_rows, out_delta, opt)
            dp, sp_ = t_prior.scatter_rows(dp, sp_, c, resp, opt_prior)
            return ds, ss, do, so, dp, sp_, loss

        self._fused_cache[batch_axis] = (step, place)
        return step, place

    def train_epoch_fused(self, corpus: np.ndarray, batch_size: int,
                          seed: int = 0) -> Tuple[int, float]:
        from ..util import prefetch_to_device

        step, place = self.make_fused_step()
        ds, ss = self.table_sense.raw_value()
        do, so = self.table_out.raw_value()
        dp, sp_ = self.table_prior.raw_value()
        loss = torch.zeros(())
        steps = 0
        # Batches reach the device up to two steps ahead (pinned staging,
        # a side stream); ``batches`` checked the corpus's ids.
        for c, bags, mask, neg in prefetch_to_device(
                self.batches(corpus, batch_size, seed=seed), size=2,
                sharding=self.device):
            ds, ss, do, so, dp, sp_, loss = step(
                ds, ss, do, so, dp, sp_, place(c), place(bags), mask,
                place(neg))
            steps += 1
        if steps == 0:
            raise ValueError(
                f"corpus of {corpus.shape[0]} tokens produced no full "
                f"batch of {batch_size} occurrences")
        self.table_sense.raw_assign(ds, ss)
        self.table_out.raw_assign(do, so)
        self.table_prior.raw_assign(dp, sp_)
        return steps, float(loss)

    # ------------------------------------------------------------- analysis
    def sense_priors(self, word: int) -> np.ndarray:
        """Normalized sense probabilities for ``word``."""
        counts = self.table_prior.get_rows(np.asarray([word]))[0]
        return counts / counts.sum()

    def sense_posterior(self, word: int, context: np.ndarray) -> np.ndarray:
        """P(sense | word, bag-of-context) — the E-step for one example."""
        context = np.asarray(context, np.int64)
        vs = self.table_sense.get_rows(self._sense_rows(
            np.asarray([word])))                       # [S, D]
        uc = self.table_out.get_rows(context)          # [C, D]
        nll = np.log1p(np.exp(-(vs @ uc.T))).sum(axis=1)  # -Σ log σ(s·c)
        logp = np.log(self.sense_priors(word) + 1e-12) - nll
        logp -= logp.max()
        p = np.exp(logp)
        return p / p.sum()

    def sense_vector(self, word: int, sense: int) -> np.ndarray:
        return self.table_sense.get_rows(
            np.asarray([word * self.senses + sense]))[0]
