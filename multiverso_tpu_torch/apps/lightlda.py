"""LightLDA-style distributed topic model (collapsed Gibbs LDA).

Port of ``multiverso_tpu/apps/lightlda.py``.  Reference (SURVEY.md
§2.36, ``Microsoft/LightLDA`` linking libmultiverso): the word-topic
count matrix lives in a SparseMatrixTable (V x K) and the topic totals in
an ArrayTable (K); workers sweep their document shard, resample token
topics, and push count *deltas* with async ``Add`` (plain add updater) —
the AD-LDA scheme where workers sample against slightly stale counts and
reconcile through the server.

PyTorch: the same AD-LDA math on the tables' device, three sweeps:

- ``sample_pass`` — parity path: pull touched word rows + topic totals,
  resample on the host (numpy, ``RandomState``), push sparse count
  deltas.  The JAX package's draws, seed for seed.
- ``make_fused_pass`` — one blocked-Gibbs sweep over a doc batch: every
  token resamples in parallel against start-of-sweep counts from its
  [docs, len, K] collapsed posterior, by the Gumbel-max trick
  (``argmax(logits + gumbel)``, which is what ``jax.random.categorical``
  computes).  O(K) work and memory per token — for K up to a few hundred.
- ``make_mh_pass`` — the LightLDA sampler (WWW'15): factorized cycle
  proposals + Metropolis-Hastings, word proposals by an inverse-CDF
  binary search over a [V, K] ``cumsum``, doc proposals by the token
  trick, per-token cost independent of K.  Count deltas are flat
  ``index_add_`` scatters; the dense [V, K] word-topic delta goes through
  the table's device add, with no host round trip.

PyTorch cannot reproduce ``jax.random``, so each device sweep takes its
random draws as tensors: Gumbel noise [D, L, K] for the fused sweep, and
per MH step the proposal uniforms, the doc-proposal token uniforms, the
uniform topics and the acceptance uniforms.  ``LightLDA`` makes them from
its own ``torch.Generator`` on the tables' device, seeded by ``seed``,
where the JAX package splits its key once per sweep; a caller (the
tests, the chip check) may hand them in instead.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..tables import ArrayTable, SparseMatrixTable
from ..tables.base import host_fetch, host_put, is_multiprocess

__all__ = ["LightLDA", "MHDraws", "synthetic_documents"]

PAD = -1  # padding token id in [docs, max_len] matrices


def _one_process() -> None:
    """The device sweeps' guard: the JAX package's sweeps fetch the
    sharded global arrays to the host, which raises across processes
    (``tests/test_torch_lightlda_processes.py`` runs them under two), so
    the port runs them in one process only (``sample_pass`` and the
    eager table ops run under several)."""
    if is_multiprocess():
        raise NotImplementedError(
            "LightLDA's device sweeps (make_fused_pass, make_mh_pass) run "
            "in one process, as the JAX package's do; under several "
            "processes use sample_pass (ROADMAP.md Queue 1, \"Several "
            "processes\")")


def synthetic_documents(num_docs: int, vocab_size: int, num_topics: int,
                        doc_len: int = 64, seed: int = 0,
                        concentration: float = 0.1
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Documents with planted topic structure; returns (docs, true_topics).

    Each topic owns a contiguous slice of the vocabulary; each doc mixes
    1-2 topics.  ``docs`` is int32 [num_docs, doc_len] (PAD-free here).
    The same draws as the JAX package's, seed for seed.
    """
    rng = np.random.RandomState(seed)
    words_per_topic = vocab_size // num_topics
    docs = np.zeros((num_docs, doc_len), np.int32)
    true_topics = rng.randint(num_topics, size=num_docs)
    for d in range(num_docs):
        k = true_topics[d]
        own = rng.rand(doc_len) > concentration
        topic_words = (k * words_per_topic
                       + rng.randint(words_per_topic, size=doc_len))
        noise_words = rng.randint(vocab_size, size=doc_len)
        docs[d] = np.where(own, topic_words, noise_words)
    return docs, true_topics


class MHDraws(NamedTuple):
    """The random draws of one MH sweep, each [mh_steps, D, L]: step
    ``i`` reads row ``i``.  Word steps (even ``i``) read ``u_prop`` (the
    inverse-CDF uniform) and ``u_acc``; doc steps read ``u_prop`` (token
    or uniform topic), ``u_tok`` (which token), ``t_unif`` (int64 topics
    in ``[0, K)``) and ``u_acc``.  Uniforms lie in [0, 1)."""

    u_prop: torch.Tensor
    u_tok: torch.Tensor
    t_unif: torch.Tensor
    u_acc: torch.Tensor


def gumbel_noise(u: torch.Tensor) -> torch.Tensor:
    """Standard Gumbel noise from uniforms in [0, 1): ``-log(-log(u))``
    with ``u`` kept inside (0, 1)."""
    return -torch.log(-torch.log(u.clamp(min=torch.finfo(u.dtype).tiny)))


def _host(a) -> np.ndarray:
    """A doc-topic matrix as the caller's own host array."""
    if isinstance(a, torch.Tensor):
        return host_fetch(a)
    return np.array(a)


class LightLDA:
    """AD-LDA over a SparseMatrixTable (word-topic) + ArrayTable (totals)."""

    def __init__(self, vocab_size: int, num_topics: int,
                 alpha: float = 0.1, beta: float = 0.01,
                 name: str = "lda",
                 seed: int = 0):
        self.V = int(vocab_size)
        self.K = int(num_topics)
        self.alpha = float(alpha)
        self.beta = float(beta)
        # Plain-add updater and ASP pinned regardless of runtime defaults:
        # LDA pushes count deltas (not gradients) and the AD-LDA scheme
        # requires async Adds visible to the next sweep.
        self.word_topic = SparseMatrixTable(self.V, self.K,
                                            updater_type="default",
                                            sync=False,
                                            name=f"{name}_word_topic")
        self.topic_sum = ArrayTable(self.K, updater_type="default",
                                    sync=False,
                                    name=f"{name}_topic_sum")
        self.device = self.word_topic.device
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self._fused_cache = {}

    # ------------------------------------------------------------ init pass
    def initialize_counts(self, docs: np.ndarray,
                          seed: int = 0) -> np.ndarray:
        """Random topic init; returns doc-topic counts [D, K] (worker-local
        state in the reference) and pushes global counts."""
        rng = np.random.RandomState(seed)
        D, L = docs.shape
        z = rng.randint(self.K, size=(D, L)).astype(np.int32)
        z[docs == PAD] = -1
        doc_topic = np.zeros((D, self.K), np.float32)
        wt_delta = np.zeros((self.V, self.K), np.float32)
        ts_delta = np.zeros(self.K, np.float32)
        valid = docs != PAD
        for d in range(D):
            for i in np.nonzero(valid[d])[0]:
                k = z[d, i]
                doc_topic[d, k] += 1
                wt_delta[docs[d, i], k] += 1
                ts_delta[k] += 1
        touched = np.unique(docs[valid])
        self.word_topic.add_rows(touched, wt_delta[touched])
        self.topic_sum.add(ts_delta)
        self._z = z
        return doc_topic

    # ------------------------------------------------ parity push-pull path
    def sample_pass(self, docs: np.ndarray, doc_topic,
                    seed: int = 0) -> np.ndarray:
        """One AD-LDA sweep via eager Get/Add (the reference worker loop)."""
        rng = np.random.RandomState(seed)
        # The device sweeps hand back a tensor on the card; this host loop
        # mutates its own copy.
        doc_topic = _host(doc_topic)
        D, L = docs.shape
        valid = docs != PAD
        touched = np.unique(docs[valid])
        wt = self.word_topic.get_rows(touched).astype(np.float64)
        row_of = {int(w): i for i, w in enumerate(touched)}
        ts = self.topic_sum.get().astype(np.float64)
        wt_delta = np.zeros_like(wt)
        ts_delta = np.zeros(self.K, np.float64)
        z = self._z
        for d in range(D):
            for i in np.nonzero(valid[d])[0]:
                w, old = int(docs[d, i]), int(z[d, i])
                r = row_of[w]
                # decrement
                doc_topic[d, old] -= 1
                wt[r, old] -= 1
                ts[old] -= 1
                wt_delta[r, old] -= 1
                ts_delta[old] -= 1
                # collapsed posterior
                p = ((wt[r] + self.beta) * (doc_topic[d] + self.alpha)
                     / (ts + self.V * self.beta))
                p = np.maximum(p, 0)
                new = rng.choice(self.K, p=p / p.sum())
                # increment
                z[d, i] = new
                doc_topic[d, new] += 1
                wt[r, new] += 1
                ts[new] += 1
                wt_delta[r, new] += 1
                ts_delta[new] += 1
        self.word_topic.add_rows(touched, wt_delta.astype(np.float32))
        self.topic_sum.add(ts_delta.astype(np.float32))
        return doc_topic

    # -------------------------------------------------------- the draws
    def fused_draws(self, shape) -> torch.Tensor:
        """Gumbel noise of ``shape`` ([D, L, K]) from the model's
        generator, on the tables' device."""
        return gumbel_noise(torch.rand(shape, generator=self._gen,
                                       device=self.device))

    def mh_draws(self, shape, mh_steps: int) -> MHDraws:
        """One MH sweep's draws (``MHDraws``) for docs of ``shape``
        ([D, L]) from the model's generator, on the tables' device."""
        u = torch.rand((3, mh_steps) + tuple(shape), generator=self._gen,
                       device=self.device)
        t = torch.randint(0, self.K, (mh_steps,) + tuple(shape),
                          generator=self._gen, device=self.device)
        return MHDraws(u[0], u[1], t, u[2])

    # ------------------------------------------------- blocked Gibbs sweep
    def make_fused_pass(self, max_len: int, batch_axis: str = "worker"):
        """One blocked-Gibbs sweep over a doc batch.

        All tokens resample in parallel against start-of-sweep counts
        (AD-LDA staleness, the same approximation the reference's async
        Add makes across workers).  Returns ``pass_fn(wt, ts, docs, z,
        doc_topic, gumbel) -> (z', doc_topic', topic_sum_delta)`` —
        ``gumbel`` is [D, L, K] standard Gumbel noise — wired through
        ``run_fused_pass`` (which rebuilds the sparse word-topic deltas on
        the host from ``z``/``z'``), and the batch placer.  One process
        only (see ``_one_process``).
        """
        _one_process()
        cache_key = ("fused", max_len, batch_axis)
        cached = self._fused_cache.get(cache_key)
        if cached is not None:
            return cached
        from ..parallel.sharding import batch_placer

        _, place = batch_placer(self.device, batch_axis)
        V, K, alpha, beta = self.V, self.K, self.alpha, self.beta

        def pass_fn(wt, ts, docs, z, doc_topic, gumbel):
            valid = docs != PAD
            w_safe = torch.where(valid, docs, 0)
            # remove each token's own count (collapsed Gibbs "minus self")
            vmask = valid[..., None].to(wt.dtype)
            own = F.one_hot(z.clamp(min=0), K).to(wt.dtype) * vmask
            wt_tok = wt[w_safe] - own                       # [D, L, K]
            dt_tok = doc_topic[:, None, :] - own            # [D, L, K]
            ts_tok = ts[None, None, :] - own                # [D, L, K]
            logits = (torch.log(torch.clamp(wt_tok + beta, min=1e-30))
                      + torch.log(torch.clamp(dt_tok + alpha, min=1e-30))
                      - torch.log(torch.clamp(ts_tok + V * beta,
                                              min=1e-30)))
            new_z = torch.argmax(gumbel + logits, dim=-1)
            new_z = torch.where(valid, new_z, PAD)
            # deltas: -old +new per token; only the [D, K]/[K] reductions
            # leave the sweep.
            new_oh = F.one_hot(new_z.clamp(min=0), K).to(wt.dtype) * vmask
            delta = new_oh - own
            return new_z, doc_topic + delta.sum(1), delta.sum((0, 1))

        self._fused_cache[cache_key] = (pass_fn, place)
        return pass_fn, place

    # ---------------------------------------------- LightLDA MH sweep
    def make_mh_pass(self, max_len: int, mh_steps: int = 4,
                     batch_axis: str = "worker"):
        """One LightLDA Metropolis-Hastings sweep.

        Reference: the WWW'15 LightLDA sampler (``Microsoft/LightLDA``,
        SURVEY.md §2.36/§6) — alternating word/doc cycle proposals with
        O(1) acceptance.  Per-token cost is O(mh_steps · log K) element
        gathers + O(1) scatters; nothing materializes a K-sized axis per
        token.

        Same blocked/AD-LDA staleness as ``make_fused_pass``: every token
        proposes and accepts against sweep-start counts (minus its own
        sweep-start assignment), and the word-proposal CDF is built once
        per sweep from those counts, with the MH ratio using that same
        stale density (so the chain targets the exact sweep-start
        posterior).  Returns ``pass_fn(wt, ts, docs, z, doc_topic, draws)
        -> (z', doc_topic', topic_sum_delta, word_topic_delta)`` with
        ``draws`` an ``MHDraws``, and the batch placer.  One process only
        (see ``_one_process``).
        """
        _one_process()
        cache_key = ("mh", max_len, mh_steps, batch_axis)
        cached = self._fused_cache.get(cache_key)
        if cached is not None:
            return cached
        from ..parallel.sharding import batch_placer

        _, place = batch_placer(self.device, batch_axis)
        V, K, alpha, beta = self.V, self.K, self.alpha, self.beta
        n_bits = max(1, (K - 1).bit_length())

        def pass_fn(wt, ts, docs, z, doc_topic, draws: MHDraws):
            D = docs.shape[0]
            valid = docs != PAD
            w = torch.where(valid, docs, 0)
            z0 = torch.where(valid, z, 0)
            d_idx = torch.arange(D, device=docs.device)[:, None].expand(
                docs.shape)
            vf = valid.to(wt.dtype)

            # Sweep-start word-proposal density + CDF (the "alias tables").
            qw = (wt + beta) / (ts + V * beta)[None, :]         # [V, K]
            cdf = torch.cumsum(qw, dim=-1)                       # [V, K]
            total = cdf[w, K - 1]                                # [D, L]

            # Minus-self π terms: subtract the token's own sweep-start
            # assignment from every count it reads.
            def pi_num(t):
                self_c = ((t == z0) & valid).to(wt.dtype)
                n_tw = wt[w, t] - self_c
                n_td = doc_topic[d_idx, t] - self_c
                n_t = ts[t] - self_c
                return ((n_tw + beta) * (n_td + alpha)
                        / (n_t + V * beta))

            # Doc-proposal token trick: j-th valid token of doc d, found
            # through a stable sort that packs valid positions first.
            order = torch.argsort((~valid).to(torch.int32), dim=1,
                                  stable=True)                   # [D, L]
            n_d = valid.sum(dim=1).to(wt.dtype)                  # [D]
            j_max = torch.clamp(n_d.long() - 1, min=0)[:, None]

            s = z0
            pi_s = pi_num(s)
            for step in range(mh_steps):
                if step % 2 == 0:
                    # ---- word proposal: inverse-CDF binary search
                    u = draws.u_prop[step] * total
                    lo = torch.zeros_like(w)
                    hi = torch.full_like(w, K - 1)
                    for _ in range(n_bits):
                        mid = (lo + hi) // 2
                        below = cdf[w, mid] < u
                        lo = torch.where(below, mid + 1, lo)
                        hi = torch.where(below, hi, mid)
                    t = hi
                    q_s, q_t = qw[w, s], qw[w, t]
                else:
                    # ---- doc proposal: token trick, q_d(k) ∝ n_kd + α
                    pick_tok = ((draws.u_prop[step]
                                 * (n_d[:, None] + K * alpha))
                                < n_d[:, None])
                    j = torch.floor(draws.u_tok[step]
                                    * n_d[:, None]).long()
                    # Clip to n_d-1 per doc: fp32 rounding can make
                    # uniform*n_d land exactly on n_d, which would read a
                    # PAD slot (z0 forced to 0 — a bias toward topic 0).
                    j = torch.minimum(torch.clamp(j, min=0), j_max)
                    t_tok = z0[d_idx, order[d_idx, j]]
                    t = torch.where(pick_tok, t_tok, draws.t_unif[step])
                    q_s = doc_topic[d_idx, s] + alpha
                    q_t = doc_topic[d_idx, t] + alpha
                pi_t = pi_num(t)
                ratio = (pi_t * q_s) / torch.clamp(pi_s * q_t, min=1e-30)
                accept = (draws.u_acc[step] < ratio) & valid
                s = torch.where(accept, t, s)
                pi_s = torch.where(accept, pi_t, pi_s)

            new_z = torch.where(valid, s, PAD)
            # Deltas via flat scatter-adds on index d·K + k: O(tokens),
            # never [D, L, K].  Whole counts in float32 add exactly.
            d_flat = d_idx.reshape(-1)
            w_flat = w.reshape(-1)
            old_flat = z0.reshape(-1)
            new_flat = s.reshape(-1)
            v_flat = vf.reshape(-1)

            def counts(n, base, width):
                return (torch.zeros(n * width, dtype=wt.dtype,
                                    device=wt.device)
                        .index_add_(0, base * width + new_flat, v_flat)
                        .index_add_(0, base * width + old_flat, v_flat,
                                    alpha=-1))

            dt_delta = counts(D, d_flat, K).view(D, K)
            ts_delta = counts(1, torch.zeros_like(d_flat), K)
            # The word-topic delta stays on the device: the [V, K] count
            # update rides the table's device add (HBM speed) instead of
            # a host round trip.
            wt_delta = counts(V, w_flat, K).view(V, K)
            return new_z, doc_topic + dt_delta, ts_delta, wt_delta

        self._fused_cache[cache_key] = (pass_fn, place)
        return pass_fn, place

    def run_mh_pass(self, docs: np.ndarray, doc_topic, mh_steps: int = 4,
                    draws: Optional[MHDraws] = None):
        """Drive one LightLDA-MH sweep: gather → MH on the device → push
        deltas.  ``draws`` defaults to the model generator's.

        In one process the returned doc-topic matrix is a tensor on the
        tables' device (it never ships to the host between sweeps);
        ``sample_pass``, ``topic_purity`` and ``numpy.asarray`` of its
        ``.cpu()`` read it.  Accepts either kind as input.
        """
        pass_fn, place = self.make_mh_pass(docs.shape[1], mh_steps)
        if draws is None:
            draws = self.mh_draws(docs.shape, mh_steps)
        return self._drive_pass(pass_fn, place, docs, doc_topic, draws,
                                device_wt_delta=True)

    def run_fused_pass(self, docs: np.ndarray, doc_topic,
                       gumbel: Optional[torch.Tensor] = None) -> np.ndarray:
        """Drive one fused sweep: gather → sample on the device → push
        deltas.  ``gumbel`` ([D, L, K]) defaults to the model
        generator's."""
        pass_fn, place = self.make_fused_pass(docs.shape[1])
        if gumbel is None:
            gumbel = self.fused_draws(docs.shape + (self.K,))
        return self._drive_pass(pass_fn, place, docs, doc_topic, gumbel)

    def _drive_pass(self, pass_fn, place, docs: np.ndarray, doc_topic,
                    draws, device_wt_delta: bool = False):
        """Shared driver for the fused/MH sweeps: pull table state, run
        the sweep, push deltas back through the tables.

        ``device_wt_delta``: the sweep also returns a dense [V, K]
        word-topic delta which goes straight through the table's device
        add.  ``doc_topic`` is then returned as a device
        tensor, so it never ships to the host between sweeps.
        """
        wt_full, _ = self.word_topic.raw_value()
        ts = host_put(self.topic_sum.get(), self.device)
        old_z = self._z
        docs_t = place(np.asarray(docs, np.int64))
        outs = pass_fn(wt_full, ts, docs_t, place(old_z.astype(np.int64)),
                       place(doc_topic), draws)
        if device_wt_delta:
            new_z, new_dt, ts_delta, wt_delta = outs
        else:
            (new_z, new_dt, ts_delta), wt_delta = outs, None
        self._z = host_fetch(new_z).astype(np.int32)
        if wt_delta is not None:
            self.word_topic.add(wt_delta)      # device-resident tier
            self.topic_sum.add(ts_delta)       # ditto (a tensor delta)
            return new_dt
        # Word-topic deltas rebuilt sparsely on the host from (old_z,
        # new_z): [touched_words, K] instead of a dense [D, L, K].
        valid = docs != PAD
        w_flat = docs[valid]
        old_flat = old_z[valid]
        new_flat = self._z[valid]
        touched, inv = np.unique(w_flat, return_inverse=True)
        agg = np.zeros((touched.size, self.K), np.float32)
        np.add.at(agg, (inv, old_flat), -1.0)
        np.add.at(agg, (inv, new_flat), 1.0)
        self.word_topic.add_rows(touched, agg)
        self.topic_sum.add(host_fetch(ts_delta))
        return host_fetch(new_dt)

    def close(self) -> None:
        """Release both tables' device memory (see ``Table.close``)."""
        self.word_topic.close()
        self.topic_sum.close()
        self._fused_cache.clear()

    # ------------------------------------------------------------- analysis
    def topic_purity(self, docs: np.ndarray, true_topics: np.ndarray,
                     doc_topic) -> float:
        """Fraction of docs whose argmax inferred topic maps 1:1 to the
        planted topic (best matching via greedy assignment)."""
        inferred = _host(doc_topic).argmax(axis=1)
        K = self.K
        conf = np.zeros((K, K))
        for inf, true in zip(inferred, true_topics):
            conf[inf, true] += 1
        purity = 0.0
        used = set()
        for inf in np.argsort(-conf.max(axis=1)):
            best = int(np.argmax(
                [conf[inf, t] if t not in used else -1 for t in range(K)]))
            used.add(best)
            purity += conf[inf, best]
        return purity / len(true_topics)
