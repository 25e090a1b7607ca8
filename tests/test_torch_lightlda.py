"""The port's LightLDA against the JAX package's.

Both packages build the same documents and the same initial topics from
the same ``RandomState`` seeds, so their host sweep (``sample_pass``)
must leave bit-equal counts.  The two device sweeps draw their random
numbers from ``jax.random`` in the JAX package; the port takes its draws
as tensors, so here they are filled from ``jax.random`` with the keys
the JAX package's ``_drive_pass`` uses on its first sweep: Gumbel noise
for the fused sweep (``jax.random.categorical`` is the argmax of logits
plus that noise, checked first), and each MH step's ``split(key, 5)``
draws.  From one start, at least 99.9% of the tokens must take the same
new topic: a comparison that sits on a rounding boundary may flip.  The
counts are checked for conservation exactly, after every sweep.  Doc
counts are multiples of 8 for the JAX package's 8-device test mesh.
"""

from functools import partial
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

Z_AGREE = 0.999


@pytest.fixture()
def tmv():
    import multiverso_tpu_torch as tmv

    def clean():
        if tmv.initialized():
            tmv.shutdown()
        tmv.config.reset()

    clean()
    yield tmv
    clean()


def _sides(mv, tmv):
    import multiverso_tpu.apps as japps

    import multiverso_tpu_torch.apps as tapps

    return [SimpleNamespace(name="jax", m=mv, apps=japps, init=mv.init),
            SimpleNamespace(name="torch", m=tmv, apps=tapps,
                            init=partial(tmv.init, device="cpu"))]


def _both(mv, tmv, run):
    out = {}
    for s in _sides(mv, tmv):
        s.init()
        out[s.name] = run(s)
        s.m.shutdown()
    return out["torch"], out["jax"]


def _host(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _state(lda, dt):
    return [lda._z.copy(), _host(dt), lda.word_topic.get(),
            lda.topic_sum.get()]


def _assert_conserved(docs, lda, dt):
    """Exact count conservation: doc rows sum to doc lengths, topic
    totals to the token count, word-topic columns to the topic totals."""
    wt = lda.word_topic.get().astype(np.float64)
    ts = lda.topic_sum.get().astype(np.float64)
    lengths = (docs != -1).sum(axis=1)
    np.testing.assert_array_equal(_host(dt).astype(np.float64).sum(1),
                                  lengths)
    assert ts.sum() == lengths.sum()
    np.testing.assert_array_equal(wt.sum(0), ts)
    assert (wt >= 0).all() and (ts >= 0).all()


def _docs(num_docs, vocab, topics, doc_len, seed, ragged=False):
    from multiverso_tpu_torch.apps import synthetic_documents

    docs, _ = synthetic_documents(num_docs, vocab, topics, doc_len=doc_len,
                                  seed=seed)
    if ragged:
        docs[::3, 17:] = -1          # ragged docs: PAD tails
        docs[5, :] = -1              # one fully-empty doc
    return docs


def _first_sweep_key(seed):
    """The key ``_drive_pass`` hands its first sweep."""
    _, sub = jax.random.split(jax.random.PRNGKey(seed))
    return sub


def _mh_draws(seed, shape, steps, topics):
    """The JAX MH sweep's draws on its first sweep, step by step: k1 the
    proposal uniform, k2 the token uniform, k3 the uniform topic, k4 the
    acceptance uniform (each step splits the key into five)."""
    from multiverso_tpu_torch.apps.lightlda import MHDraws

    key = _first_sweep_key(seed)
    cols = [[], [], [], []]
    for _ in range(steps):
        key, k1, k2, k3, k4 = jax.random.split(key, 5)
        cols[0].append(jax.random.uniform(k1, shape))
        cols[1].append(jax.random.uniform(k2, shape))
        cols[2].append(jax.random.randint(k3, shape, 0, topics))
        cols[3].append(jax.random.uniform(k4, shape))
    u_prop, u_tok, t, u_acc = (torch.from_numpy(np.asarray(jnp.stack(c)))
                               for c in cols)
    return MHDraws(u_prop, u_tok, t.long(), u_acc)


def test_documents_and_initial_counts_match(mv, tmv):
    docs = _docs(24, 60, 5, 30, seed=0)

    def run(s):
        d, true = s.apps.synthetic_documents(24, 60, 5, doc_len=30, seed=0)
        lda = s.apps.LightLDA(60, 5)
        dt = lda.initialize_counts(d, seed=4)
        return [d, true] + _state(lda, dt)

    got, want = _both(mv, tmv, run)
    np.testing.assert_array_equal(got[0], docs)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_sample_pass_two_sweeps_exact(mv, tmv):
    docs = _docs(16, 30, 3, 20, seed=1, ragged=True)

    def run(s):
        lda = s.apps.LightLDA(30, 3)
        dt = lda.initialize_counts(docs, seed=1)
        states = []
        for seed in (1, 2):
            dt = lda.sample_pass(docs, dt, seed=seed)
            states.append(_state(lda, dt))
        return states

    got, want = _both(mv, tmv, run)
    for g, w in zip(got, want):
        for x, y in zip(g, w):
            np.testing.assert_array_equal(x, y)


def test_categorical_is_gumbel_argmax():
    """The identity the fused sweep's draws rest on, in the installed
    JAX: ``categorical(key, logits) == argmax(logits + gumbel(key))``."""
    key = _first_sweep_key(3)
    logits = jax.random.normal(jax.random.PRNGKey(9), (8, 16, 12))
    got = jnp.argmax(logits + jax.random.gumbel(key, logits.shape), -1)
    np.testing.assert_array_equal(jax.random.categorical(key, logits, -1),
                                  got)


def _agree(got, want, docs):
    valid = docs != -1
    return float((got[0][valid] == want[0][valid]).mean())


@pytest.mark.parametrize("num_docs, vocab, topics, doc_len, seed", [
    (16, 40, 4, 32, 2), (24, 120, 12, 20, 3)])
def test_fused_sweep_matches_jax(mv, tmv, num_docs, vocab, topics, doc_len,
                                 seed):
    docs = _docs(num_docs, vocab, topics, doc_len, seed)
    gumbel = torch.from_numpy(np.asarray(jax.random.gumbel(
        _first_sweep_key(seed), docs.shape + (topics,))))

    def run(s):
        lda = s.apps.LightLDA(vocab, topics, seed=seed)
        dt = lda.initialize_counts(docs, seed=seed)
        if s.name == "jax":
            dt = lda.run_fused_pass(docs, dt)
        else:
            dt = lda.run_fused_pass(docs, dt, gumbel=gumbel)
            _assert_conserved(docs, lda, dt)
        return _state(lda, dt)

    got, want = _both(mv, tmv, run)
    assert _agree(got, want, docs) >= Z_AGREE
    if np.array_equal(got[0], want[0]):
        for g, w in zip(got[1:], want[1:]):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("case", ["basic", "ragged", "k1024"])
def test_mh_sweep_matches_jax(mv, tmv, case):
    num_docs, vocab, topics, doc_len, seed = {
        "basic": (16, 40, 4, 32, 5), "ragged": (16, 30, 3, 24, 6),
        "k1024": (32, 512, 1024, 20, 8)}[case]
    docs = _docs(num_docs, vocab, min(topics, 16), doc_len, seed,
                 ragged=case == "ragged")
    draws = _mh_draws(seed, docs.shape, 4, topics)

    def run(s):
        lda = s.apps.LightLDA(vocab, topics, seed=seed)
        dt = lda.initialize_counts(docs, seed=seed)
        if s.name == "jax":
            dt = lda.run_mh_pass(docs, dt, mh_steps=4)
        else:
            dt = lda.run_mh_pass(docs, dt, mh_steps=4, draws=draws)
            _assert_conserved(docs, lda, dt)
        return _state(lda, dt)

    got, want = _both(mv, tmv, run)
    assert _agree(got, want, docs) >= Z_AGREE
    if np.array_equal(got[0], want[0]):
        for g, w in zip(got[1:], want[1:]):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("sweep", ["fused", "mh", "mh_ragged"])
def test_counts_conserved_over_sweeps(tmv, sweep):
    """Three sweeps with the port's own draws; the counts stay exact after
    each, PAD tails and an empty doc included."""
    from multiverso_tpu_torch.apps import LightLDA

    tmv.init(device="cpu")
    docs = _docs(12, 30, 3, 24, seed=6, ragged=sweep == "mh_ragged")
    lda = LightLDA(30, 3)
    dt = lda.initialize_counts(docs, seed=6)
    _assert_conserved(docs, lda, dt)
    for _ in range(3):
        dt = (lda.run_fused_pass(docs, dt) if sweep == "fused"
              else lda.run_mh_pass(docs, dt))
        _assert_conserved(docs, lda, dt)
    assert isinstance(dt, np.ndarray if sweep == "fused" else torch.Tensor)


@pytest.mark.parametrize("sweep, sweeps, seed", [("fused", 15, 3),
                                                 ("mh", 25, 7)])
def test_purity_on_planted_topics(tmv, sweep, sweeps, seed):
    """The JAX package's topic-recovery setting (60 docs, V 80, K 4,
    concentration 0.05), with the port's own generator."""
    from multiverso_tpu_torch.apps import LightLDA, synthetic_documents

    tmv.init(device="cpu")
    docs, true = synthetic_documents(60, 80, 4, doc_len=48, seed=seed,
                                     concentration=0.05)
    lda = LightLDA(80, 4, alpha=0.5, beta=0.1, seed=seed)
    dt = lda.initialize_counts(docs, seed=seed)
    for _ in range(sweeps):
        dt = (lda.run_fused_pass(docs, dt) if sweep == "fused"
              else lda.run_mh_pass(docs, dt, mh_steps=4))
    assert lda.topic_purity(docs, true, dt) > 0.6   # random ≈ 1/K = 0.25


def test_draws_come_from_the_seeded_generator(tmv):
    """Two models of one seed sweep alike; the generator advances from
    sweep to sweep; another seed draws otherwise."""
    from multiverso_tpu_torch.apps import LightLDA

    tmv.init(device="cpu")
    docs = _docs(16, 40, 4, 32, seed=2)

    def sweeps(name, seed):
        lda = LightLDA(40, 4, name=name, seed=seed)
        dt = lda.initialize_counts(docs, seed=2)
        out = []
        for _ in range(2):
            dt = lda.run_mh_pass(docs, dt)
            out.append(lda._z.copy())
        return out

    a, b, c = sweeps("a", 0), sweeps("b", 0), sweeps("c", 1)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
    assert not np.array_equal(a[0], c[0])
    d = LightLDA(40, 4, name="d", seed=0)
    assert not torch.equal(d.fused_draws((4, 8, 4)), d.fused_draws((4, 8, 4)))


def test_close_releases_name(tmv):
    from multiverso_tpu_torch.apps import LightLDA

    tmv.init(device="cpu")
    docs = _docs(4, 20, 2, 8, seed=9)
    lda = LightLDA(20, 2, name="closable")
    lda.initialize_counts(docs, seed=9)
    lda.close()
    lda2 = LightLDA(20, 2, name="closable")
    dt = lda2.initialize_counts(docs, seed=9)
    _assert_conserved(docs, lda2, dt)
