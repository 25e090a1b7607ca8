"""The port's skip-gram mixture against the JAX package's.

Both packages build their three tables (sense, out, prior) from the same
``RandomState`` seeds and draw the same occurrence batches, so the same
steps must leave the same tables.  The runs use V 50, dim 16, 2 and 3
senses, batches of 64 occurrences with 5 negatives, on the word2vec
corpus; tables and losses agree within rtol 1e-5, with atol 1e-8 for the
entries near zero (the tables start random, at entries of about
1/sqrt(16) = 0.25, so the atol binds only near zero).  The padding id
``vocab_size`` pads every context bag: the JAX package's 8-device test
mesh pads the out table's 50 rows to 56, so it reads untouched padding
there, and the port reads zeros — the same zeros.
"""

from functools import partial
from types import SimpleNamespace

import numpy as np
import pytest
import torch

V, DIM, BATCH, NEG = 50, 16, 64, 5
RTOL, ATOL = 1e-5, 1e-8


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
    import jax.numpy as jnp

    import multiverso_tpu.apps as japps

    import multiverso_tpu_torch.apps as tapps

    return [SimpleNamespace(name="jax", m=mv, apps=japps, init=mv.init,
                            mask=lambda place, m: place(
                                m.astype(np.int32)).astype(jnp.bool_)),
            SimpleNamespace(name="torch", m=tmv, apps=tapps,
                            init=partial(tmv.init, device="cpu"),
                            mask=lambda place, m: torch.as_tensor(m))]


def _both(mv, tmv, run, updater="sgd"):
    out = {}
    for s in _sides(mv, tmv):
        s.init(updater_type=updater)
        out[s.name] = run(s)
        s.m.shutdown()
    return out["torch"], out["jax"]


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64),
                               rtol=rtol, atol=atol)


def _tables(sg):
    return [sg.table_sense.get(), sg.table_out.get(), sg.table_prior.get()]


def _corpus(tokens=3000, seed=0):
    from multiverso_tpu_torch.apps import synthetic_corpus

    return synthetic_corpus(tokens, V, seed=seed)


def _model(s, senses, updater="sgd", lr=0.5, name="sgmix", seed=0):
    return s.apps.SkipGramMixture(V, DIM, senses=senses, learning_rate=lr,
                                  negatives=NEG, updater_type=updater,
                                  name=name, seed=seed)


def _fused(s, sg, batches):
    """Run ``batches`` through the fused step, hand the tables back, and
    return the losses."""
    step, place = sg.make_fused_step()
    cur = [*sg.table_sense.raw_value(), *sg.table_out.raw_value(),
           *sg.table_prior.raw_value()]
    losses = []
    for c, bags, mask, neg in batches:
        *cur, loss = step(*cur, place(c), place(bags), s.mask(place, mask),
                          place(neg))
        losses.append(float(loss))
    sg.table_sense.raw_assign(cur[0], cur[1])
    sg.table_out.raw_assign(cur[2], cur[3])
    sg.table_prior.raw_assign(cur[4], cur[5])
    return losses


def test_corpus_batches_and_init_match(mv, tmv):
    def run(s):
        corpus = s.apps.synthetic_homonym_corpus(500, 21, seed=4)
        sg = _model(s, 3)
        first = list(next(sg.batches(_corpus(), BATCH, seed=2)))
        return [corpus] + first + _tables(sg)

    got, want = _both(mv, tmv, run)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert (got[2] == V).any()          # the bags carry the padding id


@pytest.mark.parametrize("senses", [2, 3])
def test_pushpull_step_matches_jax(mv, tmv, senses):
    def run(s):
        sg = _model(s, senses)
        sg.train_batch(*next(sg.batches(_corpus(), BATCH)))
        return _tables(sg)

    got, want = _both(mv, tmv, run)
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("senses", [2, 3])
def test_fused_five_steps_match_jax(mv, tmv, senses):
    """Losses and all three tables after each of five fused sgd steps."""
    def run(s):
        sg = _model(s, senses)
        losses, tables = [], []
        for _, b in zip(range(5), sg.batches(_corpus(), BATCH)):
            losses += _fused(s, sg, [b])
            tables.append(_tables(sg))
        return losses, tables

    got, want = _both(mv, tmv, run)
    _close(got[0], want[0])
    for g, w in zip(got[1], want[1]):
        for x, y in zip(g, w):
            _close(x, y)
    assert np.isfinite(got[0]).all()


def test_pushpull_equals_fused(tmv):
    """One push-pull EM batch and one fused EM batch from the same start
    leave the same three tables (the JAX package's own check)."""
    tmv.init(device="cpu", updater_type="sgd")
    from multiverso_tpu_torch.apps import SkipGramMixture

    rng = np.random.RandomState(0)
    B, K, C = 64, 3, 4
    c = rng.randint(21, size=B).astype(np.int32)
    bags = rng.randint(21, size=(B, C)).astype(np.int32)
    mask = rng.rand(B, C) < 0.8
    mask[:, 0] = True
    neg = rng.randint(21, size=(B, K)).astype(np.int32)
    a = SkipGramMixture(21, dim=8, senses=2, window=2, name="sgm_a", seed=5)
    b = SkipGramMixture(21, dim=8, senses=2, window=2, name="sgm_b", seed=5)
    a.train_batch(c, bags, mask, neg)
    side = SimpleNamespace(mask=lambda place, m: torch.as_tensor(m))
    _fused(side, b, [(c, bags, mask, neg)])
    for x, y in zip(_tables(a), _tables(b)):
        _close(x, y, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("path", ["pushpull", "fused"])
def test_padding_leaves_word0_and_last_row_alone(mv, tmv, path):
    """The JAX package's padding case (V 12, the sentinel 12 in every
    padded bag slot) under momentum, which decays state even on zero
    deltas.  A first step gives words 0 and 11 (V-1) momentum state; the
    padded steps, whose ids avoid both, leave their rows and state in all
    three tables bit for bit, in both packages, which agree."""
    rng = np.random.RandomState(3)
    B, C, Vp = 16, 6, 12
    first = (np.array([0, 11] * 8, np.int32),
             np.tile(np.array([[11, 0, 5, 6, 7, 8]], np.int32), (B, 1)),
             np.ones((B, C), bool), rng.randint(12, size=(B, 2)))
    c = rng.randint(1, 11, size=B).astype(np.int32)
    bags = np.full((B, C), Vp, np.int32)
    bags[:, 0] = rng.randint(1, 11, size=B)
    mask = np.zeros((B, C), bool)
    mask[:, 0] = True
    neg = rng.randint(1, 11, size=(B, 2)).astype(np.int32)

    def rows(sg):
        out = []
        for t, r in ((sg.table_sense, [0, 1, 22, 23]),
                     (sg.table_out, [0, 11]), (sg.table_prior, [0, 11])):
            data, state = t.raw_value()
            out += [np.array(data)[r]] + [np.array(x)[r] for x in state]
        return out

    def run(s):
        sg = s.apps.SkipGramMixture(Vp, dim=4, senses=2, window=3,
                                    name="sgm_pad", updater_type="momentum",
                                    seed=2)
        if path == "pushpull":
            sg.train_batch(*first)
        else:
            _fused(s, sg, [first])
        before = rows(sg)
        for _ in range(3):
            if path == "pushpull":
                sg.train_batch(c, bags, mask, neg)
            else:
                _fused(s, sg, [(c, bags, mask, neg)])
        return before, rows(sg), _tables(sg)

    got, want = _both(mv, tmv, run, updater="momentum")
    for before, after in (got[:2], want[:2]):
        for x, y in zip(before, after):
            np.testing.assert_array_equal(x, y)
    assert any(np.abs(x).max() > 0 for x in got[0][1:4:2])   # state set
    for g, w in zip(got[2], want[2]):
        _close(g, w)


@pytest.mark.parametrize("path", ["pushpull", "fused"])
def test_prior_counts_grow_by_the_batch(tmv, path):
    """Prior rows take plain-add responsibility counts: every batch adds
    exactly B responsibilities across the touched rows."""
    tmv.init(device="cpu", updater_type="sgd")
    from multiverso_tpu_torch.apps import SkipGramMixture

    sg = SkipGramMixture(10, dim=4, senses=3, window=2, name="sgm_c", seed=1)
    before = sg.table_prior.get().sum()
    rng = np.random.RandomState(2)
    B = 32
    batch = (rng.randint(10, size=B).astype(np.int32),
             rng.randint(10, size=(B, 4)).astype(np.int32),
             np.ones((B, 4), bool), rng.randint(10, size=(B, 2)))
    if path == "pushpull":
        sg.train_batch(*batch)
    else:
        _fused(SimpleNamespace(mask=lambda place, m: torch.as_tensor(m)),
               sg, [batch])
    after = sg.table_prior.get().sum()
    np.testing.assert_allclose(after - before, B, rtol=1e-4)


def test_senses_separate_on_the_homonym_corpus(tmv):
    """The flagship multi-sense check of the JAX package: token 0 lives in
    two disjoint context worlds and its two senses specialize."""
    tmv.init(device="cpu", updater_type="sgd")
    from multiverso_tpu_torch.apps import (SkipGramMixture,
                                           synthetic_homonym_corpus)

    corpus = synthetic_homonym_corpus(4000, vocab_size=21,
                                      groups=((1, 10), (11, 20)), seed=0)
    sg = SkipGramMixture(21, dim=16, senses=2, learning_rate=0.3,
                         negatives=3, window=3, seed=3)
    for epoch in range(12):
        steps, loss = sg.train_epoch_fused(corpus, batch_size=256,
                                           seed=epoch)
    assert steps == 4000 // 256 and np.isfinite(loss)
    post_a = sg.sense_posterior(0, np.arange(1, 11))
    post_b = sg.sense_posterior(0, np.arange(11, 21))
    assert post_a.max() > 0.8, post_a
    assert post_b.max() > 0.8, post_b
    assert post_a.argmax() != post_b.argmax(), (post_a, post_b)
    assert sg.sense_priors(0).min() > 0.2
    sv_a = sg.sense_vector(0, int(post_a.argmax()))
    sv_b = sg.sense_vector(0, int(post_b.argmax()))
    cos = (sv_a @ sv_b) / (np.linalg.norm(sv_a) * np.linalg.norm(sv_b)
                           + 1e-12)
    assert cos < 0.9, cos


def test_epoch_and_analysis_match_jax(mv, tmv):
    corpus = _corpus(900, seed=3)

    def run(s):
        sg = _model(s, 2, lr=0.3)
        steps, loss = sg.train_epoch_fused(corpus, BATCH, seed=1)
        return [steps, loss] + _tables(sg) + [
            sg.sense_priors(3), sg.sense_posterior(3, np.arange(5, 12)),
            sg.sense_vector(3, 1)]

    got, want = _both(mv, tmv, run)
    assert got[0] == want[0] == 900 // BATCH
    for g, w in zip(got[1:], want[1:]):
        _close(g, w)


def test_ids_the_placer_admits(tmv):
    """The placer admits the padding id V and refuses ids past it; the
    batches refuse a corpus with an id outside the vocabulary."""
    tmv.init(device="cpu")
    from multiverso_tpu_torch.apps import SkipGramMixture

    sg = SkipGramMixture(V, 4)
    _, place = sg.make_fused_step()
    assert place(np.array([0, V])).dtype == torch.int64
    for bad in ([1, V + 1], [-1, 2]):
        with pytest.raises(ValueError, match=rf"\[0, {V + 1}\)"):
            place(np.array(bad, np.int32))
    with pytest.raises(ValueError, match=rf"\[0, {V}\)"):
        next(sg.batches(np.array([1, 2, V] * 40, np.int32), 8))
    with pytest.raises(ValueError, match="no full batch"):
        sg.train_epoch_fused(np.arange(3, dtype=np.int32), 64)
