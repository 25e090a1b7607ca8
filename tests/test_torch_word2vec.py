"""The port's word2vec (``SkipGram``) and DLRM apps against the JAX
package's.

Both packages build their tables from the same ``RandomState`` seeds and
draw the same batches, so the same steps must leave the same tables.
SkipGram runs at vocab 1,000, dim 16, batch 64, 5 negatives; tables and
losses agree within rtol 1e-5 (atol 1e-8: the output table starts at
zero, and its first updates are of order 1e-6).  DLRM's five-step loss
trajectory and table agree within rtol 1e-5 as well.

The trajectories run through ``sgd`` and ``momentum``.  AdaGrad is held
to the JAX package by the updater and row-table tests instead: its
first step on a row is ``lr·g/(|g| + 1e-8)``, so where a row's summed
gradient cancels to about 1e-12 the two packages' last-bit differences
in ``g`` come out as 1e-5 differences in the row (seen at lr 0.5).
"""

from functools import partial
from types import SimpleNamespace

import numpy as np
import pytest
import torch

VOCAB, DIM, BATCH, NEG = 1000, 16, 64, 5
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
    import multiverso_tpu.apps as japps

    import multiverso_tpu_torch.apps as tapps

    return [SimpleNamespace(name="jax", m=mv, apps=japps, init=mv.init),
            SimpleNamespace(name="torch", m=tmv, apps=tapps,
                            init=partial(tmv.init, device="cpu"))]


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64),
                               rtol=rtol, atol=atol)


def _both(mv, tmv, run):
    out = {}
    for s in _sides(mv, tmv):
        out[s.name] = run(s)
        s.m.shutdown()
    return out["torch"], out["jax"]


def _corpus(tokens=3000, seed=0):
    from multiverso_tpu_torch.apps import synthetic_corpus

    return synthetic_corpus(tokens, VOCAB, seed=seed)


def _tables(sg):
    return [sg.table_in.get(), sg.table_out.get()]


def test_corpus_batches_and_init_match(mv, tmv):
    def run(s):
        s.init()
        corpus = s.apps.synthetic_corpus(3000, VOCAB, seed=0)
        sg = s.apps.SkipGram(VOCAB, DIM, negatives=NEG)
        return [corpus] + list(next(sg.batches(corpus, BATCH))) + _tables(sg)

    got, want = _both(mv, tmv, run)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("updater", ["sgd", "momentum"])
def test_pushpull_five_step_trajectory(mv, tmv, updater):
    corpus = _corpus()

    def run(s):
        s.init(updater_type=updater)
        sg = s.apps.SkipGram(VOCAB, DIM, negatives=NEG,
                             updater_type=updater, learning_rate=0.5)
        traj = []
        for _, batch in zip(range(5), sg.batches(corpus, BATCH)):
            sg.train_batch(*batch)
            traj.append(_tables(sg))
        return traj

    got, want = _both(mv, tmv, run)
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("updater", ["sgd", "momentum"])
def test_fused_five_step_trajectory(mv, tmv, updater):
    """Losses and tables after each of five fused steps; momentum
    segment-sums duplicate rows on the device first."""
    corpus = _corpus()

    def run(s):
        s.init(updater_type=updater)
        sg = s.apps.SkipGram(VOCAB, DIM, negatives=NEG,
                             updater_type=updater, learning_rate=0.5)
        step, place = sg.make_fused_step()
        din, sin = sg.table_in.raw_value()
        dout, sout = sg.table_out.raw_value()
        losses, tables = [], []
        for _, (c, o, neg) in zip(range(5), sg.batches(corpus, BATCH)):
            din, sin, dout, sout, loss = step(din, sin, dout, sout,
                                              place(c), place(o), place(neg))
            losses.append(float(loss))
            tables.append([np.array(din), np.array(dout)]
                          + [np.array(x) for x in (*sin, *sout)])
        sg.table_in.raw_assign(din, sin)
        sg.table_out.raw_assign(dout, sout)
        return losses, tables, _tables(sg)

    got, want = _both(mv, tmv, run)
    _close(got[0], want[0])
    for g, w in zip(got[1], want[1]):
        _close(g, w)
    _close(got[2], want[2])
    assert np.isfinite(got[0]).all()


def test_pushpull_equals_fused_step(tmv):
    """One push-pull step and one fused step from the same start leave
    the same tables (the JAX package's own single-batch check)."""
    tmv.init(device="cpu", updater_type="momentum")
    from multiverso_tpu_torch.apps import SkipGram

    c = np.array([1, 1, 1, 2], np.int32)
    o = np.array([4, 4, 5, 4], np.int32)
    neg = np.array([[4, 5], [5, 4], [4, 4], [5, 5]], np.int32)
    a = SkipGram(32, 4, negatives=2, seed=9, updater_type="momentum",
                 name="w2v_a")
    a.train_batch(c, o, neg)
    b = SkipGram(32, 4, negatives=2, seed=9, updater_type="momentum",
                 name="w2v_b")
    step, place = b.make_fused_step()
    out = step(*b.table_in.raw_value(), *b.table_out.raw_value(),
               place(c), place(o), place(neg))
    b.table_in.raw_assign(out[0], out[1])
    b.table_out.raw_assign(out[2], out[3])
    for x, y in zip(_tables(a), _tables(b)):
        _close(x, y, rtol=1e-4, atol=1e-6)
    _close(a.table_out.raw_value()[1][0], b.table_out.raw_value()[1][0],
           rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("prefetch", [True, False])
def test_train_epoch_with_and_without_async_buffer(mv, tmv, prefetch):
    corpus = _corpus(600, seed=2)

    def run(s):
        s.init(updater_type="sgd")
        sg = s.apps.SkipGram(VOCAB, DIM, negatives=NEG, learning_rate=0.5)
        steps = sg.train_epoch(corpus, BATCH, seed=1, prefetch=prefetch)
        return steps, _tables(sg)

    got, want = _both(mv, tmv, run)
    assert got[0] == want[0] > 0
    _close(got[1], want[1])


def test_train_epoch_fused_and_most_similar(mv, tmv):
    corpus = _corpus(600, seed=3)

    def run(s):
        s.init(updater_type="sgd")
        sg = s.apps.SkipGram(VOCAB, DIM, negatives=NEG, learning_rate=0.5)
        steps, loss = sg.train_epoch_fused(corpus, BATCH, seed=1)
        return steps, loss, _tables(sg), sg.most_similar(3, topk=5)

    got, want = _both(mv, tmv, run)
    assert got[0] == want[0] > 0
    _close(got[1], want[1])
    _close(got[2], want[2])
    np.testing.assert_array_equal(got[3], want[3])


def test_no_full_batch_raises(mv, tmv):
    for s in _sides(mv, tmv):
        s.init()
        sg = s.apps.SkipGram(VOCAB, DIM)
        with pytest.raises(ValueError, match="no full batch"):
            sg.train_epoch(np.arange(3, dtype=np.int32), 64)
        with pytest.raises(ValueError, match="no full batch"):
            sg.train_epoch_fused(np.arange(3, dtype=np.int32), 64)
        s.m.shutdown()


def test_ids_past_the_vocabulary_raise(tmv):
    """On the card an id past the table is a device-side assert, so the
    port refuses such ids on the host."""
    tmv.init(device="cpu")
    from multiverso_tpu_torch.apps import SkipGram

    sg = SkipGram(50, 4)
    _, place = sg.make_fused_step()
    with pytest.raises(ValueError, match=r"\[0, 50\)"):
        place(np.array([1, 50], np.int32))
    with pytest.raises(ValueError, match=r"\[0, 50\)"):
        next(sg.batches(np.array([1, 2, -1] * 40, np.int32), 8))
    assert place(np.array([0, 49])).dtype == torch.int64


# ------------------------------------------------------------------ DLRM

def test_dlrm_five_step_trajectory(mv, tmv):
    def run(s):
        s.init()
        rec = s.apps.DLRMRecommender(300, 200, dim=8, learning_rate=0.5,
                                     seed=4)
        losses = rec.train_epoch(5, 128, seed=7)
        rep = rec.hot_report()
        return (losses, rec.table.get(), rec.scores(0, [0, 1, 5]),
                rep["gets"], rep["adds"])

    got, want = _both(mv, tmv, run)
    _close(got[0], want[0])
    _close(got[1], want[1], atol=1e-7)
    _close(got[2], want[2], atol=1e-7)
    assert got[3:] == want[3:]
    assert got[0][-1] < got[0][0]


def test_zipf_ids_and_clicks_match():
    from multiverso_tpu.apps import dlrm as jd

    from multiverso_tpu_torch.apps import dlrm as td

    a = td.synthetic_clicks(64, 100, 50, np.random.RandomState(3))
    b = jd.synthetic_clicks(64, 100, 50, np.random.RandomState(3))
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
