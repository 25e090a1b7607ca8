"""Runs with the timed path broken underneath come out not correct.

Each test skips the look for a card and drives the rest of a run at a
size a test can hold, on the CPU, with one fault planted in the program
under test: a step that leaves the state as it was, or half of each
batch left out (the mean taken over the rest).  A cell on one card has
no exchange between cards, and a training step produces no answer that
a token could alter.  The cells' own limits judge every run.
"""

import pytest
import torch

from perfbench import run
from perfbench.tests.test_perfbench_line import TINY_TRAIN, _tiny_w2v


def _train(monkeypatch=None):
    return run.run("ouro-2.6b-l16.seq2k", 2 ** 32 + 17, 0.2, False, "cpu",
                   overrides=TINY_TRAIN)


def _w2v():
    return run.run("w2v-3m-d300.zipf", 2 ** 32 + 19, 0.2, False, "cpu",
                   overrides=_tiny_w2v())


def test_trainer_state_left_unchanged(monkeypatch):
    from multiverso_tpu_torch.updaters.momentum import MomentumUpdater

    monkeypatch.setattr(MomentumUpdater, "apply_dense",
                        lambda self, w, state, delta, opt: (w, state))
    out = _train()
    assert out["correct"] is False
    assert out["check"]["change_gap"]["value"] == pytest.approx(1.0)


def test_trainer_half_batch(monkeypatch):
    from multiverso_tpu_torch.models.transformer import TransformerTrainer

    orig = TransformerTrainer.train_step_async

    def half(self, tokens, accum=1):
        return orig(self, tokens[: tokens.shape[0] // 2], accum)

    monkeypatch.setattr(TransformerTrainer, "train_step_async", half)
    assert _train()["correct"] is False


def test_w2v_state_left_unchanged(monkeypatch):
    from multiverso_tpu_torch.tables.matrix_table import MatrixTable

    monkeypatch.setattr(MatrixTable, "scatter_rows",
                        lambda self, data, state, ids, delta, opt:
                        (data, state))
    out = _w2v()
    assert out["correct"] is False
    assert out["check"]["change_gap"]["value"] == pytest.approx(1.0)


def test_w2v_half_batch(monkeypatch):
    from multiverso_tpu_torch.apps.word2vec import SkipGram

    orig = SkipGram.make_fused_step

    def make(self, batch_axis="worker"):
        step, place = orig(self, batch_axis)

        def half(din, sin, dout, sout, c, o, neg):
            h = c.shape[0] // 2
            return step(din, sin, dout, sout, c[:h], o[:h], neg[:h])

        return half, place

    monkeypatch.setattr(SkipGram, "make_fused_step", make)
    assert _w2v()["correct"] is False


def test_sound_runs_are_correct():
    assert _w2v()["correct"] is True
    out = _train()
    assert all(torch.isfinite(torch.tensor(v["value"]))
               for v in out["check"].values())
