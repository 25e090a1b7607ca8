"""The traffic generators: deterministic from the seed, and the
distributions differ as the cells say."""

import torch

from perfbench import common
from perfbench.drivers import trainer, w2v

W2V = common.load_json("configs", "w2v-3m-d300.json")


def _small(ids):
    model = {**W2V, "vocab_size": 20000,
             "assumed": {**W2V["assumed"], "pairs_per_step": 4096}}
    traffic = {"ids": ids, "exponent": 1.0, "pool_steps": 3,
               "corpus_block": 8192}
    return model, traffic


def test_pairs_are_deterministic_from_a_large_seed():
    model, traffic = _small("zipf")
    seed = 2 ** 31 + 977
    a = w2v.make_batches(model, traffic, seed, "cpu")
    b = w2v.make_batches(model, traffic, seed, "cpu")
    c = w2v.make_batches(model, traffic, seed + 1, "cpu")
    assert all(torch.equal(x, y) for p, q in zip(a, b) for x, y in zip(p, q))
    assert not torch.equal(a[0][0], c[0][0])
    for cen, ctx, neg in a:
        assert cen.shape == ctx.shape == (4096,)
        assert neg.shape == (4096, 5)
        assert cen.dtype == torch.int64
        assert int(cen.max()) < 20000 and int(neg.min()) >= 0


def test_zipf_repeats_rows_and_uniform_does_not():
    zipf = w2v.make_batches(*_small("zipf"), 5, "cpu")[0]
    uni = w2v.make_batches(*_small("uniform"), 5, "cpu")[0]
    zin, zout = w2v.distinct_rows(zipf)
    uin, uout = w2v.distinct_rows(uni)
    assert zout < 0.8 * uout and zin < uin
    # the hottest output row recurs many times in a zipf batch
    counts = torch.bincount(torch.cat([zipf[1], zipf[2].reshape(-1)]))
    assert int(counts.max()) > 200
    assert int(torch.bincount(uni[2].reshape(-1)).max()) < 20


def test_subsampling_keeps_rare_words_and_thins_frequent_ones():
    probs = common.rank_probs(100000, "zipf")
    keep = common.keep_probs(probs, 1e-4)
    assert float(keep[-1]) == 1.0
    assert float(keep[0]) < 0.1
    assert torch.all(common.keep_probs(common.rank_probs(
        100000, "uniform"), 1e-4) == 1.0)


def test_skipgram_pairs_by_hand():
    tokens = torch.tensor([10, 11, 12])
    g = torch.Generator().manual_seed(0)
    c, o = common.skipgram_pairs(tokens, 1, g)
    # window 1: each position pairs with its neighbours, left to right.
    assert c.tolist() == [10, 11, 11, 12]
    assert o.tolist() == [11, 10, 12, 11]


def test_trainer_tokens_deterministic():
    model = {"vocab_size": 1000}
    traffic = {"batch": 2, "seq": 16, "ids": "zipf", "exponent": 1.0,
               "pool_steps": 3}
    a = trainer.make_tokens(model, traffic, 2 ** 33, "cpu")
    b = trainer.make_tokens(model, traffic, 2 ** 33, "cpu")
    assert len(a) == 3 and a[0].shape == (2, 16)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], a[1])
    assert int(torch.cat(a).max()) < 1000
