"""The plain references against small cases worked another way."""

import math

import pytest
import torch
import torch.nn.functional as F

from perfbench.configs import decoder_ref, sgns_ref

TINY = {"hidden_size": 8, "intermediate_size": 16, "vocab_size": 32,
        "num_hidden_layers": 2, "num_attention_heads": 2, "head_dim": 4,
        "rms_norm_eps": 1e-6, "rope_theta": 10000.0}


def test_sgns_step_matches_autograd_and_sums_duplicates():
    g = torch.Generator().manual_seed(0)
    w_in = torch.randn(6, 3, generator=g, dtype=torch.float64).float()
    w_out = torch.randn(6, 3, generator=g, dtype=torch.float64).float()
    c = torch.tensor([0, 0, 1])
    o = torch.tensor([2, 3, 2])
    neg = torch.tensor([[4, 4], [5, 2], [3, 4]])
    a_in = w_in.clone().requires_grad_()
    a_out = w_out.clone().requires_grad_()
    vc, uo, un = a_in[c], a_out[o], a_out[neg]
    loss = -(F.logsigmoid((vc * uo).sum(-1)).sum()
             + F.logsigmoid(-(un * vc[:, None]).sum(-1)).sum()) / 3
    loss.backward()
    got = sgns_ref.sgns_step(w_in, w_out, c, o, neg, lr=0.5)
    assert got == pytest.approx(float(loss.detach()), rel=1e-6)
    assert torch.allclose(w_in, a_in.detach() - 0.5 * a_in.grad, atol=1e-6)
    assert torch.allclose(w_out, a_out.detach() - 0.5 * a_out.grad,
                          atol=1e-6)


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2 ** -12, 1.0 + 2 ** -10, -3.0 - 2 ** -9])
    assert sgns_ref._tf32(x).tolist() == [1.0, 1.0, 1.0 + 2 ** -10,
                                          -3.0 - 2 ** -9]


def test_fp8_rounding_keeps_three_mantissa_bits():
    x = torch.tensor([448.0, 1.0, 1.0625, 1.2])
    y = decoder_ref._fp8(x)
    assert y[0] == 448.0 and y[1] == 1.0
    assert float(y[3]) == pytest.approx(1.25)
    z = torch.linspace(-3, 3, 1001)
    assert float(((decoder_ref._fp8(z) - z).abs() / z.abs().clamp_min(
        0.05)).max()) <= 2 ** -4 + 1e-6


def test_attention_matches_dense_causal_softmax():
    g = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn(2, 3, 10, 4, generator=g) for _ in range(3))
    want = F.scaled_dot_product_attention(q, k, v, is_causal=True)
    for block in (3, 10):
        got = decoder_ref._attention(q, k, v, "fp32", block)
        assert torch.allclose(got, want, atol=1e-5)


def test_rope_rotates_pairs_and_leaves_position_zero():
    x = torch.randn(1, 1, 5, 4)
    y = decoder_ref._rope(x, 10000.0)
    assert torch.allclose(y[..., 0, :], x[..., 0, :])
    assert torch.allclose(y.norm(dim=-1), x.norm(dim=-1), atol=1e-5)
    # position 1, first pair: angle 1 rad (theta^0)
    a = x[0, 0, 1]
    assert float(y[0, 0, 1, 0]) == pytest.approx(
        float(a[0] * math.cos(1) - a[2] * math.sin(1)), abs=1e-5)


def _flat(seed=0):
    shapes = decoder_ref.leaf_shapes(TINY)
    g = torch.Generator().manual_seed(seed)
    parts = []
    for name, s in shapes:
        parts.append(torch.ones(s).reshape(-1) if len(s) == 1 else
                     0.3 * torch.randn(s, generator=g).reshape(-1))
    return torch.cat(parts)


def test_loss_of_an_untrained_uniform_head():
    flat = _flat()
    views = decoder_ref.views(flat, decoder_ref.leaf_shapes(TINY))
    views["head"].zero_()
    tokens = torch.randint(0, 32, (2, 6), generator=torch.Generator()
                           .manual_seed(2))
    loss = decoder_ref.loss_fn(views, tokens, TINY)
    assert float(loss) == pytest.approx(math.log(32), rel=1e-6)


def test_momentum_training_readings():
    flat = _flat()
    start = flat.clone()
    tokens = torch.randint(0, 32, (2, 6), generator=torch.Generator()
                           .manual_seed(3))
    one = decoder_ref.train(flat.clone(), TINY, [tokens], 0.1, 0.9)
    # after one step the change is lr times the first gradient, leaf by leaf
    for name, g in one["grad"].items():
        assert one["change"][name] == pytest.approx(0.1 * g, rel=1e-4,
                                                    abs=1e-9)
    three = decoder_ref.train(flat, TINY, [tokens] * 3, 0.1, 0.9)
    assert three["loss"][0] == pytest.approx(one["loss"][0])
    assert three["loss"][2] < three["loss"][0]
    assert not torch.equal(flat, start)
