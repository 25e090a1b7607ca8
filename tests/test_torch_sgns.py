"""word2vec's SGNS loss and gradients (``ops.sgns.sgns_grads``) on the CPU.

The plain version, which every CPU tensor takes, is held against the
autograd reference ``apps.word2vec._sgns_value_and_grad`` for the loss,
``dvc`` and ``dout`` in the output rows' order (contexts, then pair i's
negatives at rows B + i·K ...), across widths (D 300, 128, 7), negatives
(K 1, 5, 15), batches (B 1, 3, 1,000) and scores pushed to ±30, where
``logsigmoid`` saturates.  The CUDA kernel itself runs only on a card:
``chip_smoke.py``'s w2v phase holds it against the plain version.

Tolerances: both sides are float32.  The closed form sums each negative's
score as an elementwise product and a sum over D where autograd takes it
from ``bmm``, and sums ``dvc``'s 1 + K terms in another order, so entries
differ by a few float32 roundings of the terms summed: within rtol 1e-5
and, for entries that cancel to near zero, an atol of 1e-6 of the
tensor's largest entry (float32's eps is 6e-8; D ≤ 300 and 1 + K ≤ 16
terms).  Where a score is ±30, sigmoid(-30) = e^-30 to float32's
rounding, so a gradient's relative error is the score's absolute error:
a few roundings of 30, about 30 · 32 · 6e-8 ≈ 6e-5 where the sums of
the two sides round apart; those cases are held within rtol 1e-4.
"""

import numpy as np
import pytest
import torch

from multiverso_tpu_torch.apps.word2vec import _sgns_value_and_grad
from multiverso_tpu_torch.ops import _build, sgns

RTOL, ATOL_SHARE = 1e-5, 1e-6
SATURATED_RTOL = 1e-4


def _rows(b, k, d, seed, scale=1.0):
    g = torch.Generator().manual_seed(seed)
    vc = (torch.rand(b, d, generator=g) - 0.5) * scale
    out = (torch.rand(b * (1 + k), d, generator=g) - 0.5) * scale
    return vc, out


def _saturated(b, k, d, seed, sign):
    """Rows whose scores are ±30: the context's ``sign``·30, each
    negative's -``sign``·30 (sign +1: the loss near 0 and the gradients
    near e^-30; sign -1: the loss near 30·(1 + K), gradients near 1/B)."""
    vc, _ = _rows(b, k, d, seed)
    unit = vc / (vc * vc).sum(-1, keepdim=True)       # vc·unit = 1
    uo = sign * 30.0 * unit
    un = (-sign * 30.0 * unit)[:, None, :].expand(b, k, d)
    return vc, torch.cat([uo, un.reshape(b * k, d)]).contiguous()


def _want(vc, out, k):
    b, d = vc.shape
    loss, (dvc, duo, dun) = _sgns_value_and_grad(
        vc, out[:b], out[b:].reshape(b, k, d))
    return loss, dvc, torch.cat([duo, dun.reshape(b * k, d)])


def _close(got, want, rtol=RTOL):
    atol = ATOL_SHARE * float(want.abs().max())
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("b", [1, 3, 1000])
@pytest.mark.parametrize("k", [1, 5, 15])
@pytest.mark.parametrize("d", [300, 128, 7])
def test_plain_matches_autograd(d, k, b):
    vc, out = _rows(b, k, d, seed=d * 1000 + k * 10 + b)
    got = sgns.sgns_grads(vc, out, k)
    for g, w in zip(got, _want(vc, out, k)):
        assert g.dtype == torch.float32 and g.shape == w.shape
        _close(g, w)


@pytest.mark.parametrize("sign", [1.0, -1.0])
@pytest.mark.parametrize("d,k,b", [(300, 5, 64), (7, 15, 3)])
def test_plain_matches_autograd_where_logsigmoid_saturates(d, k, b, sign):
    vc, out = _saturated(b, k, d, seed=7, sign=sign)
    got = sgns.sgns_grads(vc, out, k)
    want = _want(vc, out, k)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        _close(g, w, SATURATED_RTOL)
    if sign < 0:
        # Every score is 30 on the wrong side: each pair's loss is 30·(1+K).
        assert abs(float(got[0]) - 30.0 * (1 + k)) < 1e-3 * (1 + k)


def test_dout_is_in_the_output_rows_order():
    """Row B + i·K + k of ``dout`` is pair i's k-th negative's gradient,
    g_k·vc[i], whatever the other pairs hold."""
    b, k, d = 3, 2, 5
    vc, out = _rows(b, k, d, seed=3)
    _, _, dout = sgns.sgns_grads(vc, out, k)
    for i in range(b):
        for n in range(k):
            row = out[b + i * k + n]
            g = torch.sigmoid(vc[i] @ row) / b
            torch.testing.assert_close(dout[b + i * k + n], g * vc[i])


def test_refuses_what_the_kernel_does_not_take():
    vc, out = _rows(4, 5, 8, seed=1)
    with pytest.raises(ValueError, match="float32"):
        sgns.sgns_grads(vc.double(), out.double(), 5)
    with pytest.raises(ValueError, match="contiguous"):
        strided = torch.empty(8, out.shape[0]).t()
        strided.copy_(out)
        sgns.sgns_grads(vc, strided, 5)
    with pytest.raises(ValueError, match="rows"):
        sgns.sgns_grads(vc, out[:-1].contiguous(), 5)
    with pytest.raises(ValueError, match="rows"):
        sgns.sgns_grads(vc, out, 4)
    with pytest.raises(ValueError, match=r"\[B, D\]"):
        sgns.sgns_grads(vc, out[:, :7].contiguous(), 5)


@pytest.mark.parametrize("d", [1, 7, 128, 255, 256, 300, 1024])
def test_lane_chunks_cover_every_column_once(d):
    """The kernel's layout of a row over a warp: lane l's chunk j holds
    the V floats from column (32·j + l)·V, with N = ceil(D / V / 32)
    chunks a lane (at most 8: D ≤ 1,024 in 16-byte chunks, ≤ 256 in
    4-byte ones).  Every column lies in exactly one chunk inside D."""
    for v in (4, 1):
        if v == 4 and d % 4:
            continue
        n = (d // v + 31) // 32
        if n > 8:
            continue
        cols = [(32 * j + lane) * v + e for j in range(n)
                for lane in range(32) for e in range(v)
                if (32 * j + lane) * v < d]
        assert sorted(cols) == list(range(d))


def test_cpu_fused_step_launches_no_kernel():
    import multiverso_tpu_torch as tmv
    from multiverso_tpu_torch.apps import SkipGram, synthetic_corpus

    if tmv.initialized():
        tmv.shutdown()
    tmv.config.reset()
    tmv.init(device="cpu")
    try:
        sg = SkipGram(200, 8, negatives=3)
        step, place = sg.make_fused_step()
        state = [*sg.table_in.raw_value(), *sg.table_out.raw_value()]
        corpus = synthetic_corpus(400, 200, seed=1)
        sgns.reset_launch_counts()
        for _, batch in zip(range(2), sg.batches(corpus, 16)):
            *state, loss = step(*state, *(place(a) for a in batch))
        assert sgns.launch_counts() == {"sgns": 0}
        assert np.isfinite(float(loss))
    finally:
        tmv.shutdown()
        tmv.config.reset()


def test_sgns_library_builds_alone(monkeypatch):
    """``load("sgns")`` builds its own library only; a flash library
    builds the three flash libraries together."""
    asked = []

    def build(names):
        asked.append(tuple(names))
        raise LookupError

    monkeypatch.setattr(_build, "build", build)
    for name in ("sgns", "flash_dq"):
        with pytest.raises(LookupError):
            _build.load(name)
    assert asked == [("sgns",), _build.FLASH]
    assert "sgns" in _build.SOURCES
