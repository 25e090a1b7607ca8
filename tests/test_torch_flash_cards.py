"""The flash kernels on one card at head dims outside their compiled set.

Marked ``card``: it needs a CUDA device and skips without one (the CPU
tests hold the padding it relies on: ``test_torch_flash_attention.py``'s
``test_zero_padded_head_dim_leaves_outputs_unchanged``).  On a machine
with a card, from the repository root::

    python -m pytest --noconftest tests/test_torch_flash_cards.py -q

(``--noconftest``: the repository's conftest imports JAX, which such a
machine need not have; this file imports none of it.)

The kernels are compiled for head dims 32, 64, 128 and 256.  A CUDA
tensor of head dim 16, 48 or 96 (and, in float32, 200: dq and dk/dv's
D 256 design) launches the kernels of the next one on zero-padded
operands; each output is held against the plain versions on
the same inputs (float32 atol 2e-5 for o and lse, 2e-4 for gradients;
bfloat16 2e-2, as ``test_torch_flash_attention.py`` states them), and
each kernel must have launched once.  Past 256 the wrapper raises.
Causal dk and dv at Tq < Tk are 0 on the k rows no query reaches, as the
plain version gives, and a float32 launch handed less plane scratch than
it splits into raises instead of writing past it.  The split alone
(``fa.plane_split``, which ``chip_smoke.py`` times) fills the scratch as
its plain version does, bit for bit.
"""

import numpy as np
import pytest
import torch

from multiverso_tpu_torch.ops import flash_attention as fa

pytestmark = [pytest.mark.card, pytest.mark.skipif(
    not torch.cuda.is_available(),
    reason="needs a CUDA device: the kernels run only on the card")]

TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
TOL = {"float32": (2e-5, 2e-4), "bfloat16": (2e-2, 2e-2)}


@pytest.mark.parametrize("d,dtype", [
    (d, dtype) for d in (16, 48, 96) for dtype in ("float32", "bfloat16")
] + [(200, "float32")])
def test_padded_head_dim_launches_the_kernels(d, dtype):
    rng = np.random.RandomState(80 + d)
    q, k, v, do = (torch.tensor(rng.randn(3, 200, d) * s, dtype=torch.float32)
                   .to(TDT[dtype]).cuda()
                   for s in (0.5, 0.5, 1.0, 1.0))
    scale = d ** -0.5
    o_ref, lse = fa.flash_fwd_ref(q, k, v, scale, True)
    delta = (do.float() * o_ref.float()).sum(-1)
    fa.reset_launch_counts()
    o, lse_k = fa.flash_fwd(q, k, v, scale, True)
    dq = fa.flash_dq(q, k, v, do, lse, delta, scale, True)
    dk, dv = fa.flash_dkv(q, k, v, do, lse, delta, scale, True)
    torch.cuda.synchronize()
    assert fa.launch_counts() == {"flash_fwd": 1, "flash_dq": 1,
                                  "flash_dkv": 1}
    want = [o_ref, lse,
            fa.flash_dq_ref(q, k, v, do, lse, delta, scale, True),
            *fa.flash_dkv_ref(q, k, v, do, lse, delta, scale, True)]
    for i, (g, w) in enumerate(zip([o, lse_k, dq, dk, dv], want)):
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_allclose(g.float().cpu().numpy(),
                                   w.float().cpu().numpy(),
                                   atol=TOL[dtype][i >= 2])


def test_head_dim_past_256_raises():
    q = torch.zeros(1, 16, 320, device="cuda")
    with pytest.raises(ValueError, match=r"\(32, 64, 128, 256\)"):
        fa.flash_fwd(q, q, q, 320 ** -0.5, True)


@pytest.mark.parametrize("d", [32, 64, 128, 256])
def test_causal_keys_past_the_queries_get_zero_gradients(d):
    rng = np.random.RandomState(90 + d)
    q, do = (torch.tensor(rng.randn(3, 40, d), dtype=torch.float32).cuda()
             for _ in range(2))
    k, v = (torch.tensor(rng.randn(3, 200, d), dtype=torch.float32).cuda()
            for _ in range(2))
    scale = d ** -0.5
    _, lse = fa.flash_fwd_ref(q, k, v, scale, True)
    delta = torch.randn(3, 40, device="cuda")
    dk, dv = fa.flash_dkv(q, k, v, do, lse, delta, scale, True)
    want = fa.flash_dkv_ref(q, k, v, do, lse, delta, scale, True)
    for g, w in zip((dk, dv), want):
        assert torch.equal(g[:, 40:], torch.zeros_like(g[:, 40:]))
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(),
                                   atol=2e-4)


@pytest.mark.parametrize("name,d", [
    (name, d) for name in ("flash_fwd", "flash_dq", "flash_dkv")
    for d in (32, 64, 128, 256) if d in fa._F32_PLANE_DIMS[name]])
def test_short_plane_scratch_raises(name, d, monkeypatch):
    q = torch.randn(2, 64, d, device="cuda")
    rows = torch.zeros(2, 64, device="cuda")
    planes = fa._planes

    def short(qs, k, kernel):
        return planes(qs, k, kernel)[1:]
    monkeypatch.setattr(fa, "_planes", short)
    call = {"flash_fwd": lambda: fa.flash_fwd(q, q, q, 1.0, True),
            "flash_dq": lambda: fa.flash_dq(q, q, q, q, rows, rows, 1.0,
                                            True),
            "flash_dkv": lambda: fa.flash_dkv(q, q, q, q, rows, rows, 1.0,
                                              True)}[name]
    with pytest.raises(RuntimeError, match="less scratch"):
        call()


@pytest.mark.parametrize("name,d", [
    (name, d) for name in ("flash_fwd", "flash_dq", "flash_dkv")
    for d in (32, 64, 128, 256)])
def test_plane_split_matches_its_plain_version(name, d):
    rng = np.random.RandomState(100 + d)
    qs, do = (torch.tensor(rng.randn(3, 130, d), dtype=torch.float32)
              for _ in range(2))
    k, v = (torch.tensor(rng.randn(3, 66, d), dtype=torch.float32)
            for _ in range(2))
    do = None if name == "flash_fwd" else do
    want = fa.plane_split(name, qs, k, v, do)
    got = fa.plane_split(name, qs.cuda(), k.cuda(), v.cuda(),
                         None if do is None else do.cuda())
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
