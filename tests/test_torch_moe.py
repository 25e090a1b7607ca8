"""Parity of the port's MoE layer (``multiverso_tpu_torch/models/moe.py``)
with the JAX package's, on the CPU.

The same numpy-seeded weights and activations go through both packages
at a small size (dim 64, hidden 128, 4 experts, top-2, x [2, 64, 64]).
Tolerances: float32 rtol 1e-5 with a floor at 1e-5 of each tensor's
largest entry (sums taken in another order); the routing decisions, the
initial weights, the bucket sizes and the set of dropped routes exactly.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiverso_tpu_torch.models import moe as pm

jm = importlib.import_module("multiverso_tpu.models.moe")

DIM, HIDDEN, E, K = 64, 128, 4, 2
B, T = 2, 64


def _assert_scaled(got, want, rtol=1e-5):
    scale = float(np.max(np.abs(want))) or 1.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale)


def _params(seed=3):
    jp = jm.init_moe_params(DIM, HIDDEN, E, seed=seed)
    return jp, {k: torch.as_tensor(np.asarray(v)) for k, v in jp.items()}


def _x(seed=5):
    return np.random.RandomState(seed).randn(B, T, DIM).astype(np.float32)


def test_init_moe_params_bit_equal_and_capacity():
    jp = jm.init_moe_params(DIM, HIDDEN, E, seed=11)
    tp = pm.init_moe_params(DIM, HIDDEN, E, seed=11)
    assert set(tp) == set(jp)
    for key in jp:
        assert tp[key].dtype == torch.float32
        np.testing.assert_array_equal(tp[key].numpy(), jp[key])
    for n, e, k, cf in ((128, 4, 2, 1.25), (8192, 8, 2, 1.25),
                        (100, 8, 2, 0.3), (7, 8, 1, 1.0), (256, 8, 2, 4.0)):
        assert pm.moe_capacity(n, e, k, cf) == jm.moe_capacity(n, e, k, cf)
        assert pm.moe_capacity(n, e, k, cf) % 8 == 0


def test_routing_matches_jax():
    jp, tp = _params()
    x = _x()
    jprobs, jtop_p, jtop_idx, jaux = jm._routing(jp, jnp.asarray(x), K)
    probs, top_p, top_idx, aux = pm._routing(tp, torch.as_tensor(x), K)
    np.testing.assert_array_equal(top_idx.numpy(), np.asarray(jtop_idx))
    _assert_scaled(probs.numpy(), np.asarray(jprobs))
    _assert_scaled(top_p.numpy(), np.asarray(jtop_p))
    # sorted descending, renormalised
    assert (top_p[..., 0] >= top_p[..., 1]).all()
    np.testing.assert_allclose(top_p.sum(-1).numpy(), 1.0, rtol=1e-6)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)


@pytest.mark.parametrize("dispatch,cf", [("dense", 1.25),
                                         ("capacity", 1.25),
                                         ("capacity", 0.5)])
def test_moe_ffn_matches_jax(dispatch, cf):
    jp, tp = _params()
    x = _x()
    jout, jaux = jm.moe_ffn(jp, jnp.asarray(x), top_k=K,
                            compute_dtype=jnp.float32, dispatch=dispatch,
                            capacity_factor=cf)
    out, aux = pm.moe_ffn(tp, torch.as_tensor(x), top_k=K,
                          compute_dtype=torch.float32, dispatch=dispatch,
                          capacity_factor=cf)
    assert out.shape == (B, T, DIM) and out.dtype == torch.float32
    _assert_scaled(out.numpy(), np.asarray(jout))
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)


def test_capacity_equals_dense_at_ample_capacity():
    _, tp = _params()
    x = torch.as_tensor(_x())
    dense, aux_d = pm.moe_ffn(tp, x, top_k=K, dispatch="dense")
    cap, aux_c = pm.moe_ffn(tp, x, top_k=K, dispatch="capacity",
                            capacity_factor=E / K)
    _, _, top_idx, _ = pm._routing(tp, x, K)
    C = pm.moe_capacity(B * T, E, K, E / K)
    _, valid, _, _ = pm.capacity_plan(top_idx.reshape(-1), E, C)
    assert bool(valid.all())                    # nothing drops
    _assert_scaled(cap.numpy(), dense.numpy())
    assert float(aux_c) == float(aux_d)


def _jax_slots(top_idx, C):
    """The JAX package's slot assignment (``_moe_capacity_dispatch``,
    ``multiverso_tpu/models/moe.py:150-154``), on its own top_idx."""
    e_flat = top_idx.reshape(-1)
    onehot = jax.nn.one_hot(e_flat, E, dtype=jnp.int32)
    pos = jnp.sum(jnp.cumsum(onehot, axis=0) * onehot, axis=1) - 1
    valid = pos < C
    slot = jnp.where(valid, e_flat * C + jnp.minimum(pos, C - 1), E * C)
    return np.asarray(slot), np.asarray(valid)


@pytest.mark.parametrize("cf", [0.5, 1.0])
def test_overflow_drops_the_same_routes_as_jax(cf):
    jp, tp = _params()
    x = _x()
    _, _, jtop_idx, _ = jm._routing(jp, jnp.asarray(x), K)
    _, _, top_idx, _ = pm._routing(tp, torch.as_tensor(x), K)
    C = pm.moe_capacity(B * T, E, K, cf)
    jslot, jvalid = _jax_slots(jtop_idx, C)
    slot, valid, src, filled = pm.capacity_plan(top_idx.reshape(-1), E, C)
    assert not bool(valid.all())                # some routes overflow
    np.testing.assert_array_equal(valid.numpy(), jvalid)
    np.testing.assert_array_equal(slot.numpy(), jslot)
    # The inverse map: every kept route owns its slot, and only those.
    kept = np.flatnonzero(jvalid)
    assert int(filled.sum()) == len(kept)
    np.testing.assert_array_equal(src.numpy()[jslot[kept]], kept)
    assert len(set(jslot[kept].tolist())) == len(kept)


@pytest.mark.parametrize("dispatch,cf", [("dense", 1.25),
                                         ("capacity", 1.25),
                                         ("capacity", 0.5)])
def test_gradients_reach_every_routed_expert_and_match_jax(dispatch, cf):
    jp, tp = _params()
    x = _x()
    ct = np.random.RandomState(9).randn(B, T, DIM).astype(np.float32)

    def jloss(p, xx):
        out, aux = jm.moe_ffn(p, xx, top_k=K, compute_dtype=jnp.float32,
                              dispatch=dispatch, capacity_factor=cf)
        return jnp.sum(out * ct) + aux

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    leaves = {k: v.clone().requires_grad_() for k, v in tp.items()}
    xt = torch.as_tensor(x).requires_grad_()
    out, aux = pm.moe_ffn(leaves, xt, top_k=K, compute_dtype=torch.float32,
                          dispatch=dispatch, capacity_factor=cf)
    grads = torch.autograd.grad((out * torch.as_tensor(ct)).sum() + aux,
                                [*leaves.values(), xt])
    for (key, _), g in zip(leaves.items(), grads):
        _assert_scaled(g.numpy(), np.asarray(jgp[key]))
    _assert_scaled(grads[-1].numpy(), np.asarray(jgx))
    _, _, top_idx, _ = pm._routing(tp, torch.as_tensor(x), K)
    routed = set(top_idx.reshape(-1).tolist())
    assert routed == set(range(E))
    for e in routed:
        for key in ("w1", "w3", "w2"):
            assert float(dict(zip(leaves, grads))[key][e].abs().max()) > 0


def test_unknown_dispatch_raises_as_jax():
    jp, tp = _params()
    x = _x()
    with pytest.raises(ValueError, match="unknown moe dispatch 'gshard'") \
            as jerr:
        jm.moe_ffn(jp, jnp.asarray(x), dispatch="gshard")
    with pytest.raises(ValueError) as terr:
        pm.moe_ffn(tp, torch.as_tensor(x), dispatch="gshard")
    assert str(terr.value) == str(jerr.value)
