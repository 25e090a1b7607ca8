"""Parity of the PyTorch port's transformer with the JAX package.

Small configs (2 layers, dim 64, 2 heads of 32, T 64) so both sides run
in seconds on the CPU.  The JAX side runs on a one-device mesh; the port
runs with ``device="cpu"``, where attention takes the kernels' plain
versions.  The vocabulary is 16384, the smallest head that takes the
``_ce`` cross-entropy with its bf16 cotangent.

Tolerances: float32 rtol 1e-5 for logits, loss and gradients (with a
floor at 1e-5 of each tensor's largest entry); bfloat16 2e-2 for logits
and loss, and for gradients 3e-2 relative L2 per tensor plus an error
against float32 no more than 1.5x the JAX package's own (see the test);
three-step trainer trajectories rtol
1e-5 on the losses and 1e-4 on the final parameters (three updates
compound the float32 rounding of both sides).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from multiverso_tpu.models import transformer as jt
from multiverso_tpu_torch.models import transformer as pt
from multiverso_tpu_torch.updaters import AddOption

V, T, BATCH = 16384, 64, 2
SHAPE = dict(vocab_size=V, dim=64, n_layers=2, n_heads=2, hidden=128,
             max_seq=T)
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _mesh():
    return Mesh(np.asarray(jax.devices()[:1]), ("dp",))


def _cfgs(dtype="float32", **kw):
    return (jt.TransformerConfig(**SHAPE, compute_dtype=JDT[dtype], **kw),
            pt.TransformerConfig(**SHAPE, compute_dtype=TDT[dtype], **kw))


def _tokens(seed=0):
    return np.random.RandomState(seed).randint(
        0, V, size=(BATCH, T)).astype(np.int32)


def _jax_leaves(params):
    """The JAX tree's leaves in the port's fixed order."""
    out = [params["embed"], params["out_norm"], params["head"]]
    for lyr in params["layers"]:
        out.extend(lyr[key] for key in pt._LAYER_KEYS)
    return [np.asarray(a, np.float32) for a in out]


@pytest.mark.parametrize("scan", [False, True])
def test_params_from_jax_and_same_seed_init(scan):
    jcfg, pcfg = _cfgs(scan_layers=scan)
    host = jt.init_params(jcfg, seed=4)
    assert isinstance(host["layers"], dict) == scan
    got = pt.params_from_jax(host, pcfg, device="cpu")
    loop = host["layers"] if not scan else [
        {k: host["layers"][k][i] for k in host["layers"]}
        for i in range(jcfg.n_layers)]
    want = _jax_leaves({**host, "layers": loop})
    own = pt.init_params(pcfg, seed=4)
    for a, b, c in zip(pt._leaves(got), want, pt._leaves(own)):
        np.testing.assert_array_equal(a.numpy(), b)
        np.testing.assert_array_equal(c.numpy(), b)
    stacked = pt.stack_layer_params(got["layers"])
    np.testing.assert_array_equal(
        stacked["wq"].numpy(), np.stack([l["wq"] for l in loop]))


def _loss_and_grads(dtype):
    jcfg, pcfg = _cfgs(dtype)
    host = jt.init_params(jcfg, seed=1)
    tokens = _tokens(1)
    mesh = _mesh()
    jlogits = jax.jit(jt.transformer_forward, static_argnums=(2, 3))(
        host, jnp.asarray(tokens), jcfg, mesh)
    jloss, jgrads = jax.jit(jax.value_and_grad(jt.lm_loss),
                            static_argnums=(2, 3))(
        host, jnp.asarray(tokens), jcfg, mesh)
    params = pt.params_from_jax(host, pcfg, device="cpu")
    leaves = [p.requires_grad_() for p in pt._leaves(params)]
    params = pt._with_leaves(params, leaves)
    plogits = pt.transformer_forward(params, torch.as_tensor(tokens), pcfg)
    ploss = pt.lm_loss(params, torch.as_tensor(tokens), pcfg)
    pgrads = torch.autograd.grad(ploss, leaves)
    return ((np.asarray(jlogits.astype(jnp.float32)), float(jloss),
             _jax_leaves(jgrads)),
            (plogits.detach().float().numpy(), float(ploss.detach()),
             [g.numpy() for g in pgrads]))


def _assert_scaled(got, want, rtol):
    """|got - want| <= rtol·(|want| + max|want|): relative to each entry,
    with a floor at ``rtol`` of the tensor's own scale for entries near
    zero (sums taken in another order differ by that much there)."""
    scale = float(np.max(np.abs(want))) or 1.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale)


def test_forward_loss_grads_f32():
    (jl, jloss, jg), (pl, ploss, pg) = _loss_and_grads("float32")
    _assert_scaled(pl, jl, 1e-5)
    np.testing.assert_allclose(ploss, jloss, rtol=1e-5)
    assert len(pg) == len(jg)
    for a, b in zip(pg, jg):
        _assert_scaled(a, b, 1e-5)


def test_forward_loss_grads_bf16(monkeypatch):
    # Like for like: the JAX side runs its Pallas kernels (interpret
    # mode), which share the port's pre-scaled-q, float32-score math; its
    # default CPU path rounds the scores to bf16 before scaling them.
    monkeypatch.setenv("MVTPU_FORCE_FLASH", "1")
    (jl, jloss, jg), (pl, ploss, pg) = _loss_and_grads("bfloat16")
    _assert_scaled(pl, jl, 2e-2)
    np.testing.assert_allclose(ploss, jloss, rtol=2e-2)
    # Gradients per tensor in relative L2 norm: XLA's fusions and PyTorch
    # round the bf16 cotangents at different points, so single entries of
    # a summed gradient move by a few percent of the tensor's largest
    # entry.  Two checks: the port is within 3e-2 of the JAX package in
    # bf16, and against the float32 gradients the port's bf16 error is no
    # more than 1.5x the JAX package's own bf16 error.
    (_, _, f32), _ = _loss_and_grads("float32")

    def rel(a, b):
        return float(np.linalg.norm(a - b) / np.linalg.norm(b))

    for a, b, ref in zip(pg, jg, f32):
        assert rel(a, b) <= 3e-2, rel(a, b)
        assert rel(a, ref) <= 1.5 * rel(b, ref), (rel(a, ref), rel(b, ref))


def test_rms_norm_bf16_rounding_order():
    """Trap: variance in f32, x·rsqrt promoted to f32, cast back, then the
    bf16 gain — bit-identical to the JAX package."""
    rng = np.random.RandomState(2)
    x = rng.randn(3, 5, 64).astype(np.float32)
    g = (1 + 0.1 * rng.randn(64)).astype(np.float32)
    want = jt._rms_norm(jnp.asarray(x, jnp.bfloat16),
                        jnp.asarray(g, jnp.bfloat16), 1e-5)
    got = pt._rms_norm(torch.tensor(x).to(torch.bfloat16),
                       torch.tensor(g).to(torch.bfloat16), 1e-5)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope_half_split(dtype):
    """Trap: half-split rotation, theta**(-i/half), positions from 0,
    f32 math, result in the input dtype."""
    rng = np.random.RandomState(3)
    x = rng.randn(2, 2, 48, 32).astype(np.float32)
    want = jt._rope(jnp.asarray(x, JDT[dtype]), 10000.0)
    got = pt._rope(torch.tensor(x).to(TDT[dtype]), 10000.0)
    assert got.dtype == TDT[dtype]
    tol = 1e-6 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ce_gradient_in_logits_dtype(dtype):
    """Trap: the _ce cotangent is computed in f32 and cast to the LOGITS'
    dtype; the loss is over logits[:, :-1] against tokens[:, 1:]."""
    rng = np.random.RandomState(4)
    logits = rng.randn(2, 9, 40).astype(np.float32)
    tgt = rng.randint(40, size=(2, 9)).astype(np.int32)
    jlog = jnp.asarray(logits, JDT[dtype])
    jloss, jvjp = jax.vjp(lambda l: jt._ce(l, jnp.asarray(tgt)), jlog)
    (jg,) = jvjp(jnp.float32(1.0))
    tlog = torch.tensor(logits).to(TDT[dtype]).requires_grad_()
    tloss = pt._CE.apply(tlog, torch.as_tensor(tgt).long())
    (tg,) = torch.autograd.grad(tloss, tlog)
    assert tg.dtype == TDT[dtype]
    tol = 1e-6 if dtype == "float32" else 2e-3
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), rtol=1e-6)
    np.testing.assert_allclose(tg.float().numpy(),
                               np.asarray(jg.astype(jnp.float32)),
                               atol=tol)


@pytest.mark.parametrize("updater", ["sgd", "momentum"])
def test_trainer_three_step_trajectory(updater):
    """Trap: default option lr 0.1, gradients w.r.t. the f32 masters, the
    updater on every leaf (embed and norms included); int32 tokens."""
    jcfg, pcfg = _cfgs("float32")
    tokens = _tokens(2)
    jtr = jt.TransformerTrainer(jcfg, _mesh(), updater_type=updater, seed=5)
    ptr = pt.TransformerTrainer(pcfg, device="cpu", updater_type=updater,
                                seed=5)
    assert ptr.option == AddOption(learning_rate=0.1)
    start = [p.clone() for p in pt._leaves(ptr.params)]
    jl = [jtr.train_step(tokens) for _ in range(3)]
    pl = [ptr.train_step(tokens) for _ in range(3)]
    np.testing.assert_allclose(pl, jl, rtol=1e-5)
    assert pl[-1] < pl[0]
    for a, b, s in zip(pt._leaves(ptr.params), _jax_leaves(jtr.params),
                       start):
        _assert_scaled(a.numpy(), b, 1e-4)
        assert not torch.equal(a, s)   # every leaf moved, norms included
    if updater == "momentum":
        jstate = [np.asarray(s[0]) for s in _jax_state_leaves(jtr)]
        for (a,), b in zip(ptr.state, jstate):
            _assert_scaled(a.numpy(), b, 1e-4)


def _jax_state_leaves(jtr):
    st = jtr.state
    out = [st["embed"], st["out_norm"], st["head"]]
    for lyr in st["layers"]:
        out.extend(lyr[key] for key in pt._LAYER_KEYS)
    return out


def test_fused_steps_and_eval_loss():
    _, pcfg = _cfgs("float32")
    tokens = _tokens(3)
    a = pt.TransformerTrainer(pcfg, device="cpu", seed=6)
    b = pt.TransformerTrainer(pcfg, device="cpu", seed=6)
    last = a.train_steps_fused(tokens, 2)
    for _ in range(2):
        want = b.train_step_async(tokens)
    assert isinstance(last, torch.Tensor)
    assert float(last) == float(want)
    assert a.loss(tokens) == b.loss(tokens)


def test_unported_options_raise():
    _, pcfg = _cfgs("float32")
    for kw in (dict(num_experts=4), dict(pipeline_microbatches=2),
               dict(remat=True)):
        cfg = pt.TransformerConfig(**{**SHAPE, **kw})
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            pt.TransformerTrainer(cfg, device="cpu")
    tr = pt.TransformerTrainer(pcfg, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tr.train_step_async(_tokens(), accum=2)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tr.offload_state(None)


def test_scan_layers_accepted_as_a_loop():
    _, loop_cfg = _cfgs("float32")
    _, scan_cfg = _cfgs("float32", scan_layers=True)
    tokens = _tokens(4)
    a = pt.TransformerTrainer(loop_cfg, device="cpu", seed=7)
    b = pt.TransformerTrainer(scan_cfg, device="cpu", seed=7)
    assert a.train_step(tokens) == b.train_step(tokens)
