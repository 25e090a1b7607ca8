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


def _loop(tree, cfg):
    """A JAX tree in loop format (scan-format layers unstacked)."""
    if isinstance(tree["layers"], dict):
        return {**tree, "layers": pt.unstack_layer_params(
            jax.tree_util.tree_map(np.asarray, tree["layers"]),
            cfg.n_layers)}
    return tree


def _jax_leaves(params, cfg=None):
    """The JAX tree's leaves in the port's fixed order."""
    if cfg is not None:
        params = _loop(params, cfg)
    return [np.asarray(a, np.float32) for a in pt._leaves(params)]


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


def _loss_and_grads(dtype, **kw):
    """((logits, loss, grads, aux) of the JAX package, the same of the
    port) from one seed's weights and tokens."""
    jcfg, pcfg = _cfgs(dtype, **kw)
    host = jt.init_params(jcfg, seed=1)
    tokens = _tokens(1)
    mesh = _mesh()
    jlogits, jaux = jax.jit(
        lambda p, t: jt.transformer_forward(p, t, jcfg, mesh,
                                            return_aux=True))(
        host, jnp.asarray(tokens))
    jloss, jgrads = jax.jit(jax.value_and_grad(jt.lm_loss),
                            static_argnums=(2, 3))(
        host, jnp.asarray(tokens), jcfg, mesh)
    params = pt.params_from_jax(host, pcfg, device="cpu")
    leaves = [p.requires_grad_() for p in pt._leaves(params)]
    params = pt._with_leaves(params, leaves)
    plogits, paux = pt.transformer_forward(params, torch.as_tensor(tokens),
                                           pcfg, return_aux=True)
    ploss = pt.lm_loss(params, torch.as_tensor(tokens), pcfg)
    pgrads = torch.autograd.grad(ploss, leaves)
    return ((np.asarray(jlogits.astype(jnp.float32)), float(jloss),
             _jax_leaves(jgrads, jcfg), float(jaux)),
            (plogits.detach().float().numpy(), float(ploss.detach()),
             [g.numpy() for g in pgrads], float(paux.detach())))


def _assert_scaled(got, want, rtol):
    """|got - want| <= rtol·(|want| + max|want|): relative to each entry,
    with a floor at ``rtol`` of the tensor's own scale for entries near
    zero (sums taken in another order differ by that much there)."""
    scale = float(np.max(np.abs(want))) or 1.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale)


def test_forward_loss_grads_f32():
    (jl, jloss, jg, _), (pl, ploss, pg, _) = _loss_and_grads("float32")
    _assert_scaled(pl, jl, 1e-5)
    np.testing.assert_allclose(ploss, jloss, rtol=1e-5)
    assert len(pg) == len(jg)
    for a, b in zip(pg, jg):
        _assert_scaled(a, b, 1e-5)


# The JAX tests' own config (tests/test_transformer.py's _CFG): 4 heads
# of 16, a head dim outside the kernels' compiled set, which the port's
# attention runs through the plain versions.
JAX_TESTS_CFG = dict(vocab_size=128, dim=64, n_layers=2, n_heads=4,
                     hidden=128, max_seq=64)


def test_jax_tests_config_head_dim_16_matches_jax():
    jcfg = jt.TransformerConfig(**JAX_TESTS_CFG, compute_dtype=jnp.float32)
    pcfg = pt.TransformerConfig(**JAX_TESTS_CFG, compute_dtype=torch.float32)
    assert pcfg.dim // pcfg.n_heads == 16
    host = jt.init_params(jcfg, seed=1)
    tokens = np.random.RandomState(1).randint(
        0, 128, size=(4, 32)).astype(np.int32)
    mesh = _mesh()
    jlogits = jt.transformer_forward(host, jnp.asarray(tokens), jcfg, mesh)
    jloss, jgrads = jax.value_and_grad(jt.lm_loss)(
        host, jnp.asarray(tokens), jcfg, mesh)
    params = pt.params_from_jax(host, pcfg, device="cpu")
    leaves = [p.requires_grad_() for p in pt._leaves(params)]
    params = pt._with_leaves(params, leaves)
    plogits = pt.transformer_forward(params, torch.as_tensor(tokens), pcfg)
    ploss = pt.lm_loss(params, torch.as_tensor(tokens), pcfg)
    pgrads = torch.autograd.grad(ploss, leaves)
    _assert_scaled(plogits.detach().numpy(), np.asarray(jlogits), 1e-5)
    np.testing.assert_allclose(float(ploss.detach()), float(jloss),
                               rtol=1e-5)
    jg = _jax_leaves(jgrads, jcfg)
    assert len(pgrads) == len(jg)
    for a, b in zip(pgrads, jg):
        _assert_scaled(a.numpy(), b, 1e-5)
    # Three trainer steps from one seed: the loss trajectories.
    jtr = jt.TransformerTrainer(jcfg, mesh, updater_type="sgd", seed=5)
    ptr = pt.TransformerTrainer(pcfg, device="cpu", updater_type="sgd",
                                seed=5)
    jl = [jtr.train_step(tokens) for _ in range(3)]
    pl = [ptr.train_step(tokens) for _ in range(3)]
    np.testing.assert_allclose(pl, jl, rtol=1e-5)
    assert pl[-1] < pl[0]


def test_forward_loss_grads_bf16(monkeypatch):
    # Like for like: the JAX side runs its Pallas kernels (interpret
    # mode), which share the port's pre-scaled-q, float32-score math; its
    # default CPU path rounds the scores to bf16 before scaling them.
    monkeypatch.setenv("MVTPU_FORCE_FLASH", "1")
    (jl, jloss, jg, _), (pl, ploss, pg, _) = _loss_and_grads("bfloat16")
    _assert_scaled(pl, jl, 2e-2)
    np.testing.assert_allclose(ploss, jloss, rtol=2e-2)
    # Gradients per tensor in relative L2 norm: XLA's fusions and PyTorch
    # round the bf16 cotangents at different points, so single entries of
    # a summed gradient move by a few percent of the tensor's largest
    # entry.  Two checks: the port is within 3e-2 of the JAX package in
    # bf16, and against the float32 gradients the port's bf16 error is no
    # more than 1.5x the JAX package's own bf16 error.
    (_, _, f32, _), _ = _loss_and_grads("float32")

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
    tloss = pt._ce(tlog, torch.as_tensor(tgt).long())
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
    return pt._leaves(jtr.state)


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
    # Pipelining is ported (tests/test_torch_pipeline.py): without a pp
    # axis the config trains as the local stack, as the JAX trainer does.
    _, cfg = _cfgs("float32", pipeline_microbatches=2)
    tokens = _tokens(8)
    piped = pt.TransformerTrainer(cfg, device="cpu", seed=8)
    local = pt.TransformerTrainer(pcfg, device="cpu", seed=8)
    assert piped.train_step(tokens) == local.train_step(tokens)
    # State offload is ported with both stores
    # (tests/test_torch_offload.py); the native store needs a runtime,
    # as in the JAX package.
    from multiverso_tpu_torch.parallel.offload import OffloadedState

    tr = pt.TransformerTrainer(pcfg, device="cpu", updater_type="momentum")
    with pytest.raises(ValueError,
                       match="backend='native' needs a NativeRuntime"):
        tr.offload_state(OffloadedState(None, tr.offload_size()))


def test_scan_layers_accepted_as_a_loop():
    _, loop_cfg = _cfgs("float32")
    _, scan_cfg = _cfgs("float32", scan_layers=True)
    tokens = _tokens(4)
    a = pt.TransformerTrainer(loop_cfg, device="cpu", seed=7)
    b = pt.TransformerTrainer(scan_cfg, device="cpu", seed=7)
    assert a.train_step(tokens) == b.train_step(tokens)


# ------------------------------------------------------- mixture of experts

MOE = dict(num_experts=4, top_k=2, aux_loss_coef=0.01)


@pytest.mark.parametrize("scan", [False, True])
def test_moe_init_order_matches_jax(scan):
    """Trap: per layer wq, wk, wv, wo, then ONE randint seeding the
    experts (no w1/w3/w2 draws), and embed and head after the layers."""
    jcfg, pcfg = _cfgs(scan_layers=scan, **MOE)
    host = jt.init_params(jcfg, seed=4)
    own = pt.init_params(pcfg, seed=4)
    got = pt.params_from_jax(host, pcfg, device="cpu")
    assert set(own["layers"][0]) == set(pt._ATTN_KEYS) | {"moe"}
    assert own["layers"][0]["moe"]["w1"].shape == (4, 64, 128)
    want = _jax_leaves(host, jcfg)
    for a, b, c in zip(pt._leaves(got), want, pt._leaves(own)):
        np.testing.assert_array_equal(a.numpy(), b)
        np.testing.assert_array_equal(c.numpy(), b)
    assert len(pt._leaves(own)) == len(want) == 3 + 2 * 10


@pytest.mark.parametrize("dispatch", ["dense", "capacity"])
def test_moe_forward_aux_loss_grads_f32(dispatch):
    (jl, jloss, jg, jaux), (pl, ploss, pg, paux) = _loss_and_grads(
        "float32", moe_dispatch=dispatch, **MOE)
    _assert_scaled(pl, jl, 1e-5)
    assert paux > 0
    np.testing.assert_allclose(paux, jaux, rtol=1e-5)
    np.testing.assert_allclose(ploss, jloss, rtol=1e-5)
    assert len(pg) == len(jg)
    for a, b in zip(pg, jg):
        _assert_scaled(a, b, 1e-5)


# ------------------------------------------------------------------- remat

def _count_forward_launches(monkeypatch):
    """Count the flash forward's runs through the dispatcher op (on the
    CPU the op runs the plain version; on the card it is the launch)."""
    from multiverso_tpu_torch.ops import flash_attention as fa

    calls = {"fwd": 0}
    plain = fa._fwd

    def counted(*args):
        calls["fwd"] += 1
        return plain(*args)

    monkeypatch.setattr(fa, "_fwd", counted)
    return calls


@pytest.mark.parametrize("policy,moe", [("full", False), ("dots", False),
                                        ("full", True), ("dots", True)])
def test_remat_equals_no_remat_and_jax(monkeypatch, policy, moe):
    """Remat reschedules the backward and changes no number: exactly the
    no-remat step on the CPU, and within 1e-5 of the JAX package's remat.
    "dots" keeps the flash forward's (o, lse), so the forward runs once
    per layer and step; "full" runs it again in the backward."""
    extra = dict(MOE, moe_dispatch="capacity") if moe else {}
    jcfg, pcfg = _cfgs("float32", remat=True, remat_policy=policy, **extra)
    _, base_cfg = _cfgs("float32", **extra)
    tokens = _tokens(5)
    calls = _count_forward_launches(monkeypatch)
    base = pt.TransformerTrainer(base_cfg, device="cpu", seed=8)
    base_losses = [base.train_step(tokens) for _ in range(2)]
    assert calls["fwd"] == 2 * 2
    calls["fwd"] = 0
    tr = pt.TransformerTrainer(pcfg, device="cpu", seed=8)
    losses = [tr.train_step(tokens) for _ in range(2)]
    assert calls["fwd"] == (1 if policy == "dots" else 2) * 2 * 2
    assert losses == base_losses
    for a, b in zip(pt._leaves(tr.params), pt._leaves(base.params)):
        assert torch.equal(a, b)
    jtr = jt.TransformerTrainer(jcfg, _mesh(), seed=8)
    jl = [jtr.train_step(tokens) for _ in range(2)]
    np.testing.assert_allclose(losses, jl, rtol=1e-5)
    for a, b in zip(pt._leaves(tr.params), _jax_leaves(jtr.params)):
        _assert_scaled(a.numpy(), b, 1e-4)


# ---------------------------------------------------- gradient accumulation

@pytest.mark.parametrize("updater", ["sgd", "momentum"])
def test_accum_equals_full_batch_and_jax(updater):
    """accum=2 is the full-batch step: the f32 gradients of two equal
    microbatches summed and halved, the loss their mean."""
    jcfg, pcfg = _cfgs("float32")
    tokens = _tokens(6)
    full = pt.TransformerTrainer(pcfg, device="cpu", updater_type=updater,
                                 seed=9)
    acc = pt.TransformerTrainer(pcfg, device="cpu", updater_type=updater,
                                seed=9)
    jtr = jt.TransformerTrainer(jcfg, _mesh(), updater_type=updater, seed=9)
    want = [full.train_step(tokens) for _ in range(3)]
    got = [float(acc.train_step_async(tokens, accum=2)) for _ in range(3)]
    jl = [float(jtr.train_step_async(tokens, accum=2)) for _ in range(3)]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    np.testing.assert_allclose(got, jl, rtol=1e-5)
    assert got[-1] < got[0]
    for a, b, c in zip(pt._leaves(acc.params), pt._leaves(full.params),
                       _jax_leaves(jtr.params)):
        _assert_scaled(a.numpy(), b.numpy(), 1e-4)
        _assert_scaled(a.numpy(), c, 1e-4)


def _raised(fn):
    with pytest.raises(ValueError) as err:
        fn()
    return str(err.value)


@pytest.mark.parametrize("case", ["moe_accum", "batch_accum",
                                  "remat_policy", "moe_dispatch"])
def test_bad_options_raise_as_jax(case):
    kw, accum = {
        "moe_accum": (MOE, 2),
        "batch_accum": ({}, 3),
        "remat_policy": (dict(remat=True, remat_policy="everything"), 1),
        "moe_dispatch": (dict(MOE, moe_dispatch="gshard"), 1),
    }[case]
    jcfg, pcfg = _cfgs("float32", **kw)
    tokens = _tokens(7)
    jtr = jt.TransformerTrainer(jcfg, _mesh())
    ptr = pt.TransformerTrainer(pcfg, device="cpu")
    want = _raised(lambda: jtr.train_step_async(tokens, accum=accum))
    assert _raised(lambda: ptr.train_step_async(tokens, accum=accum)) == want
