"""The port's GPipe over several processes against the sequential stack
and the JAX package's pipeline.

Four gloo ranks on the CPU (``torch_ranks.py``) build, in one launch,
the meshes (pp 4), (dp 2, pp 2), (pp 2, tp 2) and (sp 2, pp 2), and run
every case below; the JAX package runs in this process on sub-meshes of
its 8 CPU devices of the same shapes (``tests/test_pipeline.py``'s
checks).  ``gpipe`` is held against the stages run one after another in
this process, values and gradients (with and without ``remat_stages``),
atol 1e-5 as in the JAX tests; the transformer's pipelined forward and
three trainer steps against the JAX package's on the same mesh, rtol
1e-5 with a floor at 1e-5 of each tensor's largest entry; the bad
configs raise the JAX package's errors, word for word.  At the JAX
pipeline test's own width (``torch_ranks.PP_JAX_CFG``) the JAX package's
mesh trainer is itself farther than that from its trainer without a
mesh, so there the port is held to at most 1.5x the JAX package's own
spread.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ranks as R
from multiverso_tpu.models import transformer as jt
from multiverso_tpu_torch.models import transformer as pt

WORLD = 4
T = 16
MESHES = {"pp4": ([4], ["pp"]), "dppp": ([2, 2], ["dp", "pp"]),
          "pptp": ([2, 2], ["pp", "tp"]), "sppp": ([2, 2], ["sp", "pp"])}
GPIPES = [("pp4", 4, False), ("pp4", 3, False), ("dppp", 6, False),
          ("pp4", 3, True), ("dppp", 3, True)]
TRAINERS = [("dppp", "sgd"), ("pptp", "momentum")]
# Each bad config: (mesh, config changes, batch), refused by the JAX
# package's transformer_forward on the same mesh.
BAD = {"sp": ("sppp", {}, 4),
       "scan_layers": ("dppp", {"scan_layers": False}, 4),
       "microbatches": ("dppp", {}, 2),
       "tp": ("pptp", {"n_heads": 3, "dim": 48, "hidden": 66}, 4)}


def _gpipe_name(key, micro, remat):
    return f"gpipe_{key}_{micro}_{'remat' if remat else 'plain'}"


def _plan():
    cases = {key: [] for key in MESHES}
    for key, micro, remat in GPIPES:
        cases[key].append([_gpipe_name(key, micro, remat), "gpipe",
                           dict(micro=micro, remat=remat)])
    for key in ("dppp", "pptp"):
        cases[key].append([f"forward_{key}", "forward",
                           dict(T=T, seed=0, cfg="PP_CFG")])
    for key, updater in TRAINERS:
        cases[key].append([f"trainer_{key}", "trainer",
                           dict(updater=updater, T=T, cfg="PP_CFG")])
        cases[key].append([f"trainer_{key}_jax_width", "trainer",
                           dict(updater=updater, T=T, cfg="PP_JAX_CFG")])
    for name, (key, kw, batch) in BAD.items():
        cases[key].append([f"bad_{name}", "forward_error",
                           dict(cfg_kw={**R.PP_CFG, **kw}, batch=batch,
                                T=T)])
    return [dict(key=k, sizes=MESHES[k][0], names=MESHES[k][1],
                 cases=cases[k]) for k in MESHES]


@pytest.fixture(scope="module")
def read(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("pipeline_ranks"))
    R.launch(_plan(), out, WORLD)

    def get(name):
        res = R.results(out, name, WORLD)
        for r in res:
            assert "error" not in r or name.startswith("bad_"), \
                f"{name}: {r['error']}"
        return res

    return get


def _jmesh(key):
    sizes, names = MESHES[key]
    return jax.sharding.Mesh(
        np.asarray(jax.devices()[:WORLD]).reshape(sizes), tuple(names))


def _assert_scaled(got, want, rtol=1e-5):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    floor = rtol * float(np.max(np.abs(want)) or 1.0)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=floor)


@pytest.mark.parametrize("key,micro,remat", GPIPES)
def test_gpipe_matches_sequential(read, key, micro, remat):
    """Outputs on every stage, the loss, and every stage's weight
    gradients against the stages run one after another here."""
    res = read(_gpipe_name(key, micro, remat))
    pp = MESHES[key][0][MESHES[key][1].index("pp")]
    w, x, tgt = R.gpipe_inputs(pp, micro, 8, 2)
    w = torch.tensor(w, requires_grad=True)
    h = torch.tensor(x)
    for s in range(pp):
        h = R._mlp_stage(w[s], h)
    loss = ((h - torch.tensor(tgt)) ** 2).mean()
    (g,) = torch.autograd.grad(loss, [w])
    for r in res:
        np.testing.assert_allclose(r["out"], h.detach().numpy(), atol=1e-5)
        np.testing.assert_allclose(r["loss"], loss.detach().numpy(),
                                   atol=1e-5)
        np.testing.assert_allclose(r["grad"], g.numpy(), atol=1e-5)


def _jcfg(base=None, **kw):
    return jt.TransformerConfig(**{**(base or R.PP_CFG), **kw},
                                compute_dtype=jnp.float32)


def _jax_trained(cfg, mesh, updater):
    """(losses, params, state) of three JAX trainer steps, the trees
    unstacked into the port's loop format."""
    jtr = jt.TransformerTrainer(cfg, mesh, updater_type=updater, seed=5)
    toks = R.tokens(4, T, 1)
    losses = [float(jtr.train_step_async(toks)) for _ in range(3)]

    def unstack(tree):
        return {**tree, "layers": pt.unstack_layer_params(
            jax.tree_util.tree_map(np.asarray, tree["layers"]),
            cfg.n_layers)}

    return losses, unstack(jtr.params), unstack(jtr.state)


def _spread(got, want):
    """The least rtol at which ``got`` passes ``_assert_scaled`` against
    ``want`` (its floor at rtol times the largest entry): max |got -
    want| / (max |want| + |want|)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)
                        / (np.max(np.abs(want)) + np.abs(want))))


@pytest.mark.parametrize("key", ["dppp", "pptp"])
def test_transformer_pipeline_matches_jax(read, key):
    """The pipelined forward equals the JAX package's on the same mesh
    (which equals its local stack, tests/test_pipeline.py)."""
    res = read(f"forward_{key}")
    cfg = _jcfg()
    params = jax.tree_util.tree_map(jnp.asarray, jt.init_params(cfg, 0))
    want = jt.transformer_forward(params, jnp.asarray(R.tokens(4, T, 0)),
                                  cfg, mesh=_jmesh(key))
    for r in res:
        np.testing.assert_array_equal(r["logits"], res[0]["logits"])
    _assert_scaled(res[0]["logits"], want)


@pytest.mark.parametrize("key,updater", TRAINERS)
def test_pipeline_trainer_matches_jax(read, key, updater):
    """Three steps with stage-sharded stacked layers (and tp-sharded
    weights on pp x tp) against the JAX trainer on the same mesh: losses,
    every gathered parameter and updater slot."""
    res = read(f"trainer_{key}")
    losses, params, state = _jax_trained(_jcfg(), _jmesh(key), updater)
    np.testing.assert_allclose(res[0]["losses"], losses, rtol=1e-5)
    for i, want in enumerate(pt._leaves(params)):
        for r in res[1:]:
            np.testing.assert_array_equal(r[f"p{i}"], res[0][f"p{i}"])
        _assert_scaled(res[0][f"p{i}"], want)
    for i, slots in enumerate(pt._leaves(state)):
        for j, want in enumerate(slots):
            _assert_scaled(res[0][f"s{i}_{j}"], want)


@pytest.mark.parametrize("key,updater", TRAINERS)
def test_pipeline_trainer_at_jax_width_within_jax_spread(read, key,
                                                         updater):
    """At the JAX pipeline test's width (dim 32, 4 heads of 8) the JAX
    package's trainer on the mesh and its trainer without one (a mesh of
    one device, no pipeline) part by summation order alone: on (pp 2, tp
    2) with momentum the least rtol that holds one against the other is
    1.18e-5, past the rtol 1e-5 of the test above.  The port on the mesh
    is held against the JAX mesh trainer to at most 1.5x that spread,
    every parameter and updater slot, and its losses at rtol 1e-5."""
    res = read(f"trainer_{key}_jax_width")
    cfg = _jcfg(R.PP_JAX_CFG)
    losses, params, state = _jax_trained(cfg, _jmesh(key), updater)
    one = jax.sharding.Mesh(np.asarray(jax.devices()[:1]), ("dp",))
    _, params1, state1 = _jax_trained(cfg, one, updater)
    np.testing.assert_allclose(res[0]["losses"], losses, rtol=1e-5)
    want = pt._leaves(params) + [a for sl in pt._leaves(state) for a in sl]
    alone = (pt._leaves(params1)
             + [a for sl in pt._leaves(state1) for a in sl])
    n = len(pt._leaves(params))
    got = ([res[0][f"p{i}"] for i in range(n)]
           + [res[0][f"s{i}_{j}"] for i in range(n)
              for j in range(len(pt._leaves(state)[i]))])
    for i in range(n):
        for r in res[1:]:
            np.testing.assert_array_equal(r[f"p{i}"], res[0][f"p{i}"])
    jax_spread = max(_spread(a, b) for a, b in zip(want, alone))
    port_spread = max(_spread(a, b) for a, b in zip(got, want))
    assert jax_spread > 0.0
    assert port_spread <= 1.5 * jax_spread, (port_spread, jax_spread)


@pytest.mark.parametrize("name", list(BAD))
def test_pipeline_rejects_bad_configs_as_jax(read, name):
    key, kw, batch = BAD[name]
    cfg = _jcfg(**kw)
    params = jax.tree_util.tree_map(jnp.asarray, jt.init_params(cfg, 1))
    with pytest.raises(ValueError) as err:
        jt.transformer_forward(params, jnp.zeros((batch, T), jnp.int32),
                               cfg, mesh=_jmesh(key))
    for r in read(f"bad_{name}"):
        assert str(r["error"]) == str(err.value)
