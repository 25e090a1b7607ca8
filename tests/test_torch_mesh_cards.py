"""The port's mesh over NCCL, one rank per card on four cards.

Marked ``card``: it needs four CUDA devices and skips without them (the
CPU tests hold the same cases over gloo against the JAX package:
``test_torch_mesh.py``, ``test_torch_pipeline.py``).  On a machine with
four cards, from the repository root::

    python -m pytest --noconftest tests/test_torch_mesh_cards.py -q

(``--noconftest``: the repository's conftest imports JAX, which such a
machine need not have; this file imports none of it.)

Four NCCL ranks (``torch_ranks.launch(..., backend="nccl")``) run, in one
launch, the ring on (sp 4) in both layouts with its gradients and the
in-process stand-in beside it, the forward and 3 trainer steps on (dp 2,
sp 2), (sp 2, tp 2) and (dp 2, tp 2), the trainer under remat ("full"
and "dots") on (sp 2, tp 2) and (dp 2, sp 2), GPipe on (pp 4) and the
pipelined transformer on (dp 2, pp 2) and (pp 2, tp 2), the
transformer at ``torch_ranks.KERNEL_CFG`` and ``PP_CFG`` (heads 32
wide, so the ranks' attention launches the kernels), and the MoE config
(``torch_ranks.MOE_KERNEL_CFG``, both dispatches, capacity factor 1.0,
where routes overflow) on (ep 4), (dp 2, ep 2), (sp 2, ep 2) and (tp 2,
ep 2): its forward logits and aux loss and 3 momentum steps.  Each is held
against the
same computation without a mesh on one card in this process (GPipe
against its stages run in turn on the CPU), float32: attention atol
1e-5, logits, losses and parameters rtol 1e-5 with a floor at 1e-5 of
each tensor's largest entry, as the CPU tests hold the port to the JAX
package.
"""

import numpy as np
import pytest
import torch

import torch_ranks as R

pytestmark = pytest.mark.card

WORLD = 4
T_RING, T_MODEL, T_PP = 64, 32, 16
MESHES = {"sp4": ([4], ["sp"]), "dpsp": ([2, 2], ["dp", "sp"]),
          "sptp": ([2, 2], ["sp", "tp"]), "dptp": ([2, 2], ["dp", "tp"]),
          "pp4": ([4], ["pp"]), "dppp": ([2, 2], ["dp", "pp"]),
          "pptp": ([2, 2], ["pp", "tp"]), "ep4": ([4], ["ep"]),
          "dpep": ([2, 2], ["dp", "ep"]), "spep": ([2, 2], ["sp", "ep"]),
          "tpep": ([2, 2], ["tp", "ep"])}
LAYOUTS = ["contiguous", "zigzag"]
# (mesh, config, updater, accum, T)
TRAINERS = [("dpsp", "KERNEL_CFG", "sgd", 1, T_MODEL),
            ("dpsp", "KERNEL_CFG", "momentum", 1, T_MODEL),
            ("sptp", "KERNEL_CFG", "momentum", 1, T_MODEL),
            ("dptp", "KERNEL_CFG", "sgd", 2, T_MODEL),
            ("dppp", "PP_CFG", "sgd", 1, T_PP),
            ("pptp", "PP_CFG", "momentum", 1, T_PP)]
FORWARDS = [("dpsp", "KERNEL_CFG", T_MODEL),
            ("sptp", "KERNEL_CFG", T_MODEL),
            ("dptp", "KERNEL_CFG", T_MODEL), ("dppp", "PP_CFG", T_PP),
            ("pptp", "PP_CFG", T_PP)]
GPIPES = [("pp4", 4, False), ("pp4", 3, True)]
# (mesh, dispatch): the MoE config at capacity factor MOE_CF.
MOES = [(key, dispatch) for key in ("ep4", "dpep", "spep", "tpep")
        for dispatch in ("dense", "capacity")]
MOE_CF = 1.0
# (mesh, remat_policy), scan-format layers: the recompute re-runs the
# ring's rotations and tp's all-reduces.
REMATS = [(key, policy) for key in ("sptp", "dpsp")
          for policy in ("full", "dots")]


def _remat_kw(policy):
    return dict(remat=True, remat_policy=policy, scan_layers=True)


def _trainer_name(key, cfg, updater, accum, T):
    return f"trainer_{key}_{cfg}_{updater}_{accum}_{T}"


def _plan():
    cases = {key: [] for key in MESHES}
    for layout in LAYOUTS:
        cases["sp4"].append([f"grads_{layout}", "ring_grads",
                             dict(T=T_RING, seed=3, layout=layout)])
    for key, cfg, T in FORWARDS:
        cases[key].append([f"forward_{key}", "forward",
                           dict(T=T, seed=0, cfg=cfg)])
    for key, cfg, updater, accum, T in TRAINERS:
        cases[key].append([_trainer_name(key, cfg, updater, accum, T),
                           "trainer", dict(updater=updater, accum=accum,
                                           T=T, cfg=cfg)])
    for key, policy in REMATS:
        cases[key].append([f"remat_{key}_{policy}", "trainer",
                           dict(updater="sgd", T=T_MODEL,
                                cfg="KERNEL_CFG",
                                extra=_remat_kw(policy))])
    for key, micro, remat in GPIPES:
        cases[key].append([f"gpipe_{micro}_{remat}", "gpipe",
                           dict(micro=micro, remat=remat)])
    for key, dispatch in MOES:
        cases[key].append([f"moe_{key}_{dispatch}", "moe",
                           dict(dispatch=dispatch, cf=MOE_CF, T=T_MODEL,
                                cfg="MOE_KERNEL_CFG")])
    return [dict(key=k, sizes=MESHES[k][0], names=MESHES[k][1],
                 cases=cases[k]) for k in MESHES]


@pytest.fixture(scope="module")
def read(tmp_path_factory):
    if torch.cuda.device_count() < WORLD:
        pytest.skip(f"needs {WORLD} CUDA devices, has "
                    f"{torch.cuda.device_count()}")
    out = str(tmp_path_factory.mktemp("mesh_cards"))
    R.launch(_plan(), out, WORLD, backend="nccl")

    def get(name):
        res = R.results(out, name, WORLD)
        for r in res:
            assert "error" not in r, f"{name}: {r['error']}"
        return res

    return get


def _cfg(name, **kw):
    from multiverso_tpu_torch.models import TransformerConfig

    return TransformerConfig(**{**getattr(R, name), **kw},
                             compute_dtype=torch.float32)


def _assert_scaled(got, want, rtol=1e-5):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    floor = rtol * float(np.max(np.abs(want)) or 1.0)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=floor)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_ring_over_nccl_matches_one_card(read, layout):
    """o, lse and the q/k/v gradients of the sp 4 ring, each rank on its
    card, against flash attention on one card; and the in-process
    stand-in against the real ring."""
    from multiverso_tpu_torch.ops.flash_attention import flash_attention

    q, k, v, do, dlse = (torch.tensor(a, device="cuda:0")
                         for a in R.qkv(T_RING, 3))
    for t in (q, k, v):
        t.requires_grad_()
    o, lse = flash_attention(q, k, v, return_lse=True)
    grads = torch.autograd.grad((o * do).sum() + (lse * dlse).sum(),
                                (q, k, v))
    want = dict(zip(("o", "lse", "dq", "dk", "dv"),
                    (t.detach().cpu().numpy() for t in (o, lse, *grads))))
    for r in read(f"grads_{layout}"):
        for key, w in want.items():
            np.testing.assert_allclose(r[key], w, atol=1e-5, err_msg=key)
            np.testing.assert_allclose(r["inproc_" + key], r[key],
                                       atol=1e-6, rtol=0, err_msg=key)


@pytest.mark.parametrize("key,cfg,T", FORWARDS)
def test_forward_over_nccl_matches_one_card(read, key, cfg, T):
    from multiverso_tpu_torch.models import init_params
    from multiverso_tpu_torch.models.transformer import (params_from_jax,
                                                         transformer_forward)

    c = _cfg(cfg, pipeline_microbatches=0)
    params = params_from_jax(init_params(c, seed=0), c, "cuda:0")
    want = transformer_forward(
        params, torch.tensor(R.tokens(4, T, 0), device="cuda:0"), c)
    res = read(f"forward_{key}")
    for r in res:
        np.testing.assert_array_equal(r["logits"], res[0]["logits"])
    _assert_scaled(res[0]["logits"], want.detach().cpu().numpy())


@pytest.mark.parametrize("key,cfg,updater,accum,T", TRAINERS)
def test_trainer_over_nccl_matches_one_card(read, key, cfg, updater,
                                            accum, T):
    """Three steps on the mesh against three steps of the trainer without
    a mesh on one card: losses, every gathered parameter and updater
    slot, the same on every rank."""
    _hold_trainer(read(_trainer_name(key, cfg, updater, accum, T)),
                  _cfg(cfg, pipeline_microbatches=0), updater, accum, T)


@pytest.mark.parametrize("key,policy", REMATS)
def test_remat_trainer_over_nccl_matches_one_card(read, key, policy):
    """Three SGD steps under remat on a mesh with sp against the same
    remat without a mesh on one card."""
    _hold_trainer(read(f"remat_{key}_{policy}"),
                  _cfg("KERNEL_CFG", **_remat_kw(policy)), "sgd", 1,
                  T_MODEL)


def _hold_trainer(res, cfg, updater, accum, T):
    from multiverso_tpu_torch.models import TransformerTrainer
    from multiverso_tpu_torch.models.transformer import _leaves

    tr = TransformerTrainer(cfg, device="cuda:0", updater_type=updater,
                            seed=5)
    toks = R.tokens(4, T, 1)
    losses = [float(tr.train_step_async(toks, accum)) for _ in range(3)]
    np.testing.assert_allclose(res[0]["losses"], losses, rtol=1e-5)
    for i, p in enumerate(_leaves(tr.params)):
        for r in res[1:]:
            np.testing.assert_array_equal(r[f"p{i}"], res[0][f"p{i}"])
        _assert_scaled(res[0][f"p{i}"], p.cpu().numpy())
    for i, slots in enumerate(tr.state):
        for j, s in enumerate(slots):
            _assert_scaled(res[0][f"s{i}_{j}"], s.cpu().numpy())


@pytest.mark.parametrize("key,micro,remat", GPIPES)
def test_gpipe_over_nccl_matches_sequential(read, key, micro, remat):
    pp = MESHES[key][0][MESHES[key][1].index("pp")]
    w, x, tgt = R.gpipe_inputs(pp, micro, 8, 2)
    w = torch.tensor(w, requires_grad=True)
    h = torch.tensor(x)
    for s in range(pp):
        h = R._mlp_stage(w[s], h)
    loss = ((h - torch.tensor(tgt)) ** 2).mean()
    (g,) = torch.autograd.grad(loss, [w])
    for r in read(f"gpipe_{micro}_{remat}"):
        np.testing.assert_allclose(r["out"], h.detach().numpy(), atol=1e-5)
        np.testing.assert_allclose(r["grad"], g.numpy(), atol=1e-5)


@pytest.mark.parametrize("key,dispatch", MOES)
def test_moe_over_nccl_matches_one_card(read, key, dispatch):
    """The MoE config's forward (logits, aux) and three momentum steps
    (losses, every gathered parameter and slot) on the mesh against the
    same without a mesh on one card; the capacity runs drop routes."""
    from multiverso_tpu_torch.models import TransformerTrainer, init_params
    from multiverso_tpu_torch.models.transformer import (_leaves,
                                                         params_from_jax,
                                                         transformer_forward)

    res = read(f"moe_{key}_{dispatch}")
    c = _cfg("MOE_KERNEL_CFG", moe_dispatch=dispatch, capacity_factor=MOE_CF)
    toks = R.tokens(4, T_MODEL, 1, vocab=c.vocab_size)
    params = params_from_jax(init_params(c, seed=0), c, "cuda:0")
    logits, aux = transformer_forward(params, torch.tensor(
        toks, device="cuda:0"), c, return_aux=True)
    for r in res[1:]:
        np.testing.assert_array_equal(r["logits"], res[0]["logits"])
    _assert_scaled(res[0]["logits"], logits.detach().cpu().numpy())
    np.testing.assert_allclose(float(res[0]["aux"]), float(aux), rtol=1e-5)
    if dispatch == "capacity":
        assert int(res[0]["dropped"]) > 0
    tr = TransformerTrainer(c, device="cuda:0", updater_type="momentum",
                            seed=5)
    losses = [float(tr.train_step_async(toks)) for _ in range(3)]
    np.testing.assert_allclose(res[0]["losses"], losses, rtol=1e-5)
    for i, p in enumerate(_leaves(tr.params)):
        _assert_scaled(res[0][f"p{i}"], p.cpu().numpy())
    for i, slots in enumerate(tr.state):
        for j, s in enumerate(slots):
            _assert_scaled(res[0][f"s{i}_{j}"], s.cpu().numpy())
