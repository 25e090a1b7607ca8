"""The port's MoE layer and the ``ep`` axis on a mesh of several processes
against the JAX package's mesh.

Four gloo ranks on the CPU (``torch_ranks.py``) build, in one launch, the
meshes (dp 2, ep 2), (ep 4), (sp 2, ep 2), (tp 2, ep 2) and (dp 2, sp 2)
and run, for each dispatch, the MoE config of ``tests/test_moe.py``
(``torch_ranks.MOE_CFG``: 4 experts, top-2): the forward's logits and
load-balancing loss, then three momentum trainer steps (losses, every
gathered parameter and updater slot).  The capacity dispatch runs at
capacity factor 1.0, where routes overflow their buckets, and (sp 2, ep
2) runs in both ring layouts (T 32 zigzag, T 30 contiguous).  The JAX
package runs the same config on sub-meshes of its 8 CPU devices of the
same shapes, float32, and the port is held to it at rtol 1e-5 with a
floor at 1e-5 of each tensor's largest entry.  A planted per-rank slot
order (each rank planning the buckets from its own routes) must fail
that comparison.  (``test_torch_mesh.py`` holds MoE checkpoints across
meshes and packages, and the refusals.)  A second launch, of eight
ranks, runs the JAX package's own
expert-parallel test (``test_transformer_moe_capacity_trains_on_ep_
mesh``: dp x sp x tp x ep = 1 x 2 x 2 x 2, scan and remat, capacity
factor 2.0) against it.
"""

from concurrent.futures import ProcessPoolExecutor
from multiprocessing import get_context

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_ranks as R
from multiverso_tpu.models import transformer as jt
from multiverso_tpu_torch.models import transformer as pt

WORLD = 4
MESHES = {"dpep": ([2, 2], ["dp", "ep"]), "ep4": ([4], ["ep"]),
          "spep": ([2, 2], ["sp", "ep"]), "tpep": ([2, 2], ["tp", "ep"]),
          "dpsp": ([2, 2], ["dp", "sp"])}
# (mesh, dispatch, T): T 32 puts sp 2 in the zigzag layout, T 30 (not a
# multiple of 2·sp) in the contiguous one.
RUNS = [(key, dispatch, T) for dispatch in ("dense", "capacity")
        for key, T in (("ep4", 32), ("dpep", 32), ("spep", 32),
                       ("spep", 30), ("tpep", 32), ("dpsp", 32))]
CF = 1.0            # capacity factor: routes overflow their buckets
# The JAX package's test_transformer_moe_capacity_trains_on_ep_mesh.
MESH8 = ([1, 2, 2, 2], ["dp", "sp", "tp", "ep"])
EXTRA8 = dict(scan_layers=True, remat=True)
CF8 = 2.0


def _name(key, dispatch, T):
    return f"moe_{key}_{dispatch}_{T}"


def _moe_kw(dispatch, cf, **extra):
    return dict(R.MOE_CFG, moe_dispatch=dispatch, capacity_factor=cf,
                **extra)


def _jcfg(**kw):
    return jt.TransformerConfig(**kw, compute_dtype=jnp.float32)


def _jmesh(sizes, names):
    n = int(np.prod(sizes))
    return jax.sharding.Mesh(np.asarray(jax.devices()[:n]).reshape(sizes),
                             tuple(names))


def _plan():
    cases = {key: [] for key in MESHES}
    for key, dispatch, T in RUNS:
        cases[key].append([_name(key, dispatch, T), "moe",
                           dict(dispatch=dispatch, cf=CF, T=T)])
    cases["dpep"].append(["fault_local_slots", "moe",
                          dict(dispatch="capacity", cf=CF,
                               fault="local_slots")])
    return [dict(key=k, sizes=MESHES[k][0], names=MESHES[k][1],
                 cases=cases[k]) for k in MESHES]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """One launch of the four ranks, with the JAX references computed
    meanwhile; returns a reader of the ranks' results and the
    references."""
    out = str(tmp_path_factory.mktemp("moe_mesh_ranks"))
    # The JAX references compile in three processes of their own while
    # the ranks run.
    with ProcessPoolExecutor(3, mp_context=get_context("spawn")) as pool:
        refs = {(key, dispatch, T): pool.submit(
            _jax_run, _moe_kw(dispatch, CF), MESHES[key], T)
            for key, dispatch, T in RUNS}
        refs["mesh8"] = pool.submit(
            _jax_run, _moe_kw("capacity", CF8, **EXTRA8), MESH8, 32)
        R.launch(_plan(), out, WORLD)
        refs = {k: f.result() for k, f in refs.items()}

    def read(name):
        res = R.results(out, name, WORLD)
        for r in res:
            assert "error" not in r, f"{name}: {r['error']}"
        return res

    return read, refs


def _assert_scaled(got, want, rtol=1e-5):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    floor = rtol * float(np.max(np.abs(want)) or 1.0)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=floor)


def _jax_tree(params, state, n_layers):
    if isinstance(params["layers"], dict):       # scan format: unstack
        params, state = ({**tree, "layers": pt.unstack_layer_params(
            jax.tree_util.tree_map(np.asarray, tree["layers"]), n_layers)}
            for tree in (params, state))
    leaves = [np.asarray(a) for a in pt._leaves(params)]
    slots = [tuple(np.asarray(s) for s in sl) for sl in pt._leaves(state)]
    return leaves, slots


def _jax_run(kw, mesh, T, batch=4, steps=3):
    """The JAX package's forward (logits, aux) and ``steps`` momentum
    trainer steps on ``mesh`` (its ``(sizes, names)``), from the draws
    the ranks use."""
    mesh = _jmesh(*mesh)
    cfg = _jcfg(**kw)
    toks = R.tokens(batch, T, 1, vocab=cfg.vocab_size)
    params = jax.tree_util.tree_map(jnp.asarray, jt.init_params(cfg, 0))
    logits, aux = jax.jit(lambda p, t: jt.transformer_forward(
        p, t, cfg, mesh=mesh, return_aux=True))(params, jnp.asarray(toks))
    tr = jt.TransformerTrainer(cfg, mesh, updater_type="momentum", seed=5)
    losses = [float(tr.train_step_async(toks)) for _ in range(steps)]
    return (np.asarray(logits), float(aux), losses,
            *_jax_tree(tr.params, tr.state, cfg.n_layers))


def _mismatches(r, want):
    """The names of the port's outputs in ``r`` (rank 0's) that miss the
    JAX package's ``want`` at rtol 1e-5 (with its floor)."""
    logits, aux, losses, leaves, slots = want
    pairs = [("logits", r["logits"], logits), ("aux", r["aux"], aux),
             ("losses", r["losses"], losses)]
    pairs += [(f"p{i}", r[f"p{i}"], w) for i, w in enumerate(leaves)]
    pairs += [(f"s{i}_{j}", r[f"s{i}_{j}"], w)
              for i, sl in enumerate(slots) for j, w in enumerate(sl)]
    bad = []
    for name, got, w in pairs:
        try:
            _assert_scaled(got, w)
        except AssertionError:
            bad.append(name)
    return bad


def _same_on_every_rank(res):
    for key in res[0]:
        for r in res[1:]:
            np.testing.assert_array_equal(r[key], res[0][key], err_msg=key)


@pytest.mark.parametrize("key,dispatch,T", RUNS)
def test_moe_matches_jax_mesh(run, key, dispatch, T):
    """The forward's global logits and aux loss, and three trainer steps'
    losses, gathered parameters and updater slots, against the JAX
    package on the same mesh; every rank holds the same gathered tree.
    The capacity runs drop routes (capacity factor 1.0)."""
    read, refs = run
    res = read(_name(key, dispatch, T))
    _same_on_every_rank(res)
    want = refs[key, dispatch, T]
    assert _mismatches(res[0], want) == []
    if dispatch == "capacity":
        assert int(res[0]["dropped"]) > 0


def test_per_rank_slot_order_fails(run):
    """The planted fault: each rank plans the capacity buckets from its
    own routes (a per-rank slot order) on (dp 2, ep 2).  Other routes
    drop than the JAX package's global order drops, and the comparison
    that passes above fails."""
    read, refs = run
    res = read("fault_local_slots")
    good = read(_name("dpep", "capacity", 32))
    want = refs["dpep", "capacity", 32]
    assert _mismatches(good[0], want) == []
    assert int(res[0]["dropped"]) != int(good[0]["dropped"])
    assert "logits" in _mismatches(res[0], want)


def test_eight_ranks_match_jax_ep_mesh(run, tmp_path):
    """The JAX package's full 4-axis expert-parallel test: dp x sp x tp x
    ep = 1 x 2 x 2 x 2, scan format under full remat, capacity factor
    2.0, on eight gloo ranks against the JAX package's 8-device mesh:
    forward, aux and three momentum steps at rtol 1e-5."""
    out = str(tmp_path)
    plan = [dict(key="mesh8", sizes=MESH8[0], names=MESH8[1], cases=[
        ["moe8", "moe", dict(dispatch="capacity", cf=CF8, extra=EXTRA8)]])]
    R.launch(plan, out, 8)
    res = R.results(out, "moe8", 8)
    assert "error" not in res[0], res[0].get("error")
    _same_on_every_rank(res)
    want = run[1]["mesh8"]
    assert _mismatches(res[0], want) == []


def test_grad_sum_hands_nccl_dense_tensors(monkeypatch):
    """An MoE expert's gradient comes out of the einsum's backward with
    permuted strides; NCCL refuses such a tensor (gloo takes it), so
    ``all_reduce_grads`` hands every all-reduce a dense tensor and writes
    the sum back into the gradient, alone in its bucket or flattened
    with others."""
    import torch
    import torch.distributed as dist

    from multiverso_tpu_torch.parallel import collectives

    class OneAxis:
        def __contains__(self, axis):
            return axis == "dp"

        def group_over(self, axes):
            return None

    seen = []

    def twice(t, group=None):           # the sum over two equal ranks
        seen.append(t.is_contiguous())
        t.mul_(2)

    monkeypatch.setattr(dist, "all_reduce", twice)
    monkeypatch.setattr(collectives, "BUCKET_ELEMENTS", 16)
    strided = torch.arange(40.).reshape(5, 8).t()       # alone: 40 > 16
    small = [torch.arange(6.).reshape(2, 3).t(), torch.ones(3)]
    want = [2 * strided.clone()] + [2 * g.clone() for g in small]
    collectives.all_reduce_grads([strided] + small, OneAxis(), ("dp",))
    assert seen and all(seen)
    for got, w in zip([strided] + small, want):
        torch.testing.assert_close(got, w)


def test_moe_pspecs_and_shardings_match_jax():
    """The experts split their leading dimension over ep where the mesh
    has one, as the JAX package's ``moe_pspecs`` place them; the router
    stays whole.  ``moe_shardings`` cuts a rank's block."""
    import importlib

    import torch

    from multiverso_tpu_torch.models import moe as pm

    jm = importlib.import_module("multiverso_tpu.models.moe")

    class EpMesh:                      # rank 1 of an (ep 2) mesh
        def __contains__(self, axis):
            return axis == "ep"

        def size(self, axis):
            return 2 if axis == "ep" else 1

        def index(self, axis):
            return 1 if axis == "ep" else 0

    for names, mesh in ((("dp", "ep"), EpMesh()), (("dp",), None)):
        jspecs = jm.moe_pspecs(_jmesh([1] * len(names), names))
        for key, spec in pm.moe_pspecs(mesh).items():
            want = tuple(jspecs[key])
            got = [None] * len(want)
            if spec is not None:
                got[spec[0]] = spec[1]
            assert tuple(got) == want, key
    params = pm.init_moe_params(8, 16, 4, seed=0)
    cut = pm.moe_shardings(params, EpMesh())
    torch.testing.assert_close(cut["router"], params["router"])
    for key in ("w1", "w3", "w2"):
        torch.testing.assert_close(cut[key], params[key][2:])
