"""The port's mesh over several processes against the JAX package's mesh.

Four gloo ranks on the CPU (``torch_ranks.py``) build, in one launch, the
meshes (sp 4), (dp 2, sp 2), (sp 2, tp 2), (dp 2, tp 2), (ep 2, dp 2),
(ep 4) and (dp 2, pp 2) and run every case below on them (the trainer
under remat on (sp 2, tp 2) and (dp 2, sp 2) too; an MoE trainer's
checkpoints on (ep 2, dp 2) and (ep 4), and the refusals of MoE on a
mesh); the JAX package runs in this process on sub-meshes of its 8 CPU
devices of the same shapes.  The inputs come
from numpy seeds on both sides.  One more launch, of a single rank, holds
the mesh code with every axis of size 1 against the no-mesh trainer, bit
for bit (what the card's ``mesh`` phase holds over NCCL).

Tolerances, float32: ring attention atol 1e-5 against the JAX ring and
against single-device attention (values and gradients); the in-process
ring stand-in against the real ring atol 1e-6 (the gradients of a k/v
block are summed in another order); logits, losses, parameters and
updater state rtol 1e-5, with a floor at 1e-5 of each tensor's largest
entry; checkpoints exactly.  The config is the JAX tests' ``_CFG`` with 4
heads of 32 (``torch_ranks.CFG``).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ranks as R
from multiverso_tpu.models import transformer as jt
from multiverso_tpu_torch.models import transformer as pt

jring = __import__("importlib").import_module(
    "multiverso_tpu.parallel.ring_attention")

WORLD = 4
T_RING, T_MODEL = 64, 32
MESHES = {"sp4": ([4], ["sp"]), "dpsp": ([2, 2], ["dp", "sp"]),
          "sptp": ([2, 2], ["sp", "tp"]), "dptp": ([2, 2], ["dp", "tp"]),
          "epdp": ([2, 2], ["ep", "dp"]), "ep4": ([4], ["ep"]),
          "dppp": ([2, 2], ["dp", "pp"])}
RINGS = [("sp4", True, "contiguous"), ("sp4", True, "zigzag"),
         ("dpsp", True, "contiguous"), ("dpsp", True, "zigzag"),
         ("dpsp", False, "auto"), ("sptp", True, "auto")]
# (mesh, updater, accum, T): T 32 puts sp 2 in the zigzag layout, T 30
# (not a multiple of 2·sp) in the contiguous one.
TRAINERS = [("dpsp", "sgd", 1, 32), ("dpsp", "momentum", 1, 32),
            ("dptp", "sgd", 1, 32), ("dptp", "momentum", 1, 32),
            ("dptp", "sgd", 2, 32), ("dpsp", "sgd", 1, 30)]
FORWARDS = [("dpsp", 32), ("sptp", 32), ("dptp", 32)]
# (mesh, remat_policy): scan-format layers under remat, as the JAX
# package's test_scan_remat_trainer_sharded and the long-context config
# run them; the recompute re-runs the ring and the Megatron collectives.
REMATS = [(key, policy) for key in ("sptp", "dpsp")
          for policy in ("full", "dots")]
# (mesh, bucket elements): the gradient sum over (dp, sp) in one bucket,
# in several (a gradient larger than a bucket goes alone), and over dp
# alone where the mesh has no sp.
GRAD_SUMS = [("dpsp", 1 << 25), ("dpsp", 8), ("dptp", 8)]


def _ring_name(key, causal, layout):
    return f"ring_{key}_{'causal' if causal else 'full'}_{layout}"


def _trainer_name(key, updater, accum, T):
    return f"trainer_{key}_{updater}_{accum}_{T}"


def _jmesh(key):
    sizes, names = MESHES[key]
    return jax.sharding.Mesh(
        np.asarray(jax.devices()[:WORLD]).reshape(sizes), tuple(names))


def _jcfg(**kw):
    return jt.TransformerConfig(**R.CFG, compute_dtype=jnp.float32, **kw)


def _moe_jcfg(**kw):
    """The MoE checkpoint chain's config (``torch_ranks.MOE_CFG``,
    capacity dispatch whose routes overflow)."""
    return jt.TransformerConfig(**{**R.MOE_CFG, "moe_dispatch": "capacity",
                                   "capacity_factor": 1.0, **kw},
                                compute_dtype=jnp.float32)


def _pcfg(**kw):
    return pt.TransformerConfig(**{**R.CFG, **kw},
                                compute_dtype=torch.float32)


def _jax_runtime():
    import multiverso_tpu as jmv

    jmv.config.reset()
    if jmv.initialized():
        jmv.shutdown()
    jmv.init()
    return jmv


def _remat_kw(policy):
    return dict(remat=True, remat_policy=policy, scan_layers=True)


def _plan(snaps):
    cases = {key: [] for key in MESHES}
    for key, causal, layout in RINGS:
        cases[key].append([_ring_name(key, causal, layout), "ring",
                           dict(T=T_RING, seed=0, causal=causal,
                                layout=layout)])
    for layout in ("contiguous", "zigzag"):
        cases["sp4"].append([f"grads_{layout}", "ring_grads",
                             dict(T=T_RING, seed=3, layout=layout)])
    cases["dpsp"].append(["ring_errors", "ring_errors", dict(T=T_RING)])
    for key, T in FORWARDS:
        cases[key].append([f"forward_{key}_{T}", "forward",
                           dict(T=T, seed=0)])
    for key, updater, accum, T in TRAINERS:
        cases[key].append([_trainer_name(key, updater, accum, T), "trainer",
                           dict(updater=updater, accum=accum, T=T)])
    for key, policy in REMATS:
        cases[key].append([f"remat_{key}_{policy}", "trainer",
                           dict(updater="sgd", T=T_MODEL,
                                extra=_remat_kw(policy))])
    for src in ("port", "jax"):
        cases["sptp"].append([f"ckpt_from_{src}", "checkpoint",
                              dict(snap_in=snaps[src],
                                   snap_out=snaps[f"{src}_out"])])
    for key, bucket in GRAD_SUMS:
        cases[key].append([f"grad_sum_{key}_{bucket}", "grad_sum",
                           dict(seed=11, bucket=bucket)])
    cases["epdp"].append(["moe_ckpt_epdp", "moe_checkpoint",
                          dict(snap_in=snaps["moe_jax"],
                               snap_out=snaps["moe_epdp"])])
    cases["ep4"].append(["moe_ckpt_ep4", "moe_checkpoint",
                         dict(snap_in=snaps["moe_epdp"],
                              snap_out=snaps["moe_ep4"])])
    cases["epdp"].append(["refuse_accum", "moe_refusal",
                          dict(refusal="accum")])
    cases["dppp"].append(["refuse_pp", "moe_refusal", dict(refusal="pp")])
    return [dict(key=k, sizes=MESHES[k][0], names=MESHES[k][1],
                 cases=cases[k]) for k in MESHES]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The snapshots the checkpoint cases start from, then one launch of
    the four ranks; returns a reader of their results."""
    out = str(tmp_path_factory.mktemp("mesh_ranks"))
    snaps = {k: os.path.join(out, f"{k}.tree")
             for k in ("port", "jax", "port_out", "jax_out", "moe_jax",
                       "moe_epdp", "moe_ep4")}
    toks = R.tokens(4, T_MODEL, 6)
    writer = pt.TransformerTrainer(_pcfg(), device="cpu",
                                   updater_type="momentum", seed=7)
    for _ in range(3):
        writer.train_step(toks)
    writer.save(snaps["port"])
    jmv = _jax_runtime()
    try:
        jw = jt.TransformerTrainer(_jcfg(), _jmesh("dptp"),
                                   updater_type="momentum", seed=8)
        for _ in range(3):
            jw.train_step(toks)
        jw.save(snaps["jax"])
        jm = jt.TransformerTrainer(_moe_jcfg(), _jmesh("epdp"),
                                   updater_type="momentum", seed=8)
        for _ in range(3):
            jm.train_step(R.tokens(4, T_MODEL, 6, vocab=64))
        jm.save(snaps["moe_jax"])
    finally:
        jmv.shutdown()
        jmv.config.reset()
    R.launch(_plan(snaps), out, WORLD)

    def read(name):
        res = R.results(out, name, WORLD)
        for r in res:
            assert "error" not in r or name.startswith("refuse"), \
                f"{name}: {r['error']}"
        return res

    return read, snaps


def _assert_scaled(got, want, rtol=1e-5):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    floor = rtol * float(np.max(np.abs(want)) or 1.0)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=floor)


def _same_on_every_rank(res, key):
    for r in res[1:]:
        np.testing.assert_array_equal(r[key], res[0][key])


@pytest.mark.parametrize("key,causal,layout", RINGS)
def test_ring_attention_matches_jax(run, key, causal, layout):
    read, _ = run
    res = read(_ring_name(key, causal, layout))
    q, k, v, _, _ = R.qkv(T_RING, 0)
    want = jring.ring_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), _jmesh(key), causal=causal,
                                layout=layout)
    for r in res:
        np.testing.assert_allclose(r["o"], np.asarray(want), atol=1e-5)


def test_ring_errors_match_jax(run):
    read, _ = run
    got = read("ring_errors")[0]
    q = jnp.zeros((1, 1, T_RING, 32))
    for key, kw in (("zigzag_non_causal", dict(causal=False,
                                               layout="zigzag")),
                    ("unknown_layout", dict(layout="spiral"))):
        with pytest.raises(ValueError) as err:
            jring.ring_attention(q, q, q, _jmesh("dpsp"), **kw)
        assert str(got[key]) == str(err.value)


def _single_device_grads(seed):
    from multiverso_tpu_torch.ops.flash_attention import flash_attention

    q, k, v, do, dlse = (torch.tensor(a) for a in R.qkv(T_RING, seed))
    for t in (q, k, v):
        t.requires_grad_()
    o, lse = flash_attention(q, k, v, return_lse=True)
    grads = torch.autograd.grad((o * do).sum() + (lse * dlse).sum(),
                                (q, k, v))
    return dict(zip(("o", "lse", "dq", "dk", "dv"),
                    (t.detach().numpy() for t in (o, lse, *grads))))


@pytest.mark.parametrize("layout", ["contiguous", "zigzag"])
def test_ring_gradients_match_single_device(run, layout):
    """o, lse and the gradients of q, k and v through the sp 4 ring (a
    nonzero lse cotangent included) against single-device attention."""
    read, _ = run
    want = _single_device_grads(3)
    for r in read(f"grads_{layout}"):
        for key, w in want.items():
            np.testing.assert_allclose(r[key], w, atol=1e-5, err_msg=key)


@pytest.mark.parametrize("layout", ["contiguous", "zigzag"])
def test_in_process_ring_equals_gloo_ring(run, layout):
    """The stand-in that runs every rank's schedule in one process (the
    card's check of the ring's compute) gives what the real ring gives."""
    read, _ = run
    for r in read(f"grads_{layout}"):
        for key in ("o", "lse", "dq", "dk", "dv"):
            np.testing.assert_allclose(r["inproc_" + key], r[key],
                                       atol=1e-6, rtol=0, err_msg=key)


@pytest.mark.parametrize("key,bucket", GRAD_SUMS)
def test_grad_sum_over_the_product_of_axes(run, key, bucket):
    """Each rank's gradients summed over the ranks that share its other
    coordinates (row-major rank order), in place, dtypes kept."""
    read, _ = run
    res = read(f"grad_sum_{key}_{bucket}")
    names = MESHES[key][1]
    for rank, r in enumerate(res):
        peers = (range(WORLD) if "sp" in names
                 else [p for p in range(WORLD) if p % 2 == rank % 2])
        inputs = [R.grad_inputs(p, 11) for p in peers]
        for i, dt in enumerate(R.GRAD_DTYPES):
            want = sum(g[i] for g in inputs)
            assert r[f"g{i}"].dtype == np.dtype(dt)
            # The ranks' sum runs in another order: a few float32 ulps.
            floor = 1e-6 * float(np.max(np.abs(want)))
            np.testing.assert_allclose(r[f"g{i}"], want, rtol=1e-6,
                                       atol=floor)


@pytest.mark.parametrize("key,T", FORWARDS)
def test_forward_matches_jax_mesh(run, key, T):
    read, _ = run
    res = read(f"forward_{key}_{T}")
    cfg = _jcfg()
    params = jax.tree_util.tree_map(jnp.asarray, jt.init_params(cfg, 0))
    want = jt.transformer_forward(
        params, jnp.asarray(R.tokens(4, T, 0)), cfg, mesh=_jmesh(key))
    _same_on_every_rank(res, "logits")
    _assert_scaled(res[0]["logits"], want)


def _jax_tree(params, state):
    if isinstance(params["layers"], dict):       # scan format: unstack
        n = R.CFG["n_layers"]
        params, state = ({**tree, "layers": pt.unstack_layer_params(
            jax.tree_util.tree_map(np.asarray, tree["layers"]), n)}
            for tree in (params, state))
    leaves = [np.asarray(a) for a in pt._leaves(params)]
    slots = [tuple(np.asarray(s) for s in sl) for sl in pt._leaves(state)]
    return leaves, slots


def _assert_tree(res, leaves, slots, rtol=1e-5):
    for i, want in enumerate(leaves):
        _same_on_every_rank(res, f"p{i}")
        _assert_scaled(res[0][f"p{i}"], want, rtol)
    for i, sl in enumerate(slots):
        for j, want in enumerate(sl):
            _assert_scaled(res[0][f"s{i}_{j}"], want, rtol)


@pytest.mark.parametrize("key,updater,accum,T", TRAINERS)
def test_trainer_matches_jax_mesh(run, key, updater, accum, T):
    """Three steps (accum=2: two microbatches under dp 2) of the port's
    trainer on a mesh against the JAX trainer on the same mesh: losses,
    every gathered parameter and every updater slot."""
    read, _ = run
    res = read(_trainer_name(key, updater, accum, T))
    jtr = jt.TransformerTrainer(_jcfg(), _jmesh(key), updater_type=updater,
                                seed=5)
    toks = R.tokens(4, T, 1)
    losses = [float(jtr.train_step_async(toks, accum)) for _ in range(3)]
    np.testing.assert_allclose(res[0]["losses"], losses, rtol=1e-5)
    _assert_tree(res, *_jax_tree(jtr.params, jtr.state))


@pytest.mark.parametrize("key,policy", REMATS)
def test_remat_trainer_matches_jax_mesh(run, key, policy):
    """Three SGD steps under remat ("full" and "dots") on a mesh with sp
    against the JAX trainer with the same remat on the same mesh: every
    rank re-runs the ring's rotations and tp's all-reduces in the
    backward's recompute, in one order."""
    read, _ = run
    res = read(f"remat_{key}_{policy}")
    jtr = jt.TransformerTrainer(_jcfg(**_remat_kw(policy)), _jmesh(key),
                                updater_type="sgd", seed=5)
    toks = R.tokens(4, T_MODEL, 1)
    losses = [float(jtr.train_step_async(toks)) for _ in range(3)]
    np.testing.assert_allclose(res[0]["losses"], losses, rtol=1e-5)
    _assert_tree(res, *_jax_tree(jtr.params, jtr.state))


def _port_tree(res, prefix=""):
    r = res[0]
    n = sum(1 for k in r if k.startswith(prefix + "p"))
    leaves = [r[f"{prefix}p{i}"] for i in range(n)]
    slots = [tuple(r[f"{prefix}s{i}_{j}"] for j in range(100)
                   if f"{prefix}s{i}_{j}" in r) for i in range(n)]
    return leaves, slots


def test_checkpoint_crosses_meshes(run):
    """A snapshot of the port's trainer on one process (dp 1) restores
    exactly onto (sp 2, tp 2); the step taken there is saved, and the JAX
    trainer on (sp 2, tp 2) reads it exactly."""
    read, snaps = run
    res = read("ckpt_from_port")
    writer = pt.TransformerTrainer(_pcfg(), device="cpu",
                                   updater_type="momentum", seed=3)
    writer.restore(snaps["port"])
    want = [t.numpy() for t in pt._leaves(writer.params)]
    got, _ = _port_tree(res, "restored_")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    jmv = _jax_runtime()
    try:
        reader = jt.TransformerTrainer(_jcfg(), _jmesh("sptp"),
                                       updater_type="momentum", seed=4)
        reader.restore(snaps["port_out"])
        leaves, slots = _jax_tree(reader.params, reader.state)
    finally:
        jmv.shutdown()
        jmv.config.reset()
    got, got_slots = _port_tree(res)
    for g, w in zip(got, leaves):
        np.testing.assert_array_equal(g, w)
    for g, w in zip(got_slots, slots):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)


def test_checkpoint_from_jax_mesh(run):
    """The JAX trainer's snapshot from (dp 2, tp 2) restores exactly onto
    the port's (sp 2, tp 2), and training continues from it."""
    read, snaps = run
    res = read("ckpt_from_jax")
    jmv = _jax_runtime()
    try:
        jtr = jt.TransformerTrainer(_jcfg(), _jmesh("dptp"),
                                    updater_type="momentum", seed=4)
        jtr.restore(snaps["jax"])
        leaves, slots = _jax_tree(jtr.params, jtr.state)
        want_loss = jtr.train_step(R.tokens(4, T_MODEL, 6))
    finally:
        jmv.shutdown()
        jmv.config.reset()
    got, got_slots = _port_tree(res, "restored_")
    for g, w in zip(got, leaves):
        np.testing.assert_array_equal(g, w)
    for g, w in zip(got_slots, slots):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(float(res[0]["loss"]), want_loss, rtol=1e-5)


def _assert_trees_equal(got, want):
    for g, w in zip(got[0], want[0]):
        np.testing.assert_array_equal(g, w)
    for gs, ws in zip(got[1], want[1]):
        for g, w in zip(gs, ws):
            np.testing.assert_array_equal(g, w)


def test_moe_checkpoint_crosses_meshes_and_packages(run):
    """An MoE trainer's snapshot (experts split over ep): the JAX
    trainer's from its (ep 2, dp 2) mesh restores exactly onto the
    port's (ep 2, dp 2), where one step matches the JAX trainer's step
    from it; the snapshot saved there restores exactly onto the port's
    (ep 4); and the JAX trainer on (ep 4) reads that mesh's snapshot
    exactly."""
    read, snaps = run
    jmv = _jax_runtime()
    try:
        jtr = jt.TransformerTrainer(_moe_jcfg(), _jmesh("epdp"),
                                    updater_type="momentum", seed=4)
        jtr.restore(snaps["moe_jax"])
        from_jax = _jax_tree(jtr.params, jtr.state)
        want_loss = jtr.train_step(R.tokens(4, T_MODEL, 6, vocab=64))
        reader = jt.TransformerTrainer(_moe_jcfg(), _jmesh("ep4"),
                                       updater_type="momentum", seed=3)
        reader.restore(snaps["moe_ep4"])
        read_back = _jax_tree(reader.params, reader.state)
    finally:
        jmv.shutdown()
        jmv.config.reset()
    epdp, ep4 = read("moe_ckpt_epdp"), read("moe_ckpt_ep4")
    _assert_trees_equal(_port_tree(epdp, "restored_"), from_jax)
    np.testing.assert_allclose(float(epdp[0]["loss"]), want_loss, rtol=1e-5)
    _assert_trees_equal(_port_tree(ep4, "restored_"), _port_tree(epdp))
    _assert_trees_equal(read_back, _port_tree(ep4))


@pytest.mark.parametrize("refusal", ["pp", "accum"])
def test_moe_refusals_match_jax(run, refusal):
    """Where the JAX package refuses MoE on a mesh, the port refuses with
    its message: pipelined layers ((dp 2, pp 2), scan format, 2
    microbatches) and gradient accumulation ((ep 2, dp 2), accum 2).
    MoE and the ep axis themselves train (``test_torch_moe_mesh.py``)."""
    read, _ = run
    kw = dict(moe_dispatch="dense", capacity_factor=1.25)
    if refusal == "pp":
        kw.update(scan_layers=True, pipeline_microbatches=2)
    cfg = _moe_jcfg(**kw)
    toks = R.tokens(4, 16, 0, vocab=64)
    with pytest.raises(ValueError) as err:
        if refusal == "pp":
            params = jax.tree_util.tree_map(jnp.asarray,
                                            jt.init_params(cfg, 0))
            jt.transformer_forward(params, jnp.asarray(toks), cfg,
                                   mesh=_jmesh("dppp"))
        else:
            jt.TransformerTrainer(cfg, _jmesh("epdp")).train_step_async(
                toks, 2)
    for r in read(f"refuse_{refusal}"):
        assert str(r["error"]) == str(err.value)


@pytest.mark.parametrize("env,rank,count,want", [
    ({"LOCAL_RANK": "3"}, 7, 8, 3),
    ({}, 5, 4, 1),
    ({}, 2, 8, 2),
    ({"LOCAL_RANK": ""}, 9, 4, 1),
])
def test_rank_device_mapping(env, rank, count, want):
    """Each rank on its own card: LOCAL_RANK when set, else the rank
    modulo the node's cards."""
    from multiverso_tpu_torch.device import rank_device_index

    assert rank_device_index(rank, count, env) == want


def test_one_rank_mesh_is_the_no_mesh_trainer(tmp_path):
    """The mesh code at one rank (every axis of size 1) gives the no-mesh
    trainer's losses and parameters to the bit, vocabulary-parallel
    cross-entropy over tp included (vocab 16384 takes the fused ``_ce``):
    what the card's ``mesh`` phase holds at full width over NCCL."""
    extra = {"vocab_size": 16384}
    plan = [dict(key="one", sizes=[1, 1, 1], names=["dp", "sp", "tp"],
                 cases=[["one_rank", "trainer",
                         dict(updater="sgd", extra=extra)]])]
    R.launch(plan, str(tmp_path), 1)
    (got,) = R.results(str(tmp_path), "one_rank", 1)
    assert "error" not in got, got.get("error")
    # The ranks run one thread; so does this reference (the CPU's
    # reductions split their sums by the thread count).
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        tr = pt.TransformerTrainer(_pcfg(**extra), device="cpu", seed=5)
        toks = R.tokens(4, T_MODEL, 1)
        losses = [float(tr.train_step_async(toks)) for _ in range(3)]
    finally:
        torch.set_num_threads(threads)
    np.testing.assert_array_equal(got["losses"], losses)
    for i, a in enumerate(pt._leaves(tr.params)):
        np.testing.assert_array_equal(got[f"p{i}"], a.numpy())
