"""Ranks of the port's mesh tests: gloo processes on the CPU.

``launch(plan, out_dir, world)`` starts ``world`` processes of this file
under a hard timeout (killed on expiry, so a hang fails the test instead
of the suite).  Each rank joins one gloo process group, then for each
``{"sizes", "names", "cases"}`` of the plan builds that mesh (every rank builds
every mesh, in order) and runs its cases.  A case is ``(name, fn, kw)``:
``CASES[fn](mesh, **kw)`` returns a dict of arrays (or strings), written
to ``<out_dir>/<name>_r<rank>.npz``; an exception is written as its
message under ``"error"``.  ``results(out_dir, name, world)`` reads them
back, one dict per rank.

Every case draws its inputs from numpy seeds, so the test process can
hand the same inputs to the JAX package and to single-device attention.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 240

# The JAX tests' _CFG (tests/test_transformer.py): 4 heads of 16, a head
# dim outside the flash kernels' compiled set, so attention takes the
# plain versions on either device.
CFG = dict(vocab_size=128, dim=64, n_layers=2, n_heads=4, hidden=128,
           max_seq=64)
# CFG with heads 32 wide, a head dim the kernels take: the four-card
# tests run it, so the ranks' attention launches the kernels.
KERNEL_CFG = dict(CFG, dim=128)
# The pipeline tests' config (tests/test_pipeline.py) with heads 32 wide,
# as KERNEL_CFG: 4 layers, scan format, 2 microbatches.  The trainers are
# held to the JAX package at rtol 1e-5 at this width.
PP_CFG = dict(vocab_size=128, dim=128, n_layers=4, n_heads=4, hidden=128,
              max_seq=32, scan_layers=True, pipeline_microbatches=2)
# The JAX pipeline test's own width (dim 32, 4 heads of 8, hidden 64).
# There the JAX package's (pp 2, tp 2) momentum trainer differs from its
# own trainer without a mesh by more than rtol 1e-5 (summation order:
# tp's all-reduce and the pipeline's sums), so the port is held to at
# most 1.5x that spread (``test_torch_pipeline.py``).
PP_JAX_CFG = dict(PP_CFG, dim=32, hidden=64)
# tests/test_moe.py's _MOE_CFG: 4 experts, top-2, 4 heads of 8.
MOE_CFG = dict(vocab_size=64, dim=32, n_layers=2, n_heads=4, hidden=64,
               max_seq=32, num_experts=4, top_k=2)
# MOE_CFG with heads 32 wide, for the four-card tests (kernel head dims).
MOE_KERNEL_CFG = dict(MOE_CFG, dim=128)
ATTN = dict(B=2, H=4, D=32)


def qkv(T, seed, B=ATTN["B"], H=ATTN["H"], D=ATTN["D"]):
    """(q, k, v, do, dlse) float32 numpy arrays."""
    rng = np.random.RandomState(seed)
    x = [(rng.randn(B, H, T, D) * 0.5).astype(np.float32) for _ in range(4)]
    return (*x, rng.randn(B, H, T).astype(np.float32))


def tokens(batch, T, seed, vocab=128):
    return np.random.RandomState(seed).randint(
        vocab, size=(batch, T)).astype(np.int32)


def launch(plan, out_dir, world, backend="gloo"):
    """Run ``plan`` on ``world`` ranks; returns nothing, raises
    ``AssertionError`` with the failing rank's log.  ``backend="nccl"``
    puts each rank on its own card (``cuda:<rank>``)."""
    import pytest

    os.makedirs(out_dir, exist_ok=True)
    spec = os.path.join(out_dir, "plan.json")
    with open(spec, "w") as f:
        json.dump(plan, f)
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1")
    store = os.path.join(out_dir, "store")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(r), str(world),
         store, out_dir, spec, backend],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=out_dir) for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT_S)[0])
    except subprocess.TimeoutExpired:
        logs = []
        for p in procs:
            p.kill()
            logs.append(p.communicate()[0])
        pytest.fail(f"ranks did not finish within {TIMEOUT_S} s; rank 0 "
                    f"wrote:\n{logs[0][-4000:]}")
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log[-4000:]}"


def results(out_dir, name, world):
    out = []
    for r in range(world):
        with np.load(os.path.join(out_dir, f"{name}_r{r}.npz")) as z:
            out.append({k: z[k] for k in z.files})
    return out


# ------------------------------------------------------------ rank side
DEVICE = "cpu"      # the rank's device: "cpu" under gloo, its card under nccl


def _t(a):
    import torch

    return torch.as_tensor(np.asarray(a)).to(DEVICE)


def _np(t):
    return t.detach().cpu().numpy()


def _cfg(kw, dtype="float32"):
    import torch

    from multiverso_tpu_torch.models import TransformerConfig

    return TransformerConfig(**kw, compute_dtype=getattr(torch, dtype))


def case_ring(mesh, T, seed, causal=True, layout="auto"):
    from multiverso_tpu_torch.parallel import ring_attention

    q, k, v, _, _ = qkv(T, seed)
    o = ring_attention(_t(q), _t(k), _t(v), mesh, causal=causal,
                       layout=layout)
    return {"o": _np(o)}


def case_ring_errors(mesh, T):
    from multiverso_tpu_torch.parallel import ring_attention

    q = _t(np.zeros((1, 1, T, 32), np.float32))
    out = {}
    for key, kw in (("zigzag_non_causal", dict(causal=False,
                                               layout="zigzag")),
                    ("unknown_layout", dict(layout="spiral"))):
        try:
            ring_attention(q, q, q, mesh, **kw)
            out[key] = "no error"
        except ValueError as exc:
            out[key] = str(exc)
    return out


def case_ring_grads(mesh, T, seed, layout):
    """One rank's ring (sp only) through the real rotation and through
    the in-process stand-in, each with its gradients; every output in
    global order."""
    import torch

    from multiverso_tpu_torch.parallel import (InProcessRing,
                                               ring_attention_shard,
                                               sequence_positions)
    from multiverso_tpu_torch.parallel.collectives import ring_rotate
    from multiverso_tpu_torch.parallel.ring_attention import _use_zigzag
    from multiverso_tpu_torch.parallel.sharding import gather_full

    sp, idx = mesh.size("sp"), mesh.index("sp")
    zigzag = _use_zigzag(T, sp, True, layout)
    xs = [_t(a) for a in qkv(T, seed)]
    pos = [sequence_positions(T, sp, r, zigzag, DEVICE) for r in range(sp)]

    def blocks(a, r):
        return a.index_select(2, pos[r]).clone().requires_grad_()

    def unperm(parts, dim=2):
        allpos = torch.cat(pos)
        cat = torch.cat(parts, dim)
        return torch.empty_like(cat).index_copy_(dim, allpos, cat)

    # The real ring: this rank's shard.
    q, k, v = (blocks(a, idx) for a in xs[:3])
    do, dlse = (a.index_select(2, pos[idx]) for a in xs[3:])
    o, lse = ring_attention_shard(q, k, v, idx, sp, ring_rotate(mesh),
                                  True, None, zigzag)
    ((o * do).sum() + (lse * dlse).sum()).backward()
    got = {n: gather_full(t.detach(), 2, "sp", mesh) for n, t in
           (("o", o), ("lse", lse), ("dq", q.grad), ("dk", k.grad),
            ("dv", v.grad))}
    out = {n: _np(unperm(list(t.chunk(sp, 2)))) for n, t in got.items()}
    # The stand-in: every rank's schedule here, on the same blocks.
    qs, ks, vs = ([blocks(a, r) for r in range(sp)] for a in xs[:3])
    runs = InProcessRing(ks, vs).run(qs, True, None, zigzag)
    loss = sum((o * xs[3].index_select(2, pos[r])).sum()
               + (lse * xs[4].index_select(2, pos[r])).sum()
               for r, (o, lse) in enumerate(runs))
    loss.backward()
    for n, parts in (("o", [r[0].detach() for r in runs]),
                     ("lse", [r[1].detach() for r in runs]),
                     ("dq", [t.grad for t in qs]),
                     ("dk", [t.grad for t in ks]),
                     ("dv", [t.grad for t in vs])):
        out["inproc_" + n] = _np(unperm(parts))
    return out


def case_forward(mesh, T, seed, batch=4, cfg="CFG", extra=None):
    from multiverso_tpu_torch.models import init_params
    from multiverso_tpu_torch.models.transformer import (params_from_jax,
                                                         transformer_forward)

    cfg = _cfg({**globals()[cfg], **(extra or {})})
    params = params_from_jax(init_params(cfg, seed=0), cfg, DEVICE, mesh)
    logits = transformer_forward(params, _t(tokens(batch, T, seed)), cfg,
                                 mesh)
    return {"logits": _np(logits)}


def _full(tr):
    from multiverso_tpu_torch.models.transformer import _leaves

    tree = tr._full_tree()
    out = {f"p{i}": _np(a)
           for i, a in enumerate(_leaves(tree["params"]))}
    for i, slots in enumerate(_leaves(tree["state"])):
        for j, a in enumerate(slots):
            out[f"s{i}_{j}"] = _np(a)
    return out


def case_trainer(mesh, updater, steps=3, accum=1, batch=4, T=32, seed=1,
                 cfg="CFG", extra=None):
    from multiverso_tpu_torch.models import TransformerTrainer

    tr = TransformerTrainer(_cfg({**globals()[cfg], **(extra or {})}),
                            device=DEVICE,
                            updater_type=updater, seed=5, mesh=mesh)
    toks = tokens(batch, T, seed)
    losses = [float(tr.train_step_async(toks, accum)) for _ in range(steps)]
    return {"losses": np.asarray(losses), **_full(tr)}


def case_checkpoint(mesh, snap_in, snap_out, T=32, seed=6):
    """Restore a snapshot written on another mesh, report the gathered
    tree, take one step and save on this mesh."""
    from multiverso_tpu_torch.models import TransformerTrainer

    tr = TransformerTrainer(_cfg(CFG), device=DEVICE,
                            updater_type="momentum", seed=9, mesh=mesh)
    tr.restore(snap_in)
    out = {f"restored_{k}": v for k, v in _full(tr).items()}
    out["loss"] = np.asarray(tr.train_step(tokens(4, T, seed)))
    tr.save(snap_out)
    out.update(_full(tr))
    return out


def case_moe_refusal(mesh, refusal):
    """The message of the port's refusal of an MoE trainer on this mesh,
    as the JAX package refuses it: ``"pp"`` (MoE with pipelined layers)
    or ``"accum"`` (gradient accumulation with MoE)."""
    from multiverso_tpu_torch.models import TransformerTrainer

    kw = dict(MOE_CFG, scan_layers=True, pipeline_microbatches=2) \
        if refusal == "pp" else MOE_CFG
    try:
        tr = TransformerTrainer(_cfg(kw), device=DEVICE, mesh=mesh)
        loss = tr.train_step_async(tokens(4, 16, 0, vocab=64),
                                   2 if refusal == "accum" else 1)
        return {"error": "no error", "loss": _np(loss)}
    except ValueError as exc:
        return {"error": str(exc)}


def case_moe(mesh, dispatch, cf=1.25, T=32, batch=4, steps=3, seed=1,
             updater="momentum", cfg="MOE_CFG", extra=None, fault=None):
    """An MoE config on this mesh: the forward's global logits and aux
    loss (with the routes the capacity plans dropped), then ``steps``
    trainer steps from the same draw (losses, the gathered tree); with
    ``fault``, one of ``chip_smoke.planted_moe_fault``'s planted."""
    from multiverso_tpu_torch.models import TransformerTrainer, init_params
    from multiverso_tpu_torch.models.transformer import (params_from_jax,
                                                         transformer_forward)

    from chip_smoke import dropped_routes, planted_moe_fault
    from multiverso_tpu_torch.models import moe

    kw = {**globals()[cfg], "moe_dispatch": dispatch,
          "capacity_factor": cf, **(extra or {})}
    config = _cfg(kw)
    toks = tokens(batch, T, seed, vocab=config.vocab_size)
    out = {}
    with planted_moe_fault(fault):
        params = params_from_jax(init_params(config, seed=0), config, DEVICE,
                                 mesh)
        (logits, aux), dropped = dropped_routes(
            moe, lambda: transformer_forward(params, _t(toks), config, mesh,
                                             return_aux=True))
        out.update(logits=_np(logits), aux=_np(aux),
                   dropped=np.asarray(sum(dropped)))
        tr = TransformerTrainer(config, device=DEVICE, updater_type=updater,
                                seed=5, mesh=mesh)
        out["losses"] = np.asarray([float(tr.train_step_async(toks))
                                    for _ in range(steps)])
    out.update(_full(tr))
    return out


def case_moe_checkpoint(mesh, snap_in, snap_out, T=32, seed=6):
    """An MoE trainer restores a snapshot written on another mesh (or by
    the JAX package), reports the gathered tree, takes one step and
    saves on this mesh."""
    import torch.distributed as dist

    from multiverso_tpu_torch.models import TransformerTrainer

    dist.barrier()          # the snapshot's writer has finished
    cfg = _cfg(dict(MOE_CFG, moe_dispatch="capacity", capacity_factor=1.0))
    tr = TransformerTrainer(cfg, device=DEVICE, updater_type="momentum",
                            seed=9, mesh=mesh)
    tr.restore(snap_in)
    out = {f"restored_{k}": v for k, v in _full(tr).items()}
    out["loss"] = np.asarray(tr.train_step(tokens(4, T, seed, vocab=64)))
    tr.save(snap_out)
    out.update(_full(tr))
    return out


def case_offload_raises(mesh):
    """The trainer's refusal to offload under several processes."""
    from multiverso_tpu_torch.models import TransformerTrainer
    from multiverso_tpu_torch.parallel.offload import OffloadedState

    tr = TransformerTrainer(_cfg(CFG), device=DEVICE,
                            updater_type="momentum", mesh=mesh)
    try:
        tr.offload_state(OffloadedState(None, tr.offload_size(),
                                        backend="local"))
        return {"error": "no error"}
    except NotImplementedError as exc:
        return {"error": str(exc)}


def case_forward_error(mesh, cfg_kw, batch=4, T=16):
    from multiverso_tpu_torch.models.transformer import (
        init_params, params_from_jax, transformer_forward)

    cfg = _cfg(cfg_kw)
    params = params_from_jax(init_params(cfg, seed=1), cfg, DEVICE, mesh)
    try:
        transformer_forward(params, _t(np.zeros((batch, T), np.int32)), cfg,
                            mesh)
        return {"error": "no error"}
    except ValueError as exc:
        return {"error": str(exc)}


# At buckets of 8 elements: (2,) and (3,) share one, (4, 4) goes alone,
# the dtype changes twice, and the two float64 gradients share one.
GRAD_SHAPES = [(2,), (3,), (4, 4), (5,), (2, 2), (3,), (6,)]
GRAD_DTYPES = ["float32"] * 4 + ["float64"] * 2 + ["float32"]


def grad_inputs(rank, seed):
    """Each rank's gradients for the bucketed all-reduce: several shapes
    and two dtypes."""
    rng = np.random.RandomState(seed + rank)
    return [rng.randn(*shape).astype(dt)
            for shape, dt in zip(GRAD_SHAPES, GRAD_DTYPES)]


def case_grad_sum(mesh, seed, bucket):
    """``all_reduce_grads`` over (dp, sp) with buckets of ``bucket``
    elements."""
    from multiverso_tpu_torch.parallel import collectives

    collectives.BUCKET_ELEMENTS = bucket
    grads = [_t(g) for g in grad_inputs(mesh.rank, seed)]
    collectives.all_reduce_grads(grads, mesh, ("dp", "sp"))
    return {f"g{i}": _np(g) for i, g in enumerate(grads)}


def _mlp_stage(w, h):
    import torch

    for lyr in w:
        h = torch.tanh(h @ lyr)
    return h


def gpipe_inputs(pp, micro, d, seed):
    """(w [pp, 2, d, d], x [micro, 4, d], target) as test_pipeline makes
    them."""
    rng = np.random.RandomState(seed)
    w = (rng.randn(pp, 2, d, d) / np.sqrt(d)).astype(np.float32)
    x = np.random.RandomState(seed + 1).randn(micro, 4, d).astype(
        np.float32)
    tgt = np.random.RandomState(seed + 2).randn(micro, 4, d).astype(
        np.float32)
    return w, x, tgt


def case_gpipe(mesh, micro, d=8, seed=2, remat=False):
    import torch

    from multiverso_tpu_torch.parallel import gpipe
    from multiverso_tpu_torch.parallel.sharding import gather_full

    pp, s = mesh.size("pp"), mesh.index("pp")
    w, x, tgt = gpipe_inputs(pp, micro, d, seed)
    ws = _t(w[s]).requires_grad_()
    out = gpipe(_mlp_stage, ws, _t(x), mesh, remat_stages=remat)
    loss = ((out - _t(tgt)) ** 2).mean()
    (g,) = torch.autograd.grad(loss, [ws])
    return {"out": _np(out), "loss": _np(loss),
            "grad": _np(gather_full(g[None], 0, "pp", mesh))}


def case_shards(mesh, case, **kw):
    """A case of ``shard_cases`` on this rank of the group, through the
    port's runtime on the rank's device (the tables shard over the
    group)."""
    from functools import partial
    from types import SimpleNamespace

    import shard_cases
    import torch.distributed as dist

    import multiverso_tpu_torch as mv
    from multiverso_tpu_torch import apps
    from multiverso_tpu_torch.ext import shared, torch_ext

    pkg = SimpleNamespace(mv=mv, init=partial(mv.init, device=DEVICE),
                          device=DEVICE, apps=apps, torch_ext=torch_ext,
                          shared=shared)
    return shard_cases.CASES[case](pkg, dist.get_world_size(),
                                   dist.get_rank(), **kw)


CASES = {n[5:]: f for n, f in dict(globals()).items()
         if n.startswith("case_")}


def main(argv):
    import datetime

    import torch
    import torch.distributed as dist

    global DEVICE
    rank, world, store, out_dir, spec, backend = (
        int(argv[1]), int(argv[2]), argv[3], argv[4], argv[5], argv[6])
    torch.set_num_threads(1)
    if backend == "nccl":
        DEVICE = f"cuda:{rank}"
        torch.cuda.set_device(DEVICE)
    dist.init_process_group(backend, init_method="file://" + store,
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    from multiverso_tpu_torch.parallel import make_mesh

    with open(spec) as f:
        plan = json.load(f)
    for step in plan:
        mesh = make_mesh(step["sizes"], step["names"], device=DEVICE)
        for name, fn, kw in step["cases"]:
            try:
                res = CASES[fn](mesh, **kw)
            except Exception as exc:        # reported to the test
                import traceback

                traceback.print_exc()
                res = {"error": f"{type(exc).__name__}: {exc}"}
            np.savez(os.path.join(out_dir, f"{name}_r{rank}.npz"), **res)
    dist.destroy_process_group()


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    main(sys.argv)
