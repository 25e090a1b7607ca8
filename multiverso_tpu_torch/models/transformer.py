"""Llama-style decoder-only transformer for the PyTorch port.

Port of ``multiverso_tpu/models/transformer.py``: plain functions over a
dictionary of float32 master weights, bfloat16 compute, and a trainer
that applies the framework's server-side updaters to every parameter
leaf — so ``updater_type`` means the same thing as in the JAX package.

The parameter names and layouts are the JAX package's (``embed``,
``head``, ``out_norm`` and per layer ``wq wk wv wo attn_norm mlp_norm``
with either ``w1 w2 w3`` or, with experts, a ``moe`` subtree of
``router w1 w3 w2`` (``models/moe.py``); each matrix ``[in, out]`` and
applied as ``h @ w``), so :func:`params_from_jax` carries weights across
leaf by leaf.  The layers are always a list here; ``scan_layers=True``
runs the same Python loop, and only the checkpoint format stacks them
``[L, ...]`` as the JAX package does.

Attention goes through ``parallel.ring_attention`` into the flash
kernels.  Remat checkpoints each layer (``torch.utils.checkpoint``, not
reentrant): ``"full"`` keeps only the layer's input, ``"dots"`` also
keeps every projection product and the flash forward's ``(o, lse)``, and
recomputes the rest.  Gradient accumulation sums float32 gradients over
equal microbatches.  Trainer checkpoints (``save``/``restore``) write
and read the JAX trainer's tree.

With a mesh (``parallel.sharding.Mesh``: one process per card, the
JAX package's named axes as process groups) each rank holds its shard,
where GSPMD placed the JAX package's:

- ``dp``: the batch rows, contiguous blocks;
- ``tp``: the Megatron layout of ``param_shardings`` — wq/wk/wv/w1/w3
  column-parallel, wo/w2 row-parallel, the head split over the
  vocabulary, embed and norms replicated; ``copy_to``/``reduce_from``
  (``parallel/collectives.py``) around attention and the MLP, and a
  vocabulary-parallel cross-entropy;
- ``sp``: the sequence, in the ring's layout (zigzag when 2·sp divides
  T, else contiguous); RoPE rotates each rank's *global* positions and
  each position's target comes from the full row, so a chunk's last
  position predicts the next rank's first token;
- ``pp`` (with ``pipeline_microbatches``): the stacked layers split over
  stages and run by GPipe (``parallel/pipeline.py``) with the JAX
  package's interleaved microbatches;
- ``ep``: an MoE layer's experts ``[E, ...]`` (``models/moe.py``'s
  ``moe_pspecs``); the MoE layer runs whole on each tp rank, and its
  load-balancing loss and capacity buckets stay global over the batch.

The loss is the JAX package's global mean over B·(T-1) positions.
Gradients are summed over dp and sp (and the embedding's over pp), so
the updater runs on each rank's shard with its state sharded as the
weights are.  ``offload_state`` moves the updater state to an
``OffloadedState`` bridge (``parallel/offload.py``: the native runtime's
``assign`` table, or the local store) on one process; several processes
raise (ROADMAP.md Queue 1, "Several processes").
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from .. import dashboard, metrics, tracing
from ..device import resolve_device
from ..parallel.collectives import (all_reduce_grads, all_reduce_max,
                                    all_reduce_sum, copy_to, reduce_from,
                                    reduce_over, ring_rotate)
from ..parallel.sharding import (gather_full, gather_leaf, local_shard,
                                 shard_leaf)
from ..updaters import AddOption, get_updater
from ..util.tree import tree_map
from .moe import TokenShard, init_moe_params, moe_ffn, moe_pspecs

__all__ = ["TransformerConfig", "init_params", "stack_layer_params",
           "unstack_layer_params", "params_from_jax", "shard_params",
           "transformer_forward", "lm_loss", "TransformerTrainer"]

_LAYER_KEYS = ("wq", "wk", "wv", "wo", "w1", "w2", "w3", "attn_norm",
               "mlp_norm")
# An MoE layer: attention and norms, then its ``moe`` subtree.
_ATTN_KEYS = ("wq", "wk", "wv", "wo", "attn_norm", "mlp_norm")
_MOE_KEYS = ("router", "w1", "w3", "w2")
# The weights the JAX block casts through ``wc`` (named "wcast"), which
# its "dots" policy saves.
_WCAST_KEYS = ("wq", "wk", "wv", "wo", "w1", "w2", "w3")
# The dimension each leaf splits over tp (``param_shardings``):
# column-parallel projections and the head on their outputs, row-parallel
# ones on their inputs; every other leaf is replicated.
_TP_DIM = {"wq": 1, "wk": 1, "wv": 1, "w1": 1, "w3": 1, "wo": 0, "w2": 0,
           "head": 1}


def _spec(key: str, mesh):
    """Where a non-MoE leaf lives on ``mesh`` (``parallel.sharding``'s
    ``(dim, axis)``, or None: replicated)."""
    if mesh is None or "tp" not in mesh or key not in _TP_DIM:
        return None
    return _TP_DIM[key], "tp"


@dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32000
    dim: int = 512
    n_layers: int = 4
    n_heads: int = 8
    hidden: int = 1408          # SwiGLU inner dim
    max_seq: int = 2048
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    compute_dtype: Any = torch.bfloat16
    # Mixture-of-Experts (models/moe.py): 0 = dense SwiGLU MLP; > 0
    # replaces every MLP with a top_k-routed expert layer whose
    # load-balancing loss joins the LM loss at aux_loss_coef.
    num_experts: int = 0
    top_k: int = 2
    aux_loss_coef: float = 0.01
    moe_dispatch: str = "dense"      # "dense" (exact) or "capacity"
    capacity_factor: float = 1.25
    # Per-layer activation checkpointing: "full" keeps the layer input
    # only; "dots" also keeps the projection products and the flash
    # forward's (o, lse).
    remat: bool = False
    remat_policy: str = "full"
    scan_layers: bool = False   # the layers run as a loop; checkpoints stack
    # GPipe over a mesh's ``pp`` axis (parallel/pipeline.py): the layers
    # split into pp stages, batches into this many microbatches.  Needs
    # scan_layers, dense MLPs and sp == 1, as in the JAX package.
    pipeline_microbatches: int = 0

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads


def _check_mesh(cfg: TransformerConfig, mesh) -> None:
    """The port's own refusal of a mesh: experts that do not divide over
    ``ep`` (the JAX package's refusals of a mesh forward are in
    :func:`_check_forward`)."""
    if mesh is None:
        return
    if cfg.num_experts and cfg.num_experts % mesh.size("ep"):
        raise ValueError(f"num_experts ({cfg.num_experts}) not divisible "
                         f"by the ep axis ({mesh.size('ep')})")


def _use_pp(cfg: TransformerConfig, mesh) -> bool:
    return (mesh is not None and cfg.pipeline_microbatches > 0
            and mesh.size("pp") > 1)


def _pp_layers(cfg: TransformerConfig, mesh) -> bool:
    """Whether the stacked layers split over pp (``param_shardings``'s
    leading ``"pp"``)."""
    return (_use_pp(cfg, mesh) and cfg.scan_layers
            and cfg.n_layers % mesh.size("pp") == 0)


def init_params(cfg: TransformerConfig, seed: int = 0
                ) -> Dict[str, Any]:
    """Float32 master weights on the host, from the JAX package's numpy
    ``RandomState`` recipe: the same seed gives the same weights in both
    packages.  Layers are a list of dicts of CPU tensors."""
    rng = np.random.RandomState(seed)

    def w(*shape, scale=None):
        scale = scale or (shape[0] ** -0.5)
        return torch.from_numpy((scale * rng.randn(*shape)).astype(np.float32))

    layers = []
    for _ in range(cfg.n_layers):
        lyr = {
            "wq": w(cfg.dim, cfg.dim),
            "wk": w(cfg.dim, cfg.dim),
            "wv": w(cfg.dim, cfg.dim),
            "wo": w(cfg.dim, cfg.dim),
            "attn_norm": torch.ones(cfg.dim),
            "mlp_norm": torch.ones(cfg.dim),
        }
        if cfg.num_experts:
            # One draw seeds the layer's experts, as in the JAX package.
            lyr["moe"] = init_moe_params(cfg.dim, cfg.hidden,
                                         cfg.num_experts,
                                         seed=rng.randint(2 ** 31))
        else:
            lyr.update({
                "w1": w(cfg.dim, cfg.hidden),   # gate
                "w3": w(cfg.dim, cfg.hidden),   # up
                "w2": w(cfg.hidden, cfg.dim),   # down
            })
        layers.append(lyr)
    return {
        "embed": w(cfg.vocab_size, cfg.dim, scale=0.02),
        "out_norm": torch.ones(cfg.dim),
        "head": w(cfg.dim, cfg.vocab_size),
        "layers": layers,
    }


def _stack(*xs):
    return (np.stack(xs) if isinstance(xs[0], np.ndarray)
            else torch.stack(xs))


def stack_layer_params(layers: List[Dict[str, Any]]) -> Dict[str, Any]:
    """List of per-layer trees → one tree of stacked ``[L, ...]`` leaves
    (the JAX package's scan format; nested ``moe`` dicts and tuples of
    updater slots included)."""
    return tree_map(_stack, layers[0], *layers[1:])


def unstack_layer_params(layers: Dict[str, Any], n_layers: int
                         ) -> List[Dict[str, Any]]:
    """Inverse of :func:`stack_layer_params`; every leaf must hold
    ``n_layers`` layers."""
    def count(a):
        if len(a) != n_layers:
            raise ValueError(
                f"stacked layers hold {len(a)} layers for a config with "
                f"{n_layers} (tree structure differs)")
        return a

    tree_map(count, layers)
    return [tree_map(lambda a: a[i], layers) for i in range(n_layers)]


def _stacked(tree: Dict[str, Any]) -> Dict[str, Any]:
    """A trainer's ``{"params", "state"}`` tree with each part's layers
    stacked (the JAX trainer's layout under ``scan_layers``)."""
    return {part: {**sub, "layers": stack_layer_params(sub["layers"])}
            for part, sub in tree.items()}


def shard_params(tree, cfg: TransformerConfig, mesh, fn) -> Dict[str, Any]:
    """A loop-format tree of the parameters' structure (parameters, or
    updater slots at each leaf) cut to this rank's shard: the layers of
    its pp stage when they split, each leaf's tp block, and an MoE
    layer's experts over ep.  ``fn(leaf, spec)`` takes a leaf (or a tuple
    of slots) and where it lives (``parallel.sharding``'s ``(dim, axis)``,
    None: replicated) and returns the shard."""
    from ..parallel.pipeline import stage_slice

    layers = tree["layers"]
    if len(layers) != cfg.n_layers:
        raise ValueError(f"{len(layers)} layers for a config with "
                         f"{cfg.n_layers}")
    if _pp_layers(cfg, mesh):
        layers = layers[stage_slice(cfg.n_layers, mesh)]
    return _map_leaves({**tree, "layers": layers}, mesh, fn)


def _map_leaves(tree, mesh, fn) -> Dict[str, Any]:
    """A loop-format tree with ``fn(leaf, spec)`` at each leaf, ``spec``
    where the leaf lives on ``mesh`` (tp blocks, an MoE layer's experts
    over ep; None: replicated)."""
    moe_specs = moe_pspecs(mesh)

    def layer(lyr):
        return {k: ({mk: fn(m, moe_specs[mk]) for mk, m in w.items()}
                    if k == "moe" else fn(w, _spec(k, mesh)))
                for k, w in lyr.items()}

    return {
        "embed": fn(tree["embed"], None),
        "out_norm": fn(tree["out_norm"], None),
        "head": fn(tree["head"], _spec("head", mesh)),
        "layers": [layer(lyr) for lyr in tree["layers"]],
    }


def params_from_jax(host_params, cfg: TransformerConfig, device=None,
                    mesh=None) -> Dict[str, Any]:
    """The JAX package's parameter tree (``init_params`` output of either
    package, or a trainer's ``params`` pulled to numpy), in loop or
    stacked ``[L, ...]`` format → the port's parameters: float32 tensors
    on ``device``, names and ``[in, out]`` layouts unchanged, layers as a
    list.  With a mesh, this rank's shard of each (:func:`shard_params`):
    the weight carrier from the JAX package's full arrays."""
    _check_mesh(cfg, mesh)
    dev = resolve_device(device)

    def t(a, spec):
        a = torch.as_tensor(np.asarray(a, np.float32))
        return shard_leaf(a, spec, mesh).contiguous().to(dev)

    layers = host_params["layers"]
    if isinstance(layers, dict):           # stacked [L, ...] (scan format)
        layers = unstack_layer_params(layers, cfg.n_layers)
    return shard_params({**host_params, "layers": layers}, cfg, mesh, t)


def _layer_leaves(lyr) -> list:
    if "moe" in lyr:
        return ([lyr[key] for key in _ATTN_KEYS]
                + [lyr["moe"][key] for key in _MOE_KEYS])
    return [lyr[key] for key in _LAYER_KEYS]


def _layer_with(lyr, it) -> Dict[str, Any]:
    if "moe" in lyr:
        out = {key: next(it) for key in _ATTN_KEYS}
        out["moe"] = {key: next(it) for key in _MOE_KEYS}
        return out
    return {key: next(it) for key in _LAYER_KEYS}


def _leaves(params) -> list:
    """Every leaf of a loop-format tree in one fixed order (parameter
    tensors, or whatever a tree of that structure holds at them)."""
    out = [params["embed"], params["out_norm"], params["head"]]
    for lyr in params["layers"]:
        out.extend(_layer_leaves(lyr))
    return out


def _with_leaves(params, leaves: list) -> Dict[str, Any]:
    """``params``'s structure with ``leaves`` (in :func:`_leaves` order)
    at its leaves."""
    it = iter(leaves)
    out = {"embed": next(it), "out_norm": next(it), "head": next(it)}
    out["layers"] = [_layer_with(lyr, it) for lyr in params["layers"]]
    return out


def _rms_norm(x, gain, eps):
    # The variance in float32; x * rsqrt promotes to float32, is cast back
    # to x's dtype, then scaled by the gain already in x's dtype — the
    # JAX package's order of roundings.
    var = x.float().square().mean(-1, keepdim=True)
    return (x * torch.rsqrt(var + eps)).to(x.dtype) * gain


def _rope(x, theta: float, positions=None):
    """Rotary embedding, half-split rotation; x [B, H, T, D] at the global
    ``positions`` [T] (0..T-1 when None: a rank's shard of the sequence
    under sp rotates its own positions), math in float32, result in x's
    dtype."""
    T, D = x.shape[2], x.shape[3]
    half = D // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    if positions is None:
        pos = torch.arange(T, dtype=torch.float32, device=x.device)
    else:
        pos = positions.to(device=x.device, dtype=torch.float32)
    ang = pos[:, None] * freqs[None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    rot = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return rot.to(x.dtype)


@dataclass(frozen=True)
class _Shard:
    """Where a rank's activations sit: its mesh, under sp the global
    positions of its sequence shard in the ring's layout, and for an MoE
    config its tokens' places in the global batch."""
    mesh: Any
    positions: Optional[torch.Tensor] = None
    zigzag: bool = False
    tokens: Optional[TokenShard] = None


def _block(x, lyr, cfg: TransformerConfig, scale: float,
           shard: Optional[_Shard] = None):
    """One decoder layer: attention + residual, then the SwiGLU MLP or the
    MoE layer + residual.  Returns ``(x, aux)``: the MoE load-balancing
    loss, or None for a dense layer.  Under tp the layer holds
    ``n_heads / tp`` heads and hidden / tp MLP columns, between the
    Megatron pair; under sp attention is the ring."""
    from ..parallel.ring_attention import (blockwise_attention_local,
                                           ring_attention_shard)

    mesh = None if shard is None else shard.mesh
    dt = cfg.compute_dtype
    B, T, _ = x.shape
    hd = cfg.head_dim
    H = lyr["wq"].shape[1] // hd                  # this rank's heads
    h = copy_to(_rms_norm(x, lyr["attn_norm"].to(dt), cfg.norm_eps), mesh)
    q = (h @ lyr["wq"].to(dt)).reshape(B, T, H, hd).transpose(1, 2)
    k = (h @ lyr["wk"].to(dt)).reshape(B, T, H, hd).transpose(1, 2)
    v = (h @ lyr["wv"].to(dt)).reshape(B, T, H, hd).transpose(1, 2)
    positions = None if shard is None else shard.positions
    q = _rope(q, cfg.rope_theta, positions)
    k = _rope(k, cfg.rope_theta, positions)
    sp = 1 if mesh is None else mesh.size("sp")
    if sp > 1:
        o, _ = ring_attention_shard(q, k, v, mesh.index("sp"), sp,
                                    ring_rotate(mesh, "sp"), True, scale,
                                    shard.zigzag)
    else:
        o = blockwise_attention_local(q, k, v, scale, causal=True)
    o = o.transpose(1, 2).reshape(B, T, H * hd)
    x = x + reduce_from(o @ lyr["wo"].to(dt), mesh)
    h = _rms_norm(x, lyr["mlp_norm"].to(dt), cfg.norm_eps)
    if "moe" in lyr:
        # Whole on each tp rank: no tp collective around it.
        out, aux = moe_ffn(lyr["moe"], h, top_k=cfg.top_k, compute_dtype=dt,
                           dispatch=cfg.moe_dispatch,
                           capacity_factor=cfg.capacity_factor,
                           shard=None if shard is None else shard.tokens)
        return x + out, aux
    h = copy_to(h, mesh)
    gated = F.silu(h @ lyr["w1"].to(dt)) * (h @ lyr["w3"].to(dt))
    return x + reduce_from(gated @ lyr["w2"].to(dt), mesh), None


def _dots_policy(ctx, op, *args, **kwargs):
    """The "dots" policy: keep every 2-D product (the projections; JAX's
    ``dots_with_no_batch_dims_saveable``) and the flash forward's (o,
    lse) (JAX's ``"flash_out"``/``"flash_lse"``); recompute the rest —
    collectives included, which every rank then re-runs in one order."""
    if op in (torch.ops.aten.mm.default, torch.ops.mvt.flash_fwd.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _layer(x, lyr, cfg: TransformerConfig, scale: float,
           shard: Optional[_Shard] = None):
    """:func:`_block`, checkpointed as ``cfg.remat_policy`` says."""
    if not cfg.remat:
        return _block(x, lyr, cfg, scale, shard)
    if cfg.remat_policy == "dots":
        # The bf16 weight casts stay outside the checkpoint, so the
        # backward reuses them (the JAX package saves them as "wcast").
        dt = cfg.compute_dtype
        lyr = {k: (w.to(dt) if k in _WCAST_KEYS else w)
               for k, w in lyr.items()}
        context = partial(create_selective_checkpoint_contexts,
                          _dots_policy)
        return checkpoint(_block, x, lyr, cfg, scale, shard,
                          use_reentrant=False, context_fn=context)
    if cfg.remat_policy == "full":
        return checkpoint(_block, x, lyr, cfg, scale, shard,
                          use_reentrant=False)
    raise ValueError(f"unknown remat_policy '{cfg.remat_policy}' "
                     "(expected 'full' or 'dots')")


def _check_forward(cfg: TransformerConfig, mesh, B: int, T: int) -> None:
    """The JAX package's refusals of a mesh forward (``:334-357``), in its
    order, then the port's own."""
    if T > cfg.max_seq:
        raise ValueError(f"sequence length {T} exceeds max_seq "
                         f"{cfg.max_seq}")
    if mesh is None:
        return
    dp, tp, sp = mesh.size("dp"), mesh.size("tp"), mesh.size("sp")
    if _use_pp(cfg, mesh):
        pp, M = mesh.size("pp"), cfg.pipeline_microbatches
        if not cfg.scan_layers or cfg.num_experts:
            raise ValueError(
                "pipeline_microbatches requires scan_layers=True and a "
                "dense MLP (num_experts=0)")
        if sp > 1:
            raise ValueError(
                "pipeline parallelism composes with dp and tp, not sp "
                "(ring attention inside pipeline stages is unsupported)")
        if cfg.n_layers % pp or B % (M * dp):
            raise ValueError(
                f"n_layers ({cfg.n_layers}) must divide into pp ({pp}) "
                f"stages and batch ({B}) into {M} microbatches x dp "
                f"({dp}) shards")
        if cfg.n_heads % tp or cfg.hidden % tp or cfg.dim % tp:
            raise ValueError(
                f"pp x tp needs n_heads ({cfg.n_heads}), hidden "
                f"({cfg.hidden}) and dim ({cfg.dim}) divisible by tp "
                f"({tp}) — the stage body shards them manually")
    _check_mesh(cfg, mesh)
    if cfg.n_heads % tp or cfg.hidden % tp or cfg.vocab_size % tp:
        raise ValueError(
            f"tensor parallelism needs n_heads ({cfg.n_heads}), hidden "
            f"({cfg.hidden}) and vocab_size ({cfg.vocab_size}) divisible "
            f"by tp ({tp})")
    if B % dp:
        raise ValueError(f"batch {B} not divisible by the dp axis ({dp})")


def _forward_local(params, tokens, cfg: TransformerConfig, mesh=None):
    """This rank's forward: tokens [B, T] (the global batch) → (logits
    [B/dp, t, vocab/tp] over this rank's rows and positions, the summed
    MoE aux loss, the global positions under sp or None)."""
    from ..parallel.pipeline import gpipe
    from ..parallel.ring_attention import _use_zigzag, sequence_positions

    B, T = tokens.shape
    _check_forward(cfg, mesh, B, T)
    rows = local_shard(tokens.long(), 0, "dp", mesh)
    positions, zigzag = None, False
    sp = 1 if mesh is None else mesh.size("sp")
    if sp > 1:
        zigzag = _use_zigzag(T, sp, True, "auto")
        positions = sequence_positions(T, sp, mesh.index("sp"), zigzag,
                                       rows.device)
        rows = rows.index_select(1, positions)
    shard = None
    if mesh is not None:
        tokens_at = None
        if cfg.num_experts:
            b, t = rows.shape
            first = mesh.index("dp") * b
            at = torch.arange(t, device=rows.device) if positions is None \
                else positions
            index = ((first + torch.arange(b, device=rows.device))[:, None]
                     * T + at[None, :]).reshape(-1)
            tokens_at = TokenShard(mesh, index, B * T)
        shard = _Shard(mesh, positions, zigzag, tokens_at)
    dt = cfg.compute_dtype
    x = params["embed"][rows].to(dt)                     # [b,t,dim]
    scale = cfg.head_dim ** -0.5
    aux_total = torch.zeros((), device=x.device)
    if _use_pp(cfg, mesh):
        def stage_fn(layers, h):
            for lyr in layers:
                h, _ = _layer(h, lyr, cfg, scale, shard)
            return h

        # The JAX package's INTERLEAVED microbatches: row r of this
        # rank's (contiguous dp) rows goes to microbatch r mod M.
        b, t, d = x.shape
        M = cfg.pipeline_microbatches
        xm = x.reshape(b // M, M, t, d).transpose(0, 1).contiguous()
        xm = gpipe(stage_fn, params["layers"], xm, mesh)
        x = xm.transpose(0, 1).reshape(b, t, d)
    else:
        for lyr in params["layers"]:
            x, aux = _layer(x, lyr, cfg, scale, shard)
            if aux is not None:
                aux_total = aux_total + aux
    x = _rms_norm(x, params["out_norm"].to(dt), cfg.norm_eps)
    logits = copy_to(x, mesh) @ params["head"].to(dt)
    return logits, aux_total, positions


def transformer_forward(params, tokens, cfg: TransformerConfig, mesh=None,
                        return_aux: bool = False):
    """tokens [B, T] (any integer dtype) → logits [B, T, vocab] in the
    compute dtype; with ``return_aux`` also the summed MoE load-balancing
    loss (float32, zero for a dense config).

    With a mesh every rank passes the global batch and its own shard of
    the parameters (``params_from_jax(..., mesh=mesh)``), and gets the
    global logits, gathered over tp, sp and dp (the gather has no
    backward: :func:`lm_loss` trains on the local shard)."""
    logits, aux, positions = _forward_local(params, tokens, cfg, mesh)
    if mesh is not None:
        logits = gather_full(logits, 2, "tp", mesh)
        if positions is not None:
            held = gather_full(positions, 0, "sp", mesh)
            logits = gather_full(logits, 1, "sp", mesh)
            logits = torch.empty_like(logits).index_copy_(1, held, logits)
        logits = gather_full(logits, 0, "dp", mesh)
    if return_aux:
        return logits, aux
    return logits


def _ce_value(logits, targets):
    lf = logits.float()
    logz = torch.logsumexp(lf, -1)
    ll = torch.gather(lf, -1, targets[..., None])[..., 0]
    return (logz - ll).mean()


class _VocabCE(torch.autograd.Function):
    """Cross-entropy whose gradient is computed in float32 and cast to the
    LOGITS' dtype (the JAX package's ``_ce`` custom vjp): the head's
    backward products then run in bf16, and only the bf16 logits are kept
    for the backward.

    Vocabulary-parallel over tp: each rank holds logits for its block of
    the vocabulary, starting at ``lo``.  Each rank's logsumexp joins the
    others' through an all-reduced max and sum over ``mesh``'s tp axis
    (no mesh or no tp axis: the whole row is local), the target logit
    comes from the rank that holds it, and the value is ``sum(weight ·
    (lse - target logit)) / n`` (the mean when ``weight`` is None and the
    rows are all n positions).  The backward is (softmax - onehot) ·
    weight · g / n on the local block.  The row's logsumexp is the local
    one plus log(S / s), and its softmax the local one times s / S, where
    s is this rank's ``exp(lse_local - max)`` and S their sum.  With the
    whole row on one rank (no mesh, or tp of one) none of that runs: the
    value and gradient are those of the plain logsumexp and softmax."""

    @staticmethod
    def forward(ctx, logits, targets, weight, lo, mesh, n):
        lf = logits.float()
        vl = lf.shape[-1]
        lse = torch.logsumexp(lf, -1)
        share = None
        if mesh is not None and mesh.size("tp") > 1:
            top = all_reduce_max(lse, mesh, "tp")
            s = torch.exp(lse - top)
            total = all_reduce_sum(s, mesh, "tp")
            lse = torch.where(s > 0, lse + torch.log(total / s),
                              top + torch.log(total))
            share = s / total
        local = targets - lo
        own = (local >= 0) & (local < vl)
        local = local.clamp(0, vl - 1)
        ll = torch.gather(lf, -1, local[..., None])[..., 0] * own
        rows = lse - (ll if share is None else all_reduce_sum(ll, mesh, "tp"))
        if weight is None and rows.numel() == n:
            loss = rows.mean()
        else:
            loss = (rows if weight is None else rows * weight).sum() / n
        ctx.save_for_backward(logits, local, own, share, weight)
        ctx.n = n
        return loss

    @staticmethod
    def backward(ctx, g):
        logits, local, own, share, weight = ctx.saved_tensors
        d = torch.softmax(logits.float(), -1)
        if share is not None:
            d.mul_(share[..., None])
        d.scatter_add_(-1, local[..., None], -own[..., None].float())
        d *= g / ctx.n
        if weight is not None:
            d *= weight[..., None]
        return d.to(logits.dtype), None, None, None, None, None


def _ce(logits, targets):
    """The mean cross-entropy of whole rows through ``_VocabCE``."""
    return _VocabCE.apply(logits, targets, None, 0, None, targets.numel())


def lm_loss(params, tokens, cfg: TransformerConfig, mesh=None):
    """Next-token cross-entropy, mean over all B·(T-1) positions
    (float32), plus ``aux_loss_coef`` × the summed load-balancing loss
    for MoE configs.  Without a mesh ``_ce`` serves heads of 16384 tokens
    and up, as in the JAX package, and smaller heads differentiate
    ``_ce_value`` directly.  With a mesh every rank passes
    the global batch and gets the global loss (summed over dp and sp,
    whose backward is the identity: each rank differentiates its own
    positions' terms); the targets of a rank's positions come from the
    full rows, and the global last position counts for nothing."""
    tokens = tokens.long()
    if mesh is None:
        logits, aux = transformer_forward(params, tokens, cfg,
                                          return_aux=True)
        logits, targets = logits[:, :-1], tokens[:, 1:]
        if cfg.vocab_size >= 16384:
            ce = _ce(logits, targets)
        else:
            ce = _ce_value(logits, targets)
    else:
        logits, aux, positions = _forward_local(params, tokens, cfg, mesh)
        rows = local_shard(tokens, 0, "dp", mesh)
        B, T = tokens.shape
        if positions is None:
            logits, targets, weight = logits[:, :-1], rows[:, 1:], None
        else:
            targets = rows.index_select(1, (positions + 1).clamp(max=T - 1))
            weight = (positions < T - 1).float()
        lo = mesh.index("tp") * logits.shape[-1]
        ce = _VocabCE.apply(logits, targets, weight, lo, mesh, B * (T - 1))
        ce = reduce_over(ce, mesh, ("dp", "sp"))
    if cfg.num_experts:
        return ce + cfg.aux_loss_coef * aux
    return ce


class TransformerTrainer:
    """LM training through the framework's updaters.

    The parameter dictionary is the "table": float32 master weights,
    updated by the same Updater the tables use — the reference's
    server-side optimizer semantics at transformer scale.  Gradients are
    taken with respect to the float32 masters through the compute-dtype
    casts, and the updater applies to every leaf, embeddings and norms
    included.

    ``params`` starts the trainer from given float32 masters instead of
    drawing them from ``seed``: a tree in the JAX package's layout, loop
    or stacked, of numpy arrays or CPU tensors (what ``init_params`` of
    either package returns).  They are copied to ``device``, never
    written.  The option is the port's own: the JAX trainer has no
    ``params`` argument and always draws from ``seed``.  It lets a caller
    that runs several configurations of one model (the smoke script's
    remat runs, say) draw the masters once.

    ``mesh`` (a ``parallel.sharding.Mesh``, the JAX trainer's second
    argument) trains on a mesh of processes: each rank keeps its shard of
    the weights and of the updater state on ``mesh.device``, and every
    rank passes the same global batch to each step.

    ``offload_state(bridge)`` keeps the updater state in an
    ``OffloadedState`` (``parallel/offload.py``) between steps instead of
    on the device, as the JAX trainer does.
    """

    def __init__(self, cfg: TransformerConfig, device=None,
                 updater_type: str = "sgd",
                 option: Optional[AddOption] = None, seed: int = 0,
                 params=None, mesh=None):
        _check_mesh(cfg, mesh)
        self.cfg = cfg
        self.mesh = mesh
        self.device = resolve_device(
            mesh.device if device is None and mesh is not None else device)
        self.updater = get_updater(updater_type)
        self.option = option or AddOption(learning_rate=0.1)
        host = init_params(cfg, seed) if params is None else params
        self.params = params_from_jax(host, cfg, self.device, mesh)
        self.state = [self.updater.init_state(p.shape, p.dtype, p.device)
                      for p in _leaves(self.params)]
        self._offload = None       # the OffloadedState bridge, once set
        # The least bytes a step's dense update moves, for the
        # ``trainer.update_bytes`` counter: each leaf's w and g read and w
        # written, each state tensor read and written once.
        self._update_bytes = sum(
            p.numel() * p.element_size() * (3 + 2 * self.updater.num_slots)
            for p in _leaves(self.params))

    def _tokens(self, tokens) -> torch.Tensor:
        if not isinstance(tokens, torch.Tensor):
            tokens = torch.as_tensor(np.asarray(tokens))
        return tokens.to(self.device).long()

    def _sum_grads(self, grads) -> None:
        """Each rank's gradients → the global batch's, in place: every
        leaf summed over dp and sp (each rank differentiated its own rows
        and positions), and under GPipe the embedding over pp too (only
        stage 0 feeds it).  The head and norms after the pipeline are
        computed on every stage alike, and tp's replicated leaves already
        hold the full gradient (``copy_to``'s backward)."""
        mesh = self.mesh
        all_reduce_grads(grads, mesh, ("dp", "sp"))
        if _use_pp(self.cfg, mesh):
            all_reduce_grads(grads[:1], mesh, ("pp",))     # embed

    def train_step_async(self, tokens, accum: int = 1) -> torch.Tensor:
        """One step; returns the loss as a device tensor (no host sync).

        ``accum > 1`` splits the batch into that many equal microbatches,
        sums their float32 gradients, divides by ``accum`` and applies
        one update: the full-batch step (the loss is a mean over equal
        chunks) with one microbatch's activations alive at a time.  The
        loss returned is the mean of the chunks' losses.  MoE configs
        refuse it, as in the JAX package; so does a microbatch that the
        dp axis does not divide."""
        cfg, mesh = self.cfg, self.mesh
        if accum > 1 and cfg.num_experts:
            raise ValueError(
                "grad accumulation is not equivalence-preserving for MoE "
                "configs (batch-nonlinear aux loss, capacity buckets "
                "sized from the microbatch); run MoE at full batch")
        tokens = self._tokens(tokens)
        B = tokens.shape[0]
        if B % accum:
            raise ValueError(f"batch {B} not divisible by accum {accum}")
        if accum > 1 and mesh is not None and (B // accum) % mesh.size("dp"):
            raise ValueError(
                f"microbatch {B // accum} (batch {B} / accum {accum}) not "
                f"divisible by the dp axis ({mesh.size('dp')})")
        with tracing.span("Transformer::train_step_async"):
            if self._offload is None:
                return self._update(tokens, accum)
            # Offloaded state: the vector prefetched after the previous
            # step (or fetched now on the first), rebuilt on the device;
            # the new state ships back and the next prefetch is issued
            # behind it.
            with dashboard.monitor("Transformer::offload_wait"):
                self.state = self._flat_to_state(self._offload.wait())
            loss = self._update(tokens, accum)
            with dashboard.monitor("Transformer::offload_push"):
                self._offload.push(self._state_to_flat())
                self._offload.prefetch()
            self.state = self._no_state()      # the bridge owns it now
            return loss

    def _update(self, tokens: torch.Tensor, accum: int) -> torch.Tensor:
        """The step's gradients and the updater's application, in place
        of ``params`` and ``state``; returns the device loss.  Its phases
        are spans (``Transformer::forward``, ``backward``, ``grad_sync``
        under a mesh, ``update``) that together hold every op of the
        step."""
        cfg, mesh = self.cfg, self.mesh
        B = tokens.shape[0]
        leaves = [p.detach().requires_grad_() for p in _leaves(self.params)]
        params = _with_leaves(self.params, leaves)
        grads, losses = None, []
        for chunk in tokens.reshape(accum, B // accum, -1):
            with tracing.span("Transformer::forward"):
                loss = lm_loss(params, chunk, cfg, mesh)
            with tracing.span("Transformer::backward"):
                # Under GPipe only stage 0 uses the embedding: zeros
                # elsewhere.
                g = [torch.zeros_like(p) if d is None else d
                     for p, d in zip(leaves, torch.autograd.grad(
                         loss, leaves, allow_unused=True))]
                grads = g if grads is None else [a + b for a, b in
                                                 zip(grads, g)]
            losses.append(loss.detach())
        if accum > 1:
            with tracing.span("Transformer::backward"):
                grads = [g / accum for g in grads]
                loss = torch.stack(losses).mean()
        if mesh is not None:
            with tracing.span("Transformer::grad_sync"):
                self._sum_grads(list(grads))
        with tracing.span("Transformer::update"), torch.no_grad():
            out = [self.updater.apply_dense(p.detach(), s, g, self.option)
                   for p, s, g in zip(leaves, self.state, grads)]
        metrics.counter("trainer.update_bytes").inc(self._update_bytes)
        self.params = _with_leaves(self.params, [p for p, _ in out])
        self.state = [s for _, s in out]
        return loss.detach()

    def train_step(self, tokens) -> float:
        with dashboard.monitor("Transformer::train_step"):
            return float(self.train_step_async(tokens))

    def train_steps_fused(self, tokens, n: int) -> torch.Tensor:
        """``n`` steps on one batch; returns the last device loss.  The
        JAX package fuses them into one compiled program; here they are
        a loop of eager steps with no host sync between them.  Refused
        with the state offloaded, as in the JAX package."""
        if self._offload is not None:
            raise RuntimeError(
                "train_steps_fused keeps the state on device across the "
                "whole fused program — incompatible with offload_state "
                "(use train_step_async)")
        tokens = self._tokens(tokens)
        loss = torch.zeros((), device=self.device)
        for _ in range(n):
            loss = self.train_step_async(tokens)
        return loss

    def loss(self, tokens) -> float:
        with torch.no_grad():
            return float(lm_loss(self.params, self._tokens(tokens),
                                 self.cfg, self.mesh))

    # ------------------------------------------------------ state offload
    def offload_state(self, bridge) -> None:
        """Move the updater state to ``bridge``, an
        ``parallel.offload.OffloadedState`` of ``offload_size()``
        elements (the JAX trainer's ZeRO-style offload).  From then on
        each ``train_step_async`` takes the state from the bridge's
        prefetched vector, steps, pushes the new state and issues the
        next prefetch; between steps the device holds none of it.  The
        bridge stores float32 bits verbatim, so the run equals the
        in-memory one bit for bit.  The vector ``wait()`` returns is the
        bridge's own buffer (an arena buffer of the native store): it is
        copied onto the device at once (``_flat_to_state``), before the
        next prefetch may land in it.  One process only: under a mesh of
        several processes it raises (ROADMAP.md Queue 1, "Several
        processes")."""
        import torch.distributed as dist

        if (self.mesh is not None and dist.is_initialized()
                and dist.get_world_size() > 1):
            raise NotImplementedError(
                "offload_state under a mesh of several processes is not "
                "ported yet: each rank would need its own store of its "
                "shard (ROADMAP.md Queue 1, \"Several processes\")")
        if not self.updater.num_slots:
            raise ValueError(
                f"updater '{self.updater.name}' keeps no optimizer "
                f"state — nothing to offload")
        if bridge.size != self.offload_size():
            raise ValueError(
                f"bridge sized {bridge.size}, state needs "
                f"{self.offload_size()} elements")
        self._offload = bridge
        bridge.init(self._state_to_flat())
        # The device copies now live in the store: drop them.
        self.state = self._no_state()
        bridge.prefetch()

    def offload_size(self) -> int:
        """Flat float32 element count of the updater state: the
        ``OffloadedState`` size this trainer needs."""
        return sum(p.numel() for p in _leaves(self.params)) \
            * self.updater.num_slots

    def _no_state(self) -> list:
        return [tuple(None for _ in range(self.updater.num_slots))
                for _ in _leaves(self.params)]

    def _state_to_flat(self, state=None) -> np.ndarray:
        """The state as one float32 host vector: leaf by leaf in
        ``_leaves`` order, each leaf's slots in turn (one copy from the
        device)."""
        slots = [a.detach().reshape(-1).float()
                 for sl in (self.state if state is None else state)
                 for a in sl]
        return torch.cat(slots).cpu().numpy()

    def _flat_to_state(self, flat) -> list:
        """The state from the bridge's vector: one copy onto the device
        (the bridge keeps its buffer), each slot a view of it.  The copy
        blocks: from pageable host memory it has read the whole buffer
        when it returns, so the bridge may reuse the slot (a
        ``non_blocking`` copy would need an event per slot)."""
        buf = torch.as_tensor(np.asarray(flat, np.float32)).to(
            self.device, copy=True)
        out, pos = [], 0
        for p in _leaves(self.params):
            n = p.numel()
            out.append(tuple(buf[pos + i * n:pos + (i + 1) * n].view(p.shape)
                             for i in range(self.updater.num_slots)))
            pos += n * self.updater.num_slots
        return out

    def _tree(self, state=None) -> Dict[str, Any]:
        """``{"params", "state"}`` in the JAX trainer's layout, loop
        format: the state mirrors the params with a tuple of updater
        slots at each leaf.  This rank's shard under a mesh."""
        return {"params": self.params,
                "state": _with_leaves(self.params,
                                      self.state if state is None
                                      else state)}

    def _full_tree(self, state=None) -> Dict[str, Any]:
        """:meth:`_tree` with every leaf gathered whole: tp blocks and
        the experts' ep blocks concatenated on their split dimension, the
        pp stages' layers in order (a collective over the mesh)."""
        mesh, cfg = self.mesh, self.cfg
        if mesh is None:
            return self._tree(state)

        def whole(leaf, spec):
            if isinstance(leaf, tuple):
                return tuple(whole(a, spec) for a in leaf)
            return gather_leaf(leaf, spec, mesh)

        out = {}
        for part, sub in self._tree(state).items():
            sub = _map_leaves(sub, mesh, whole)
            if _pp_layers(cfg, mesh):
                stages = [tree_map(lambda a: gather_full(a[None], 0, "pp",
                                                         mesh), lyr)
                          for lyr in sub["layers"]]
                sub["layers"] = [tree_map(lambda a: a[s], lyr)
                                 for s in range(mesh.size("pp"))
                                 for lyr in stages]
            out[part] = sub
        return out

    def save(self, uri: str) -> None:
        """Snapshot params + updater state (rank-0 atomic write, the
        durability of the table checkpoints) as the JAX trainer of the
        same config writes it: layers stacked ``[L, ...]`` under
        ``scan_layers``, a list otherwise.  Under a mesh every rank
        calls it; the full tensors are gathered first.  With the state
        offloaded it is fetched from the bridge first."""
        from .. import checkpoint

        state = None
        if self._offload is not None:
            state = self._flat_to_state(self._offload.wait())
        tree = self._full_tree(state)
        if self.cfg.scan_layers:
            tree = _stacked(tree)
        checkpoint.save_pytree(uri, tree)

    def restore(self, uri: str) -> None:
        """Load a snapshot written by either package's trainer for this
        config and updater, on any mesh, in loop or stacked format, onto
        this trainer's device and mesh (each rank re-slices its own
        shard).  A snapshot of another structure raises ``ValueError``.
        With the state offloaded, the restored state seeds the bridge."""
        from .. import checkpoint

        snap = checkpoint.restore_pytree(uri)
        try:
            for sub in snap.values():
                if isinstance(sub["layers"], dict):
                    sub["layers"] = unstack_layer_params(sub["layers"],
                                                         self.cfg.n_layers)
            if self.mesh is not None:
                def cut(leaf, spec):
                    if isinstance(leaf, tuple):
                        return tuple(cut(a, spec) for a in leaf)
                    a = torch.as_tensor(np.asarray(leaf))
                    return shard_leaf(a, spec, self.mesh).contiguous()

                snap = {part: shard_params(sub, self.cfg, self.mesh, cut)
                        for part, sub in snap.items()}
        except (AttributeError, KeyError, TypeError) as exc:
            raise ValueError(f"{uri}: snapshot tree structure is not a "
                             f"trainer's: {exc}") from exc
        like = self._tree(
            None if self._offload is None else
            [self.updater.init_state(p.shape, p.dtype, p.device)
             for p in _leaves(self.params)])
        placed = checkpoint.place_pytree(snap, like, uri)
        self.params = placed["params"]
        self.state = _leaves(placed["state"])
        if self._offload is not None:
            self._offload.init(self._state_to_flat())
            self.state = self._no_state()
            self._offload.prefetch()
