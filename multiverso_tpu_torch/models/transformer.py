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

Attention goes through ``parallel.ring_attention.blockwise_attention_
local`` into the flash kernels.  Remat checkpoints each layer
(``torch.utils.checkpoint``, not reentrant): ``"full"`` keeps only the
layer's input, ``"dots"`` also keeps every projection product and the
flash forward's ``(o, lse)``, and recomputes the rest.  Gradient
accumulation sums float32 gradients over equal microbatches.  Trainer
checkpoints (``save``/``restore``) write and read the JAX trainer's tree.
Not ported yet, each raising ``NotImplementedError`` that names its
ROADMAP item: pipeline microbatches, sequence-parallel rings and state
offload.
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

from .. import dashboard
from ..device import resolve_device
from ..updaters import AddOption, get_updater
from ..util.tree import tree_map
from .moe import init_moe_params, moe_ffn

__all__ = ["TransformerConfig", "init_params", "stack_layer_params",
           "unstack_layer_params", "params_from_jax",
           "transformer_forward", "lm_loss",
           "TransformerTrainer"]

_LAYER_KEYS = ("wq", "wk", "wv", "wo", "w1", "w2", "w3", "attn_norm",
               "mlp_norm")
# An MoE layer: attention and norms, then its ``moe`` subtree.
_ATTN_KEYS = ("wq", "wk", "wv", "wo", "attn_norm", "mlp_norm")
_MOE_KEYS = ("router", "w1", "w3", "w2")
# The weights the JAX block casts through ``wc`` (named "wcast"), which
# its "dots" policy saves.
_WCAST_KEYS = ("wq", "wk", "wv", "wo", "w1", "w2", "w3")


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
    pipeline_microbatches: int = 0   # not ported: raises

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads


def _check_ported(cfg: TransformerConfig) -> None:
    if cfg.pipeline_microbatches > 0:
        raise NotImplementedError(
            "pipeline parallelism (pipeline_microbatches > 0) is not "
            "ported to multiverso_tpu_torch yet (ROADMAP.md Queue 1, "
            "\"Several processes\")")


def init_params(cfg: TransformerConfig, seed: int = 0
                ) -> Dict[str, Any]:
    """Float32 master weights on the host, from the JAX package's numpy
    ``RandomState`` recipe: the same seed gives the same weights in both
    packages.  Layers are a list of dicts of CPU tensors."""
    _check_ported(cfg)
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


def params_from_jax(host_params, cfg: TransformerConfig,
                    device=None) -> Dict[str, Any]:
    """The JAX package's parameter tree (``init_params`` output of either
    package, or a trainer's ``params`` pulled to numpy), in loop or
    stacked ``[L, ...]`` format → the port's parameters: float32 tensors
    on ``device``, names and ``[in, out]`` layouts unchanged, layers as a
    list."""
    dev = resolve_device(device)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32)).to(dev)

    layers = host_params["layers"]
    if isinstance(layers, dict):           # stacked [L, ...] (scan format)
        layers = unstack_layer_params(layers, cfg.n_layers)
    if len(layers) != cfg.n_layers:
        raise ValueError(f"{len(layers)} layers for a config with "
                         f"{cfg.n_layers}")
    return {
        "embed": t(host_params["embed"]),
        "out_norm": t(host_params["out_norm"]),
        "head": t(host_params["head"]),
        "layers": [tree_map(t, lyr) for lyr in layers],
    }


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


def _rope(x, theta: float):
    """Rotary embedding, half-split rotation over positions 0..T-1;
    x [B, H, T, D], math in float32, result in x's dtype."""
    T, D = x.shape[2], x.shape[3]
    half = D // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = torch.arange(T, dtype=torch.float32,
                       device=x.device)[:, None] * freqs[None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    rot = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return rot.to(x.dtype)


def _block(x, lyr, cfg: TransformerConfig, scale: float):
    """One decoder layer: attention + residual, then the SwiGLU MLP or the
    MoE layer + residual.  Returns ``(x, aux)``: the MoE load-balancing
    loss, or None for a dense layer."""
    from ..parallel.ring_attention import blockwise_attention_local

    dt = cfg.compute_dtype
    B, T, _ = x.shape
    H, hd = cfg.n_heads, cfg.head_dim
    h = _rms_norm(x, lyr["attn_norm"].to(dt), cfg.norm_eps)
    q = (h @ lyr["wq"].to(dt)).reshape(B, T, H, hd).transpose(1, 2)
    k = (h @ lyr["wk"].to(dt)).reshape(B, T, H, hd).transpose(1, 2)
    v = (h @ lyr["wv"].to(dt)).reshape(B, T, H, hd).transpose(1, 2)
    q = _rope(q, cfg.rope_theta)
    k = _rope(k, cfg.rope_theta)
    o = blockwise_attention_local(q, k, v, scale, causal=True)
    o = o.transpose(1, 2).reshape(B, T, H * hd)
    x = x + o @ lyr["wo"].to(dt)
    h = _rms_norm(x, lyr["mlp_norm"].to(dt), cfg.norm_eps)
    if "moe" in lyr:
        out, aux = moe_ffn(lyr["moe"], h, top_k=cfg.top_k, compute_dtype=dt,
                           dispatch=cfg.moe_dispatch,
                           capacity_factor=cfg.capacity_factor)
        return x + out, aux
    gated = F.silu(h @ lyr["w1"].to(dt)) * (h @ lyr["w3"].to(dt))
    return x + gated @ lyr["w2"].to(dt), None


def _dots_policy(ctx, op, *args, **kwargs):
    """The "dots" policy: keep every 2-D product (the projections; JAX's
    ``dots_with_no_batch_dims_saveable``) and the flash forward's (o,
    lse) (JAX's ``"flash_out"``/``"flash_lse"``); recompute the rest."""
    if op in (torch.ops.aten.mm.default, torch.ops.mvt.flash_fwd.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _layer(x, lyr, cfg: TransformerConfig, scale: float):
    """:func:`_block`, checkpointed as ``cfg.remat_policy`` says."""
    if not cfg.remat:
        return _block(x, lyr, cfg, scale)
    if cfg.remat_policy == "dots":
        # The bf16 weight casts stay outside the checkpoint, so the
        # backward reuses them (the JAX package saves them as "wcast").
        dt = cfg.compute_dtype
        lyr = {k: (w.to(dt) if k in _WCAST_KEYS else w)
               for k, w in lyr.items()}
        context = partial(create_selective_checkpoint_contexts,
                          _dots_policy)
        return checkpoint(_block, x, lyr, cfg, scale, use_reentrant=False,
                          context_fn=context)
    if cfg.remat_policy == "full":
        return checkpoint(_block, x, lyr, cfg, scale, use_reentrant=False)
    raise ValueError(f"unknown remat_policy '{cfg.remat_policy}' "
                     "(expected 'full' or 'dots')")


def transformer_forward(params, tokens, cfg: TransformerConfig,
                        return_aux: bool = False):
    """tokens [B, T] (any integer dtype) → logits [B, T, vocab] in the
    compute dtype; with ``return_aux`` also the summed MoE load-balancing
    loss (float32, zero for a dense config)."""
    _check_ported(cfg)
    if tokens.shape[1] > cfg.max_seq:
        raise ValueError(
            f"sequence length {tokens.shape[1]} exceeds max_seq "
            f"{cfg.max_seq}")
    dt = cfg.compute_dtype
    x = params["embed"][tokens.long()].to(dt)            # [B,T,dim]
    scale = cfg.head_dim ** -0.5
    aux_total = torch.zeros((), device=x.device)
    for lyr in params["layers"]:
        x, aux = _layer(x, lyr, cfg, scale)
        if aux is not None:
            aux_total = aux_total + aux
    x = _rms_norm(x, params["out_norm"].to(dt), cfg.norm_eps)
    logits = x @ params["head"].to(dt)
    if return_aux:
        return logits, aux_total
    return logits


def _ce_value(logits, targets):
    lf = logits.float()
    logz = torch.logsumexp(lf, -1)
    ll = torch.gather(lf, -1, targets[..., None])[..., 0]
    return (logz - ll).mean()


class _CE(torch.autograd.Function):
    """Cross-entropy whose gradient is computed in float32 and cast to the
    LOGITS' dtype (the JAX package's ``_ce`` custom vjp): the head's
    backward products then run in bf16, and only the bf16 logits are kept
    for the backward."""

    @staticmethod
    def forward(ctx, logits, targets):
        ctx.save_for_backward(logits, targets)
        return _ce_value(logits, targets)

    @staticmethod
    def backward(ctx, g):
        logits, targets = ctx.saved_tensors
        B, T, _ = logits.shape
        d = torch.softmax(logits.float(), -1)
        d.scatter_add_(-1, targets[..., None],
                       torch.full(targets[..., None].shape, -1.0,
                                  device=d.device))
        d *= g / (B * T)
        return d.to(logits.dtype), None


def lm_loss(params, tokens, cfg: TransformerConfig):
    """Next-token cross-entropy, mean over all positions (float32), plus
    ``aux_loss_coef`` × the summed load-balancing loss for MoE configs.
    The ``_CE`` function serves heads of 16384 tokens and up, as in the
    JAX package; smaller heads differentiate ``_ce_value`` directly."""
    tokens = tokens.long()
    logits, aux = transformer_forward(params, tokens, cfg, return_aux=True)
    logits, targets = logits[:, :-1], tokens[:, 1:]
    if cfg.vocab_size >= 16384:
        ce = _CE.apply(logits, targets)
    else:
        ce = _ce_value(logits, targets)
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
    """

    def __init__(self, cfg: TransformerConfig, device=None,
                 updater_type: str = "sgd",
                 option: Optional[AddOption] = None, seed: int = 0,
                 params=None):
        _check_ported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.updater = get_updater(updater_type)
        self.option = option or AddOption(learning_rate=0.1)
        host = init_params(cfg, seed) if params is None else params
        self.params = params_from_jax(host, cfg, self.device)
        self.state = [self.updater.init_state(p.shape, p.dtype, p.device)
                      for p in _leaves(self.params)]

    def _tokens(self, tokens) -> torch.Tensor:
        if not isinstance(tokens, torch.Tensor):
            tokens = torch.as_tensor(np.asarray(tokens))
        return tokens.to(self.device).long()

    def train_step_async(self, tokens, accum: int = 1) -> torch.Tensor:
        """One step; returns the loss as a device tensor (no host sync).

        ``accum > 1`` splits the batch into that many equal microbatches,
        sums their float32 gradients, divides by ``accum`` and applies
        one update: the full-batch step (the loss is a mean over equal
        chunks) with one microbatch's activations alive at a time.  The
        loss returned is the mean of the chunks' losses.  MoE configs
        refuse it, as in the JAX package."""
        cfg = self.cfg
        if accum > 1 and cfg.num_experts:
            raise ValueError(
                "grad accumulation is not equivalence-preserving for MoE "
                "configs (batch-nonlinear aux loss, capacity buckets "
                "sized from the microbatch); run MoE at full batch")
        tokens = self._tokens(tokens)
        B = tokens.shape[0]
        if B % accum:
            raise ValueError(f"batch {B} not divisible by accum {accum}")
        leaves = [p.detach().requires_grad_() for p in _leaves(self.params)]
        params = _with_leaves(self.params, leaves)
        grads, losses = None, []
        for chunk in tokens.reshape(accum, B // accum, -1):
            loss = lm_loss(params, chunk, cfg)
            g = torch.autograd.grad(loss, leaves)
            grads = g if grads is None else [a + b for a, b in zip(grads, g)]
            losses.append(loss.detach())
        if accum > 1:
            grads = [g / accum for g in grads]
            loss = torch.stack(losses).mean()
        with torch.no_grad():
            out = [self.updater.apply_dense(p.detach(), s, g, self.option)
                   for p, s, g in zip(leaves, self.state, grads)]
        self.params = _with_leaves(self.params, [p for p, _ in out])
        self.state = [s for _, s in out]
        return loss.detach()

    def train_step(self, tokens) -> float:
        with dashboard.monitor("Transformer::train_step"):
            return float(self.train_step_async(tokens))

    def train_steps_fused(self, tokens, n: int) -> torch.Tensor:
        """``n`` steps on one batch; returns the last device loss.  The
        JAX package fuses them into one compiled program; here they are
        a loop of eager steps with no host sync between them."""
        tokens = self._tokens(tokens)
        loss = torch.zeros((), device=self.device)
        for _ in range(n):
            loss = self.train_step_async(tokens)
        return loss

    def loss(self, tokens) -> float:
        with torch.no_grad():
            return float(lm_loss(self.params, self._tokens(tokens),
                                 self.cfg))

    def offload_state(self, bridge) -> None:
        raise NotImplementedError(
            "optimizer-state offload is not ported yet (ROADMAP.md Queue "
            "1, \"Modules that need the native runtime\": "
            "parallel/offload.py)")

    def _tree(self) -> Dict[str, Any]:
        """``{"params", "state"}`` in the JAX trainer's layout, loop
        format: the state mirrors the params with a tuple of updater
        slots at each leaf."""
        return {"params": self.params,
                "state": _with_leaves(self.params, self.state)}

    def save(self, uri: str) -> None:
        """Snapshot params + updater state (rank-0 atomic write, the
        durability of the table checkpoints) as the JAX trainer of the
        same config writes it: layers stacked ``[L, ...]`` under
        ``scan_layers``, a list otherwise."""
        from .. import checkpoint

        tree = self._tree()
        if self.cfg.scan_layers:
            tree = _stacked(tree)
        checkpoint.save_pytree(uri, tree)

    def restore(self, uri: str) -> None:
        """Load a snapshot written by either package's trainer for this
        config and updater, in loop or stacked format, onto this
        trainer's device.  A snapshot of another structure raises
        ``ValueError``."""
        from .. import checkpoint

        snap = checkpoint.restore_pytree(uri)
        try:
            for sub in snap.values():
                if isinstance(sub["layers"], dict):
                    sub["layers"] = unstack_layer_params(sub["layers"],
                                                         self.cfg.n_layers)
        except (AttributeError, KeyError, TypeError) as exc:
            raise ValueError(f"{uri}: snapshot tree structure is not a "
                             f"trainer's: {exc}") from exc
        placed = checkpoint.place_pytree(snap, self._tree(), uri)
        self.params = placed["params"]
        self.state = _leaves(placed["state"])
