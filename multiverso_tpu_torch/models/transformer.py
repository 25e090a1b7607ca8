"""Llama-style decoder-only transformer for the PyTorch port.

Port of ``multiverso_tpu/models/transformer.py``: plain functions over a
dictionary of float32 master weights, bfloat16 compute, and a trainer
that applies the framework's server-side updaters to every parameter
leaf — so ``updater_type`` means the same thing as in the JAX package.

The parameter names and layouts are the JAX package's (``embed``,
``head``, ``out_norm`` and per layer ``wq wk wv wo w1 w2 w3 attn_norm
mlp_norm``, each matrix ``[in, out]`` and applied as ``h @ w``), so
:func:`params_from_jax` carries weights across leaf by leaf.  The layers
are always a list here; ``scan_layers=True`` is accepted and runs the
same Python loop (the converter unstacks ``[L, ...]`` leaves).

Attention goes through ``parallel.ring_attention.blockwise_attention_
local`` into the flash kernels.  Not ported yet, each raising
``NotImplementedError`` that names its ROADMAP item: MoE layers,
pipeline microbatches, sequence-parallel rings, gradient accumulation,
remat and state offload.  Trainer checkpoints (``save``/``restore``) go
through ``checkpoint.save_pytree``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .. import dashboard
from ..device import resolve_device
from ..updaters import AddOption, get_updater

__all__ = ["TransformerConfig", "init_params", "stack_layer_params",
           "params_from_jax", "transformer_forward", "lm_loss",
           "TransformerTrainer"]

_LAYER_KEYS = ("wq", "wk", "wv", "wo", "w1", "w2", "w3", "attn_norm",
               "mlp_norm")
_ROADMAP = 'ROADMAP.md Queue 1, "The rest of the transformer on one device"'


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
    # Kept from the JAX config so the same settings name the same model;
    # the port raises on the first three until their ROADMAP item lands.
    num_experts: int = 0
    remat: bool = False
    pipeline_microbatches: int = 0
    scan_layers: bool = False   # accepted: the layers run as a loop

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads


def _check_ported(cfg: TransformerConfig) -> None:
    for on, what in ((cfg.num_experts > 0, "mixture-of-experts layers "
                      "(num_experts > 0)"),
                     (cfg.pipeline_microbatches > 0, "pipeline parallelism "
                      "(pipeline_microbatches > 0)"),
                     (cfg.remat, "remat (activation checkpointing)")):
        if on:
            raise NotImplementedError(
                f"{what} is not ported to multiverso_tpu_torch yet "
                f"({_ROADMAP})")


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
        layers.append({
            "wq": w(cfg.dim, cfg.dim),
            "wk": w(cfg.dim, cfg.dim),
            "wv": w(cfg.dim, cfg.dim),
            "wo": w(cfg.dim, cfg.dim),
            "attn_norm": torch.ones(cfg.dim),
            "mlp_norm": torch.ones(cfg.dim),
            "w1": w(cfg.dim, cfg.hidden),   # gate
            "w3": w(cfg.dim, cfg.hidden),   # up
            "w2": w(cfg.hidden, cfg.dim),   # down
        })
    return {
        "embed": w(cfg.vocab_size, cfg.dim, scale=0.02),
        "out_norm": torch.ones(cfg.dim),
        "head": w(cfg.dim, cfg.vocab_size),
        "layers": layers,
    }


def stack_layer_params(layers: List[Dict[str, torch.Tensor]]
                       ) -> Dict[str, torch.Tensor]:
    """List of per-layer dicts → one dict of stacked ``[L, ...]``
    tensors (the JAX package's scan format)."""
    return {key: torch.stack([lyr[key] for lyr in layers])
            for key in layers[0]}


def params_from_jax(host_params, cfg: TransformerConfig,
                    device=None) -> Dict[str, Any]:
    """The JAX package's parameter tree (``init_params`` output, or a
    trainer's ``params`` pulled to numpy), in loop or stacked ``[L, ...]``
    format → the port's parameters: float32 tensors on ``device``, names
    and ``[in, out]`` layouts unchanged, layers as a list."""
    dev = resolve_device(device)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32)).to(dev)

    layers = host_params["layers"]
    if isinstance(layers, dict):           # stacked [L, ...] (scan format)
        layers = [{key: layers[key][i] for key in _LAYER_KEYS}
                  for i in range(cfg.n_layers)]
    if len(layers) != cfg.n_layers:
        raise ValueError(f"{len(layers)} layers for a config with "
                         f"{cfg.n_layers}")
    return {
        "embed": t(host_params["embed"]),
        "out_norm": t(host_params["out_norm"]),
        "head": t(host_params["head"]),
        "layers": [{key: t(lyr[key]) for key in _LAYER_KEYS}
                   for lyr in layers],
    }


def _leaves(params) -> List[torch.Tensor]:
    """Every parameter tensor in one fixed order."""
    out = [params["embed"], params["out_norm"], params["head"]]
    for lyr in params["layers"]:
        out.extend(lyr[key] for key in _LAYER_KEYS)
    return out


def _with_leaves(params, leaves: List[torch.Tensor]) -> Dict[str, Any]:
    it = iter(leaves)
    out = {"embed": next(it), "out_norm": next(it), "head": next(it)}
    out["layers"] = [{key: next(it) for key in _LAYER_KEYS}
                     for _ in params["layers"]]
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
    """One decoder layer: attention + residual, SwiGLU MLP + residual."""
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
    gated = F.silu(h @ lyr["w1"].to(dt)) * (h @ lyr["w3"].to(dt))
    return x + gated @ lyr["w2"].to(dt)


def transformer_forward(params, tokens, cfg: TransformerConfig):
    """tokens [B, T] (any integer dtype) → logits [B, T, vocab] in the
    compute dtype."""
    _check_ported(cfg)
    if tokens.shape[1] > cfg.max_seq:
        raise ValueError(
            f"sequence length {tokens.shape[1]} exceeds max_seq "
            f"{cfg.max_seq}")
    dt = cfg.compute_dtype
    x = params["embed"][tokens.long()].to(dt)            # [B,T,dim]
    scale = cfg.head_dim ** -0.5
    for lyr in params["layers"]:
        x = _block(x, lyr, cfg, scale)
    x = _rms_norm(x, params["out_norm"].to(dt), cfg.norm_eps)
    return x @ params["head"].to(dt)


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
    """Next-token cross-entropy, mean over all positions (float32).  The
    ``_CE`` function serves heads of 16384 tokens and up, as in the JAX
    package; smaller heads differentiate ``_ce_value`` directly."""
    tokens = tokens.long()
    logits = transformer_forward(params, tokens, cfg)
    logits, targets = logits[:, :-1], tokens[:, 1:]
    if cfg.vocab_size >= 16384:
        return _CE.apply(logits, targets)
    return _ce_value(logits, targets)


class TransformerTrainer:
    """LM training through the framework's updaters.

    The parameter dictionary is the "table": float32 master weights,
    updated by the same Updater the tables use — the reference's
    server-side optimizer semantics at transformer scale.  Gradients are
    taken with respect to the float32 masters through the compute-dtype
    casts, and the updater applies to every leaf, embeddings and norms
    included.
    """

    def __init__(self, cfg: TransformerConfig, device=None,
                 updater_type: str = "sgd",
                 option: Optional[AddOption] = None, seed: int = 0):
        _check_ported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.updater = get_updater(updater_type)
        self.option = option or AddOption(learning_rate=0.1)
        host = init_params(cfg, seed)
        self.params = _with_leaves(
            host, [p.to(self.device) for p in _leaves(host)])
        self.state = [self.updater.init_state(p.shape, p.dtype, p.device)
                      for p in _leaves(self.params)]

    def _tokens(self, tokens) -> torch.Tensor:
        if not isinstance(tokens, torch.Tensor):
            tokens = torch.as_tensor(np.asarray(tokens))
        return tokens.to(self.device).long()

    def train_step_async(self, tokens, accum: int = 1) -> torch.Tensor:
        """One step; returns the loss as a device tensor (no host sync)."""
        if accum != 1:
            raise NotImplementedError(
                f"gradient accumulation (accum > 1) is not ported yet "
                f"({_ROADMAP})")
        leaves = [p.detach().requires_grad_() for p in _leaves(self.params)]
        loss = lm_loss(_with_leaves(self.params, leaves),
                       self._tokens(tokens), self.cfg)
        grads = torch.autograd.grad(loss, leaves)
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

    def save(self, uri: str) -> None:
        """Snapshot params + updater state (rank-0 atomic write, the
        durability of the table checkpoints)."""
        from .. import checkpoint

        checkpoint.save_pytree(uri, {"params": self.params,
                                     "state": self.state})

    def restore(self, uri: str) -> None:
        """Load a snapshot of this trainer's config and updater onto its
        device (leaves land where the current ones live)."""
        from .. import checkpoint

        snap = checkpoint.restore_pytree(
            uri, like={"params": self.params, "state": self.state})
        self.params = snap["params"]
        self.state = [tuple(s) for s in snap["state"]]
