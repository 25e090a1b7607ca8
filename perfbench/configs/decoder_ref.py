"""Plain reference of the decoder the trainer cells run, and its training.

A pre-norm decoder with RMSNorm, rotary embeddings (half-split), causal
multi-head attention, a SwiGLU MLP and an untied head, trained on the
next-token cross-entropy (the mean over B·(T-1) positions) by momentum
SGD on float32 masters (v = mu·v + lr·g; w -= v) applied to every leaf.
Written from the configuration alone, in float32 with TF32 off; it
imports nothing of the program and takes only the weights and tokens
the benchmark made.

``precision="fp8"`` is the control: every matrix product rounds its two
operands to float8 e4m3 (a scale a tensor, its largest magnitude mapped
to 448) in the forward and in the backward, and sums in float32.

Memory: each layer is checkpointed and attention runs in blocks of
query rows, so a step at 16,384 tokens fits beside the weights, their
gradients and the momentum.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

LAYER_KEYS = ("wq", "wk", "wv", "wo", "w1", "w2", "w3", "attn_norm",
              "mlp_norm")
_FP8_MAX = 448.0


def leaf_shapes(model: dict) -> List[Tuple[str, Tuple[int, ...]]]:
    """Every leaf's name and shape, in one fixed order (matrices [in,
    out], applied as h @ w)."""
    d, f, v = (model["hidden_size"], model["intermediate_size"],
               model["vocab_size"])
    out = [("embed", (v, d)), ("out_norm", (d,)), ("head", (d, v))]
    for i in range(model["num_hidden_layers"]):
        shapes = {"wq": (d, d), "wk": (d, d), "wv": (d, d), "wo": (d, d),
                  "w1": (d, f), "w2": (f, d), "w3": (d, f),
                  "attn_norm": (d,), "mlp_norm": (d,)}
        out += [(f"layers.{i}.{k}", shapes[k]) for k in LAYER_KEYS]
    return out


def _fp8(x: torch.Tensor) -> torch.Tensor:
    scale = x.detach().abs().amax().float().clamp_min(1e-30) / _FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale


class _Fp8Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        a8, b8 = _fp8(a), _fp8(b)
        ctx.save_for_backward(a8, b8)
        return a8 @ b8

    @staticmethod
    def backward(ctx, g):
        a8, b8 = ctx.saved_tensors
        g8 = _fp8(g)
        return g8 @ b8.transpose(-1, -2), a8.transpose(-1, -2) @ g8


def _mm(a, b, precision: str):
    if precision != "fp8":
        return a @ b
    if b.dim() == 2:      # a weight: fold a's leading dims into its rows
        out = _Fp8Matmul.apply(a.reshape(-1, a.shape[-1]), b)
        return out.reshape(*a.shape[:-1], b.shape[-1])
    return _Fp8Matmul.apply(a, b)


def _rms(x, g, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * g


def _rope(x, theta: float):
    T, D = x.shape[-2], x.shape[-1]
    half = D // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float64,
                                    device=x.device) / half)
    ang = torch.arange(T, dtype=torch.float64, device=x.device)[:, None] \
        * freqs[None, :]
    cos, sin = ang.cos().to(x.dtype), ang.sin().to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)


def _attention(q, k, v, precision: str, block: int):
    """Causal softmax attention, [B, H, T, D], in blocks of ``block``
    query rows, each over the keys up to its last row."""
    T = q.shape[2]
    scale = q.shape[-1] ** -0.5
    out = []
    for lo in range(0, T, block):
        hi = min(T, lo + block)
        s = _mm(q[:, :, lo:hi], k[:, :, :hi].transpose(-1, -2),
                precision) * scale
        rows = torch.arange(lo, hi, device=q.device)[:, None]
        cols = torch.arange(hi, device=q.device)[None, :]
        s = s.masked_fill(cols > rows, float("-inf"))
        out.append(_mm(torch.softmax(s, -1), v[:, :, :hi], precision))
    return torch.cat(out, 2)


def _layer(x, w: Dict[str, torch.Tensor], model: dict, precision: str,
           block: int):
    B, T, d = x.shape
    H = model["num_attention_heads"]
    hd = model["head_dim"]
    eps, theta = model["rms_norm_eps"], float(model["rope_theta"])

    def heads(t):
        return t.reshape(B, T, H, hd).transpose(1, 2)

    h = _rms(x, w["attn_norm"], eps)
    q = _rope(heads(_mm(h, w["wq"], precision)), theta)
    k = _rope(heads(_mm(h, w["wk"], precision)), theta)
    v = heads(_mm(h, w["wv"], precision))
    o = _attention(q, k, v, precision, block).transpose(1, 2)
    x = x + _mm(o.reshape(B, T, H * hd), w["wo"], precision)
    h = _rms(x, w["mlp_norm"], eps)
    gated = F.silu(_mm(h, w["w1"], precision)) * _mm(h, w["w3"], precision)
    return x + _mm(gated, w["w2"], precision)


def loss_fn(params: Dict[str, torch.Tensor], tokens: torch.Tensor,
            model: dict, precision: str = "fp32", block: int = 2048):
    """Mean next-token cross-entropy of ``tokens`` [B, T]."""
    x = params["embed"][tokens]
    for i in range(model["num_hidden_layers"]):
        w = {k: params[f"layers.{i}.{k}"] for k in LAYER_KEYS}
        x = checkpoint(_layer, x, w, model, precision, block,
                       use_reentrant=False)
    x = _rms(x, params["out_norm"], model["rms_norm_eps"])
    B, T, _ = x.shape
    logits = _mm(x[:, :-1].reshape(B * (T - 1), -1), params["head"],
                 precision)
    return F.cross_entropy(logits, tokens[:, 1:].reshape(-1))


def train(flat: torch.Tensor, model: dict, batches: List[torch.Tensor],
          lr: float, momentum: float, precision: str = "fp32",
          block: int = 2048) -> dict:
    """Momentum SGD from the float32 masters ``flat`` (every leaf of
    ``leaf_shapes`` in order, one buffer) over ``batches``: the loss of
    each step, each leaf's first gradient norm and each leaf's change
    after the last step.  ``flat`` is trained in place."""
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return _train(flat, model, batches, lr, momentum, precision, block)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32


def views(flat, shapes):
    """``flat`` as a dict of leaf views (``leaf_shapes`` order)."""
    out, at = {}, 0
    for name, shape in shapes:
        n = math.prod(shape)
        out[name] = flat[at:at + n].view(shape)
        at += n
    return out


def _norms(flat, shapes) -> Dict[str, float]:
    """Each leaf's 2-norm, summed in float64."""
    return {n: float(torch.linalg.vector_norm(t, dtype=torch.float64))
            for n, t in views(flat, shapes).items()}


def _train(flat, model, batches, lr, momentum, precision, block):
    shapes = leaf_shapes(model)
    start = flat.detach().clone()
    vel = torch.zeros_like(flat)
    losses, grad = [], None
    for tokens in batches:
        w = flat.detach().requires_grad_()
        loss = loss_fn(views(w, shapes), tokens, model, precision, block)
        (g,) = torch.autograd.grad(loss, [w])
        losses.append(float(loss.detach()))
        if grad is None:
            grad = _norms(g, shapes)
        with torch.no_grad():
            vel.mul_(momentum).add_(g, alpha=lr)
            flat.sub_(vel)
        del g, loss, w
    change = _norms(flat - start, shapes)
    return {"loss": losses, "grad": grad, "change": change}
