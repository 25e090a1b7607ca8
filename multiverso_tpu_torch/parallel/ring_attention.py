"""Single-device attention for the PyTorch port.

Port of the local half of ``multiverso_tpu/parallel/ring_attention.py``
(``_online_block``, ``blockwise_attention_local``, ``_attn_piece``,
``:35-147``).  The JAX dispatcher chose between the Pallas kernel and a
jnp fallback by backend, block fit and the ``MVTPU_FORCE_FLASH`` /
``MVTPU_NO_FLASH`` switches.  Here the choice is the tensor's: aligned
local attention always goes through :func:`..ops.flash_attention`, whose
wrappers launch the Hopper kernels for a CUDA tensor and run their plain
versions for a CPU tensor.  The kernels bound-check any T, so no
block-fit gate remains.  ``_online_block`` stays for offset blocks.

The sequence-parallel ring (``sp > 1``, ``:150-324``) is not ported yet.
"""

from __future__ import annotations

import torch

from ..ops.flash_attention import flash_attention

__all__ = ["blockwise_attention_local", "ring_attention"]

_NEG = -1e30  # finite mask sentinel: exp(_NEG - m) underflows to exactly 0


def _online_block(q, k_blk, v_blk, o, m, l, q_pos, k_pos, scale, causal):
    """One streaming-softmax accumulation step over a K/V block.

    q [B,H,T,D]; k_blk/v_blk [B,H,Tb,D]; o [B,H,T,D] f32; m,l [B,H,T,1]
    f32; q_pos [T], k_pos [Tb] are GLOBAL positions for causal masking.
    The block product runs in the compute dtype; the softmax statistics
    and the output accumulate in float32.
    """
    s = torch.einsum("bhtd,bhsd->bhts", q, k_blk).float() * scale
    if causal:
        mask = q_pos[:, None] >= k_pos[None, :]                # [T,Tb]
        s = torch.where(mask[None, None], s, torch.full_like(s, _NEG))
    new_m = torch.maximum(m, s.amax(-1, keepdim=True))
    p = torch.exp(s - new_m)
    corr = torch.exp(m - new_m)
    l = l * corr + p.sum(-1, keepdim=True)
    o = o * corr + torch.einsum("bhts,bhsd->bhtd", p.to(v_blk.dtype),
                                v_blk).float()
    return o, new_m, l


def _streaming(q, k, v, scale, causal, q_offset=0, k_offset=0):
    B, H, T, _ = q.shape
    o = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    m = torch.full((B, H, T, 1), _NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, T, 1), dtype=torch.float32, device=q.device)
    q_pos = q_offset + torch.arange(T, device=q.device)
    k_pos = k_offset + torch.arange(k.shape[2], device=q.device)
    return _online_block(q, k, v, o, m, l, q_pos, k_pos, scale, causal)


def blockwise_attention_local(q, k, v, scale: float, causal: bool = True,
                              q_offset: int = 0, k_offset: int = 0):
    """Single-device attention (the ring's degenerate case), q/k/v
    [B,H,T,D] → [B,H,T,D] in q's dtype.

    Aligned blocks (no offsets, Tq == Tk) take the flash path: the Hopper
    kernels on the card, their plain versions on the CPU.  Offset blocks
    take the streaming-softmax path."""
    if q_offset == 0 and k_offset == 0 and q.shape[2] == k.shape[2]:
        return flash_attention(q, k, v, scale=scale, causal=causal)
    o, _, l = _streaming(q, k, v, scale, causal, q_offset, k_offset)
    return (o / l.clamp_min(1e-30)).to(q.dtype)


def _attn_piece(q, k, v, scale, causal: bool):
    """Normalized attention over one K/V block plus its row logsumexp:
    ``(o [B,H,Tq,D] in q.dtype, lse [B,H,Tq] float32)`` — the pieces the
    ring combines with ``lse' = logaddexp(lse1, lse2)``."""
    return flash_attention(q, k, v, scale=scale, causal=causal,
                           return_lse=True)


def ring_attention(*args, **kwargs):
    """Sequence-parallel ring attention (``sp > 1``) is not ported yet."""
    raise NotImplementedError(
        "ring attention over an sp > 1 axis is not ported yet "
        "(ROADMAP.md Queue 1, \"Several processes\")")
