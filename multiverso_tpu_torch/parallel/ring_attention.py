"""Attention for the PyTorch port: single-device and the sequence-
parallel ring.

Port of ``multiverso_tpu/parallel/ring_attention.py``.  The JAX
dispatcher chose between the Pallas kernel and a jnp fallback by
backend, block fit and the ``MVTPU_FORCE_FLASH`` / ``MVTPU_NO_FLASH``
switches.  Here the choice is the tensor's: aligned local attention and
every ring piece go through :func:`..ops.flash_attention`, whose wrappers
launch the Hopper kernels for a CUDA tensor and run their plain versions
for a CPU tensor.  The kernels bound-check any T, so no block-fit gate
remains.  ``_online_block`` stays for offset blocks.

The ring (``sp > 1``, ``:150-324``): each rank holds its sequence shard
of q, k and v and passes the k/v blocks round the ring, one
:func:`.collectives.ring_rotate` per step, ``sp - 1`` rotations in all
(JAX's harmless last rotation would leave an output whose backward never
runs, and the ring's point-to-point pairs would fall out of step).  Each
step computes a normalized ``(o, lse)`` piece with the flash kernels and
folds it in with the logsumexp identity; the lse cotangent that the fold
feeds back enters the kernels' backward through Δ.  The contiguous
layout skips fully masked steps; the zigzag layout gives rank d the chunk
pair (d, 2sp-1-d), so every step after the first computes two unmasked
c x c blocks' worth.  A fully masked step contributes nothing and is not
folded in at all, so no ``-inf`` (nor JAX's finite ``-1e30`` stand-in)
lse ever reaches ``logaddexp``.

:func:`ring_attention_shard` is one rank's schedule, with its rotation
passed in: the real ring passes :func:`.collectives.ring_rotate`;
:class:`InProcessRing` runs every rank's schedule in one process (how the
card checks the ring's compute on one device).  :func:`ring_attention`
takes and returns global arrays, as the JAX function does.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.flash_attention import flash_attention

__all__ = ["blockwise_attention_local", "ring_attention",
           "ring_attention_shard", "sequence_positions", "InProcessRing"]

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




def _combine_pieces(o_acc, lse_acc, o_i, lse_i):
    """Fold one (o, lse) piece into the float32 accumulators."""
    new_lse = torch.logaddexp(lse_acc, lse_i)
    o_acc = (o_acc.float() * torch.exp(lse_acc - new_lse)[..., None]
             + o_i.float() * torch.exp(lse_i - new_lse)[..., None])
    return o_acc, new_lse


def _use_zigzag(t_global: int, sp: int, causal: bool, layout: str) -> bool:
    """The layout choice and its errors, as the JAX package words them."""
    if layout not in ("auto", "zigzag", "contiguous"):
        raise ValueError(
            f"unknown layout '{layout}'; expected auto|zigzag|contiguous")
    use = (sp > 1 and causal and t_global % (2 * sp) == 0
           and layout in ("auto", "zigzag"))
    if layout == "zigzag" and not use:
        raise ValueError(
            f"zigzag layout needs sp > 1 (got {sp}), causal=True (got "
            f"{causal}), and T ({t_global}) divisible by 2*sp ({2 * sp})")
    return use


def sequence_positions(t_global: int, sp: int, index: int, zigzag: bool,
                       device=None) -> torch.Tensor:
    """The global positions rank ``index`` of an ``sp`` ring holds, in its
    local order: one contiguous block, or the zigzag chunk pair (index,
    2sp-1-index)."""
    if t_global % (2 * sp if zigzag else sp):
        raise ValueError(f"sequence length {t_global} does not divide "
                         f"over sp ({sp})")
    if zigzag:
        c = t_global // (2 * sp)
        pos = np.r_[index * c:(index + 1) * c,
                    (2 * sp - 1 - index) * c:(2 * sp - index) * c]
    else:
        n = t_global // sp
        pos = np.arange(index * n, (index + 1) * n)
    return torch.as_tensor(pos, dtype=torch.long, device=device)


def ring_attention_shard(q, k, v, index: int, size: int,
                         rotate: Optional[Callable] = None,
                         causal: bool = True,
                         scale: Optional[float] = None,
                         zigzag: bool = False):
    """Rank ``index``'s schedule of an ``size``-rank ring: q/k/v [B, H, t,
    D] are its sequence shard (``sequence_positions`` order) → ``(o [B,
    H, t, D] in q's dtype, lse [B, H, t] float32)``.

    ``rotate(k, v)`` returns the k/v blocks one rank further back round
    the ring; the schedule calls it ``size - 1`` times, between its
    steps.  Step i works on the blocks of rank ``src = (index - i) %
    size``.  Contiguous: the causal diagonal first, then a full piece for
    each ``src < index``; blocks with ``src > index`` are fully masked and
    skipped (non-causal attention takes a full piece every step).
    Zigzag (t = 2c, causal only): the self step's three aligned pieces
    (low chunk causal; high chunk over the low keys in full and its own
    causally), then for ``src < index`` both chunks over src's low keys
    (a 2c x c piece) and for ``src > index`` the high chunk over both of
    src's chunks (c x 2c)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if size > 1 and rotate is None:
        raise ValueError("a ring of more than one rank needs a rotate")
    if zigzag:
        return _zigzag_shard(q, k, v, index, size, rotate, scale)
    acc = None
    for i in range(size):
        if i:
            k, v = rotate(k, v)
        src = (index - i) % size
        if causal and src > index:
            continue                     # fully masked: nothing to add
        piece = _attn_piece(q, k, v, scale, causal and src == index)
        acc = piece if acc is None else _combine_pieces(*acc, *piece)
    o, lse = acc
    if size > 1 and causal and index < size - 1:
        # The last steps were masked, so their rotations' outputs feed no
        # piece; tie them in, or those rotations' backward would never
        # run here while the other ranks' wait for it.
        o = _Tie.apply(o, k, v)
    return o.to(q.dtype), lse


class _Tie(torch.autograd.Function):
    """``o`` itself, with ``k`` and ``v`` on its backward path (zero
    gradients)."""

    @staticmethod
    def forward(ctx, o, k, v):
        ctx.like = [(t.shape, t.dtype) for t in (k, v)]
        return o.view_as(o)

    @staticmethod
    def backward(ctx, g):
        return (g, *(g.new_zeros(shape, dtype=dtype)
                     for shape, dtype in ctx.like))


def _zigzag_shard(q, k, v, index, size, rotate, scale):
    c = q.shape[2] // 2
    ql, qh = q[:, :, :c], q[:, :, c:]
    lo = _attn_piece(ql, k[:, :, :c], v[:, :, :c], scale, True)
    h1 = _attn_piece(qh, k[:, :, :c], v[:, :, :c], scale, False)
    h2 = _attn_piece(qh, k[:, :, c:], v[:, :, c:], scale, True)
    o_hi, lse_hi = _combine_pieces(*h1, *h2)
    # The self step's output rounds to q's dtype before the fold, as the
    # JAX package's does.
    hi = (o_hi.to(q.dtype), lse_hi)
    for i in range(1, size):
        k, v = rotate(k, v)
        src = (index - i) % size
        if src < index:
            o_i, lse_i = _attn_piece(q, k[:, :, :c], v[:, :, :c], scale,
                                     False)
            lo = _combine_pieces(*lo, o_i[:, :, :c], lse_i[:, :, :c])
            hi = _combine_pieces(*hi, o_i[:, :, c:], lse_i[:, :, c:])
        else:
            hi = _combine_pieces(*hi, *_attn_piece(qh, k, v, scale, False))
    o = torch.cat([lo[0].to(q.dtype), hi[0].to(q.dtype)], 2)
    return o, torch.cat([lo[1], hi[1]], 2)


class InProcessRing:
    """Every rank of an ``sp`` ring, run one after another in one process.

    ``k_blocks``/``v_blocks`` are each rank's shard.  The rotation that
    :meth:`rotate_for` gives rank ``index`` returns, at its i-th call, the
    blocks rank ``index - i`` holds: what the real ring delivers there.
    The blocks are the same tensors, so gradients reach their owners as
    the real ring's reverse rotation sends them.  ``shift`` hands every
    call the blocks of a rank further back (a planted fault)."""

    def __init__(self, k_blocks: Sequence[torch.Tensor],
                 v_blocks: Sequence[torch.Tensor], shift: int = 0):
        self.k_blocks, self.v_blocks = list(k_blocks), list(v_blocks)
        self.shift = shift

    @property
    def size(self) -> int:
        return len(self.k_blocks)

    def rotate_for(self, index: int) -> Callable:
        calls = [0]

        def rotate(k, v):
            calls[0] += 1
            src = (index - calls[0] - self.shift) % self.size
            return self.k_blocks[src], self.v_blocks[src]

        return rotate

    def run(self, q_blocks: Sequence[torch.Tensor], causal: bool = True,
            scale: Optional[float] = None, zigzag: bool = False
            ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        """Each rank's ``(o, lse)``, in rank order."""
        return [ring_attention_shard(
            q, self.k_blocks[r], self.v_blocks[r], r, self.size,
            self.rotate_for(r), causal, scale, zigzag)
            for r, q in enumerate(q_blocks)]


def ring_attention(q, k, v, mesh=None, axis_name: str = "sp",
                   causal: bool = True,
                   batch_axis: Optional[str] = "dp",
                   head_axis: Optional[str] = "tp",
                   scale: Optional[float] = None,
                   layout: str = "auto"):
    """Attention with sequences sharded over ``axis_name`` of ``mesh``
    (a :class:`.sharding.Mesh`; every rank passes the same global [B, H,
    T, D] q/k/v and gets the global [B, H, T, D] output, as from the JAX
    function).  Each rank runs :func:`ring_attention_shard` on its batch
    rows (over ``batch_axis``), heads (over ``head_axis``) and sequence
    shard, and the output is gathered back.  ``layout`` as in the JAX
    package: ``"auto"`` picks zigzag for causal attention whenever 2·sp
    divides T.  Without a mesh, or on a mesh of one rank per axis, this
    is :func:`blockwise_attention_local`.  The gather has no backward:
    differentiate through :func:`ring_attention_shard` on local shards,
    as the transformer does."""
    from .collectives import ring_rotate
    from .sharding import gather_full, local_shard

    if scale is None:
        scale = q.shape[-1] ** -0.5
    sp = 1 if mesh is None else mesh.size(axis_name)
    b_ax = batch_axis if (mesh is not None and batch_axis
                          and batch_axis in mesh) else None
    h_ax = head_axis if (mesh is not None and head_axis
                         and head_axis in mesh) else None
    if sp == 1 and b_ax is None and h_ax is None:
        return blockwise_attention_local(q, k, v, scale, causal)
    zigzag = _use_zigzag(q.shape[2], sp, causal, layout)
    if sp == 1:
        return blockwise_attention_local(q, k, v, scale, causal)
    pos = sequence_positions(q.shape[2], sp, mesh.index(axis_name), zigzag,
                             q.device)

    def shard(x):
        for dim, axis in ((0, b_ax), (1, h_ax)):
            if axis is not None:
                x = local_shard(x, dim, axis, mesh)
        return x.index_select(2, pos)

    o, _ = ring_attention_shard(shard(q), shard(k), shard(v),
                                mesh.index(axis_name), sp,
                                ring_rotate(mesh, axis_name), causal, scale,
                                zigzag)
    held = gather_full(pos, 0, axis_name, mesh)
    o = gather_full(o, 2, axis_name, mesh)
    o = torch.empty_like(o).index_copy_(2, held, o)
    for dim, axis in ((1, h_ax), (0, b_ax)):
        if axis is not None:
            o = gather_full(o, dim, axis, mesh)
    return o
