"""Autograd-aware collectives over a :class:`~.sharding.Mesh`.

In the JAX package GSPMD inserts these collectives (and ``shard_map``
bodies call ``psum``/``ppermute``, whose transposes JAX derives).  Here
each is a ``torch.autograd.Function`` with its backward written out:

- the Megatron pair: :func:`copy_to` is the identity forward and an
  all-reduce backward (before a column-parallel matmul); :func:`reduce_from`
  is an all-reduce forward and the identity backward (after a
  row-parallel matmul);
- :func:`ring_rotate`: (k, v) to the next rank of the ring and from the
  previous one, in ONE batch of point-to-point operations (two separate
  chains could run their backward nodes in different orders on different
  ranks, and NCCL pairs point-to-point calls by order); the backward
  rotates (dk, dv) the other way;
- :func:`send_forward` / :func:`recv_forward`: the pipeline's hand-over of
  an activation to the next stage, whose backward sends its gradient
  back;
- :func:`broadcast_from_last`: the pipeline's outputs from the last stage
  to every stage;
- :func:`all_reduce_grads`: a sum over a set of axes, in place, in
  flat buckets over one group for the product of the axes;
- :func:`reduce_over`: a sum over the product of a set of axes with the
  identity backward (``reduce_from`` over several axes at once): the MoE
  layer's routing statistics over dp and sp, whose gradient each rank
  takes for its own tokens;
- :func:`gather_routes`: every rank's routes (integers, no gradient)
  over a set of axes, placed at their global positions (one all-reduce
  of the ranks' disjoint parts): the MoE capacity plan's expert ids in
  the global token order.

Every rank of a group must call the same collectives in the same order,
forward and backward; the functions here keep that true of their
backward by construction (one node per exchange).  Tensors on the card
go over NCCL, CPU tensors over gloo: the group's backend decides, and
nothing falls back.
"""

from __future__ import annotations

from typing import Iterable, List, Sequence, Tuple

import torch
import torch.distributed as dist

__all__ = ["copy_to", "reduce_from", "reduce_over", "gather_routes",
           "all_reduce_max", "all_reduce_sum", "ring_rotate", "send_forward",
           "recv_forward", "broadcast_from_last", "all_reduce_grads"]


def all_reduce_sum(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Sum of ``x`` over ``axis`` (a new tensor; no autograd).  Without a
    mesh or that axis, a copy of ``x``."""
    out = x.detach().clone()
    if mesh is not None and axis in mesh:
        dist.all_reduce(out, group=mesh.group(axis))
    return out


def all_reduce_max(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Elementwise maximum of ``x`` over ``axis`` (no autograd).  Without
    a mesh or that axis, a copy of ``x``."""
    out = x.detach().clone()
    if mesh is not None and axis in mesh:
        dist.all_reduce(out, op=dist.ReduceOp.MAX, group=mesh.group(axis))
    return out


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to(x: torch.Tensor, mesh, axis: str = "tp") -> torch.Tensor:
    """Megatron's f: identity forward, all-reduce of the gradient over
    ``axis``.  Without that axis, ``x`` itself."""
    if mesh is None or axis not in mesh:
        return x
    return _CopyTo.apply(x, mesh.group(axis))


def reduce_from(x: torch.Tensor, mesh, axis: str = "tp") -> torch.Tensor:
    """Megatron's g: all-reduce forward over ``axis``, identity backward.
    Without that axis, ``x`` itself."""
    if mesh is None or axis not in mesh:
        return x
    return _ReduceFrom.apply(x, mesh.group(axis))


def _axes_in(mesh, axes: Sequence[str]) -> Tuple[str, ...]:
    """The ``axes`` the mesh names (none without a mesh)."""
    return () if mesh is None else tuple(a for a in axes if a in mesh)


def reduce_over(x: torch.Tensor, mesh, axes: Sequence[str]) -> torch.Tensor:
    """Sum of ``x`` over the product of ``axes`` (those the mesh names),
    with the identity backward: each rank's gradient is its own part's.
    Without a mesh or any of the axes, ``x`` itself."""
    axes = _axes_in(mesh, axes)
    if not axes:
        return x
    return _ReduceFrom.apply(x, mesh.group_over(axes))


def gather_routes(values: torch.Tensor, where: torch.Tensor, total: int,
                  mesh, axes: Sequence[str]) -> torch.Tensor:
    """A tensor of ``total`` entries holding every rank's ``values`` (1-D
    integers, no gradient) at its ``where`` (the values' global
    positions; the ranks' positions tile ``range(total)``), gathered over
    the product of ``axes``: each rank writes its values into zeros and
    one all-reduce sums the ranks' disjoint parts."""
    out = values.new_zeros(total).index_copy_(0, where, values)
    axes = _axes_in(mesh, axes)
    if axes:
        dist.all_reduce(out, group=mesh.group_over(axes))
    return out


def _exchange(sends: Sequence[torch.Tensor], to: int, frm: int, group
              ) -> List[torch.Tensor]:
    """Send ``sends`` to global rank ``to`` and receive tensors shaped
    like them from ``frm``, in one batch of point-to-point operations."""
    sends = [t.contiguous() for t in sends]
    recvs = [torch.empty_like(t) for t in sends]
    ops = ([dist.P2POp(dist.isend, t, to, group) for t in sends]
           + [dist.P2POp(dist.irecv, t, frm, group) for t in recvs])
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return recvs


class _RingRotate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, k, v, group, to, frm):
        ctx.group, ctx.to, ctx.frm = group, to, frm
        k2, v2 = _exchange((k, v), to, frm, group)
        return k2, v2

    @staticmethod
    def backward(ctx, dk, dv):
        dk2, dv2 = _exchange((dk, dv), ctx.frm, ctx.to, ctx.group)
        return dk2, dv2, None, None, None


def ring_rotate(mesh, axis: str = "sp"):
    """The rotation of a ring over ``axis``: a function ``(k, v) -> (k',
    v')`` that hands this rank's blocks to the next rank and returns the
    previous rank's.  Differentiable: the backward hands the gradients
    back round the ring."""
    group = mesh.group(axis)
    to, frm = mesh.peer(axis, 1), mesh.peer(axis, -1)

    def rotate(k, v):
        return _RingRotate.apply(k, v, group, to, frm)

    return rotate


class _SendForward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, group, to):
        ctx.group, ctx.to = group, to
        ctx.shape, ctx.dtype = h.shape, h.dtype
        dist.send(h.detach().contiguous(), to, group=group)
        # A token that carries the backward to this node: the pipeline
        # ties it to its outputs (broadcast_from_last).
        return h.new_zeros(())

    @staticmethod
    def backward(ctx, _token):
        g = torch.empty(ctx.shape, dtype=ctx.dtype, device=_token.device)
        dist.recv(g, ctx.to, group=ctx.group)
        return g, None, None


class _RecvForward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, anchor, shape, dtype, group, frm):
        ctx.group, ctx.frm = group, frm
        h = torch.empty(shape, dtype=dtype, device=anchor.device)
        dist.recv(h, frm, group=group)
        return h

    @staticmethod
    def backward(ctx, g):
        dist.send(g.contiguous(), ctx.frm, group=ctx.group)
        return None, None, None, None, None


def send_forward(h: torch.Tensor, mesh, axis: str = "pp") -> torch.Tensor:
    """Send ``h`` to the next stage; returns a scalar token whose backward
    receives ``h``'s gradient from that stage."""
    return _SendForward.apply(h, mesh.group(axis), mesh.peer(axis, 1))


def recv_forward(anchor: torch.Tensor, shape, dtype, mesh,
                 axis: str = "pp") -> torch.Tensor:
    """Receive an activation from the previous stage; its backward sends
    the gradient back.  ``anchor`` is any tensor on the path to what the
    caller differentiates (a stage weight): autograd runs a node only
    when it leads to a requested input, and the received tensor has no
    input of its own.  It gets no gradient."""
    return _RecvForward.apply(anchor, tuple(shape), dtype,
                              mesh.group(axis), mesh.peer(axis, -1))


class _BroadcastFromLast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, outs, group, src, is_src, *tokens):
        ctx.is_src, ctx.n_tokens = is_src, len(tokens)
        out = outs.detach().contiguous().clone()
        dist.broadcast(out, src, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        # Every stage computes the same loss from the same outputs, so the
        # gradient counts once: at the stage that made them.  The tokens'
        # zero gradients start each stage's own backward.
        tokens = [g.new_zeros(()) for _ in range(ctx.n_tokens)]
        return (g if ctx.is_src else None, None, None, None, *tokens)


def broadcast_from_last(outs: torch.Tensor, tokens: Iterable[torch.Tensor],
                        mesh, axis: str = "pp") -> torch.Tensor:
    """The last stage's ``outs`` on every stage of ``axis`` (other stages
    pass a placeholder of the same shape).  ``tokens`` are this stage's
    :func:`send_forward` tokens, tied in so the backward reaches them."""
    last = mesh.size(axis) - 1
    return _BroadcastFromLast.apply(
        outs, mesh.group(axis), mesh.ranks(axis)[last],
        mesh.index(axis) == last, *tokens)


BUCKET_ELEMENTS = 1 << 25


def all_reduce_grads(grads: Sequence[torch.Tensor], mesh,
                     axes: Tuple[str, ...]) -> None:
    """Sum each gradient over the product of the ``axes`` the mesh names,
    in place: consecutive gradients of one dtype are flattened into
    buckets of up to ``BUCKET_ELEMENTS`` elements (a larger gradient goes
    alone), one all-reduce each over one group (the all-reduce combiner's
    work in the JAX package)."""
    axes = tuple(a for a in axes if a in mesh)
    if not axes:
        return
    group = mesh.group_over(axes)
    bucket: List[torch.Tensor] = []

    def flush():
        if len(bucket) == 1:
            # A gradient may come out of its backward with permuted
            # strides (an MoE expert's einsum); NCCL takes it dense.
            g = bucket[0]
            dense = g.contiguous()
            dist.all_reduce(dense, group=group)
            if dense is not g:
                g.copy_(dense)
        elif bucket:
            flat = torch.cat([g.reshape(-1) for g in bucket])
            dist.all_reduce(flat, group=group)
            for g, part in zip(bucket, flat.split([g.numel()
                                                   for g in bucket])):
                g.copy_(part.view_as(g))
        bucket.clear()

    for g in grads:
        if bucket and (g.dtype != bucket[0].dtype or sum(
                b.numel() for b in bucket) + g.numel() > BUCKET_ELEMENTS):
            flush()
        bucket.append(g)
    flush()
