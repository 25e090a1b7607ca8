"""Flash attention for the PyTorch port: three hand-written Hopper
kernels, their plain PyTorch versions, and the autograd boundary.

Port of ``multiverso_tpu/ops/flash_attention.py``.  The three Pallas TPU
kernels there each have a CUDA C++ counterpart under ``csrc/``, built for
``sm_90a`` on first use (``_build.py``):

=============  ==============================  ==========================
wrapper        CUDA source                     replaces (TPU kernel)
=============  ==============================  ==========================
``flash_fwd``  ``csrc/flash_fwd.cu``           ``_fwd_kernel`` :83-135
``flash_dq``   ``csrc/flash_dq.cu``            ``_dq_kernel`` :138-181
``flash_dkv``  ``csrc/flash_dkv.cu``           ``_dkv_kernel`` :184-233
=============  ==============================  ==========================

Which design a kernel runs is fixed at compile time by (dtype, D): in
bf16 all three run the Hopper designs (TMA loads, wgmma with register
accumulators, shared helpers in ``csrc/hopper.cuh``) at every head dim.
In float32 all three run the plane design (``csrc/hopper_f32.cuh``) at
every head dim: one elementwise kernel, which replaces no TPU kernel,
splits the operands into three bf16 planes (hi, mid, lo) in scratch the
wrapper allocates, and every product runs as six bf16 wgmma products
into float32 accumulators (the three left out are of order 2⁻²⁴ of the
product), so the bound is six times the flops at the bf16 rate.  At D
32, 64 and 128 it splits q, k and v (and, for dq and dk/dv, do); at D
256 only the operands a kernel streams (k and v for the forward and dq,
q and do for dk/dv), and the stationary ones stay float32 in shared
memory, split a fragment at a time in registers.  :func:`plane_split`
runs a launch's split alone.  Every design puts bh on grid x, so any bh
launches.

Beside each wrapper sits its plain version (``flash_fwd_ref``,
``flash_dq_ref``, ``flash_dkv_ref``): the same function written with
dense tensor ops.  A wrapper takes the plain version only for a tensor
on the CPU; a CUDA tensor launches the kernel, and a kernel that fails to
build or launch raises — nothing falls back.  The JAX package's kernels
take any head dim; these are compiled for ``HEAD_DIMS``, so a CUDA
tensor of another head dim up to 256 launches the kernel of the next
one in the set on operands zero-padded along D (zero columns add
nothing to q·kᵀ, and give zero columns of o, dq, dk and dv, which are
cut off), and a larger head dim raises.

What stays plain PyTorch around the kernels, as in the JAX package: the
pre-scale of q rounded in the input dtype (``:244``, ``:318``), the
``Δ = rowsum(do·o) − dlse`` precompute (``:311-312``) that folds the lse
cotangent in, and the ``autograd.Function`` that saves ``(q, k, v, o,
lse)``.  lse and Δ are plain ``[bh, T]`` float32 rows: the TPU's
``[*, T, 128]`` lane padding has no purpose here.

Every launch adds one to its kernel's count (:func:`launch_counts`), so
a run can show that its steps went through the kernels, and to its
count by ``(Tq, Tk, causal)`` (:func:`launch_shapes`), so a run can show
which pieces a ring of attention calls launched.

The forward launch is a dispatcher op, ``torch.ops.mvt.flash_fwd``.  A
ctypes call is invisible to PyTorch's dispatcher, so selective activation
checkpointing could not tell it apart from the plain ops around it and
would relaunch the kernel on every recompute; as an op, a checkpoint
policy can name it and keep its ``(o, lse)`` instead (the JAX package
names them ``"flash_out"``/``"flash_lse"`` for its "dots" policy).
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, Optional, Tuple

import torch

__all__ = ["flash_attention", "flash_fwd", "flash_dq", "flash_dkv",
           "flash_fwd_ref", "flash_dq_ref", "flash_dkv_ref", "plane_split",
           "launch_counts", "launch_shapes", "reset_launch_counts",
           "HEAD_DIMS"]

_NEG = -1e30
HEAD_DIMS = (32, 64, 128, 256)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_LAUNCHES: Dict[str, int] = {"flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0}
_SHAPES: Dict[Tuple[str, int, int, bool], int] = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_N = ctypes.c_size_t  # the plane scratch's size in bf16 elements
_SIGNATURES = {
    "flash_fwd": ("mvt_flash_fwd", [_P] * 6 + [_N] + [_I] * 6 + [_P]),
    "flash_dq": ("mvt_flash_dq",
                 [_P] * 8 + [_N] + [_I] * 6 + [ctypes.c_float, _P]),
    "flash_dkv": ("mvt_flash_dkv", [_P] * 9 + [_N] + [_I] * 6 + [_P]),
}
# Each library's split alone (mvt_plane_split): q, k, v, do, scratch, its
# size, bh, tq, tk, d, stream.
_SPLIT_ARGS = [_P] * 5 + [_N] + [_I] * 4 + [_P]
# Head dims whose float32 kernels run the plane design, which splits
# operands into three bf16 planes each in scratch the wrapper passes
# (fwd_for_dim, dq_for_dim and dkv_for_dim in csrc/): every operand at D
# 32, 64 and 128; at D 256 the streamed ones alone.
_F32_PLANE_DIMS = {"flash_fwd": (32, 64, 128, 256),
                   "flash_dq": (32, 64, 128, 256),
                   "flash_dkv": (32, 64, 128, 256)}
# name -> (C entry point, the split alone, error-string fn)
_FNS: Dict[str, tuple] = {}
_FNS_LOCK = threading.Lock()


def launch_counts() -> Dict[str, int]:
    """Kernel launches since the last :func:`reset_launch_counts`."""
    return dict(_LAUNCHES)


def launch_shapes() -> Dict[Tuple[str, int, int, bool], int]:
    """Launches since the last :func:`reset_launch_counts`, by ``(kernel,
    Tq, Tk, causal)``."""
    return dict(_SHAPES)


def reset_launch_counts() -> None:
    for name in _LAUNCHES:
        _LAUNCHES[name] = 0
    _SHAPES.clear()


def _kernel(name: str) -> tuple:
    with _FNS_LOCK:
        entry = _FNS.get(name)
        if entry is None:
            from . import _build

            lib = _build.load(name)
            sym, argtypes = _SIGNATURES[name]
            fn = getattr(lib, sym)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            split = lib.mvt_plane_split
            split.argtypes = _SPLIT_ARGS
            split.restype = ctypes.c_int
            entry = _FNS[name] = (fn, split, lib.mvt_error_string)
        return entry


def _launch(name: str, device: torch.device, *args, piece) -> None:
    """Launch on the current stream; tensors pass as their data pointers
    (the wrappers checked shape, dtype, device and contiguity).  ``piece``
    is the launch's ``(Tq, Tk, causal)``."""
    _call(name, device, *args)
    _LAUNCHES[name] += 1
    key = (name, *piece)
    _SHAPES[key] = _SHAPES.get(key, 0) + 1


def _call(name: str, device: torch.device, *args, split=False) -> None:
    """Call library ``name``'s launch (or, with ``split``, its split
    alone) on the current stream; raises on a non-zero return."""
    launch, split_alone, error_string = _kernel(name)
    ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = (split_alone if split else launch)(*ptrs, stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed ({rc}): "
                           f"{error_string(rc).decode()}")


def _check(q, k, v, do=None, lse=None, delta=None) -> None:
    """Validate what the kernels index before any pointer is passed."""
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError("flash kernels take [bh, T, D] tensors")
    if k.shape != v.shape or q.shape[0] != k.shape[0] or \
            q.shape[2] != k.shape[2]:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if do is not None and (do.shape != q.shape
                           or lse.shape != q.shape[:2]
                           or delta.shape != q.shape[:2]):
        raise ValueError(f"backward operands do {tuple(do.shape)}, lse "
                         f"{tuple(lse.shape)}, delta {tuple(delta.shape)} "
                         f"do not match q {tuple(q.shape)}")
    devices = {t.device for t in (q, k, v, do, lse, delta) if t is not None}
    if len(devices) != 1:
        raise ValueError(f"operands on several devices: {devices}")
    if q.is_cuda:
        _kernel_dim(q.shape[2])
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or \
            v.dtype != q.dtype:
        raise ValueError(f"dtypes {q.dtype}/{k.dtype}/{v.dtype} not "
                         f"supported; the kernels take one of "
                         f"{sorted(str(d) for d in _DTYPE_CODES)}")


def _kernel_dim(d: int) -> int:
    """The head dim a CUDA launch runs at: the smallest of ``HEAD_DIMS``
    that holds ``d`` (the operands are zero-padded up to it)."""
    for kd in HEAD_DIMS:
        if d <= kd:
            return kd
    raise ValueError(f"head dim {d} not supported on the card; the "
                     f"kernels support {HEAD_DIMS} and smaller dims "
                     f"padded up to one of them")


def _pad(kd: int, *ts: torch.Tensor):
    """``ts`` zero-padded along their last (head) dim to ``kd``."""
    return tuple(torch.nn.functional.pad(t, (0, kd - t.shape[-1]))
                 for t in ts)


def _prescale(q: torch.Tensor, scale: float) -> torch.Tensor:
    """q·scale rounded in q's dtype — the softmax scale folded into q
    once, as the JAX package does before its kernels."""
    return (q.float() * scale).to(q.dtype)


def _prepare(q, k, v, scale):
    """The operands every kernel indexes: pre-scaled q and contiguous
    k, v.  Made once per attention call; the backward reuses them."""
    return _prescale(q, scale).contiguous(), k.contiguous(), v.contiguous()


def _planes(qs, k, kernel):
    """Scratch for kernel ``kernel``'s bf16 planes in the float32 plane
    design (hi, mid and lo of each operand it splits: q, k, v and, for
    dq and dk/dv, do at D 32, 64 and 128; at D 256 k and v for the
    forward and dq, q and do for dk/dv), or None for a bf16 launch."""
    d = qs.shape[2]
    if qs.dtype != torch.float32 or d not in _F32_PLANE_DIMS[kernel]:
        return None
    nq, nk = qs.numel(), k.numel()
    if d == 256:
        n = 2 * (nq if kernel == "flash_dkv" else nk)
    elif kernel == "flash_fwd":
        n = nq + 2 * nk
    else:
        n = 2 * (nq + nk)
    return torch.empty(3 * n, dtype=torch.bfloat16, device=qs.device)


def _scratch(qs, k, kernel):
    """``_planes``' scratch and its size in elements, as a launch takes
    them (the kernel refuses a scratch smaller than its planes)."""
    p = _planes(qs, k, kernel)
    return p, 0 if p is None else p.numel()


def plane_split(kernel, qs, k, v, do=None) -> torch.Tensor:
    """A float32 launch's split alone: the scratch (``_planes``) that
    kernel ``kernel``'s launch on these prepared operands (``do`` for dq
    and dk/dv) fills with their bf16 planes, filled the same way, with no
    kernel after it, so a caller can time the split apart from the
    launch (on operands zero-padded to the launch's head dim, as the
    launch pads them).  On CPU tensors its plain version,
    ``_split_plain``; on the card the library's ``mvt_plane_split``."""
    if qs.dtype != torch.float32:
        raise ValueError(f"the plane design splits float32 operands, not "
                         f"{qs.dtype}")
    kd = _kernel_dim(qs.shape[2])
    if kd != qs.shape[2]:
        return plane_split(kernel, *_pad(kd, qs, k, v),
                           None if do is None else _pad(kd, do)[0])
    if not qs.is_cuda:
        return _split_plain(kernel, qs, k, v, do)
    planes, n = _scratch(qs, k, kernel)
    _call(kernel, qs.device, qs, k, v, do, planes, n, qs.shape[0],
          qs.shape[1], k.shape[1], qs.shape[2], split=True)
    return planes


def _split3(x):
    """hi, mid and lo of float32 ``x`` as bf16, each rounded to nearest:
    flash_split3's arithmetic (both differences are exact in float32)."""
    hi = x.to(torch.bfloat16)
    r = x - hi.float()
    mid = r.to(torch.bfloat16)
    return hi, mid, (r - mid.float()).to(torch.bfloat16)


def _split_plain(kernel, qs, k, v, do):
    """The scratch as ``Planes::split`` fills it: the planes of the
    operands it splits in the order q, do, k, v, each as [3, bh, T, D]
    (plane p of head b at head p·bh + b)."""
    if qs.shape[2] == 256:
        ops = (qs, do) if kernel == "flash_dkv" else (k, v)
    else:
        ops = (qs, k, v) if kernel == "flash_fwd" else (qs, do, k, v)
    return torch.cat([torch.stack(_split3(x)).reshape(-1) for x in ops])


def _rows(do, lse, delta, dtype):
    """The backward's per-call operands: do in q's dtype, float32 rows."""
    return (do.to(dtype).contiguous(), lse.float().contiguous(),
            delta.float().contiguous())


# ------------------------------------------- kernels on prepared operands
# Operands as _prepare and _rows make them.  A CUDA tensor launches the
# kernel (of _kernel_dim's head dim, on padded operands); a CPU tensor
# takes the plain version.
def _fwd(qs, k, v, causal):
    bh, tq, d = qs.shape
    if not qs.is_cuda:
        return _fwd_plain(qs, k, v, causal)
    kd = _kernel_dim(d)
    if kd != d:
        o, lse = _fwd(*_pad(kd, qs, k, v), causal)
        return o[..., :d].contiguous(), lse
    o = torch.empty_like(qs)
    lse = torch.empty((bh, tq), dtype=torch.float32, device=qs.device)
    _launch("flash_fwd", qs.device, qs, k, v, o, lse,
            *_scratch(qs, k, "flash_fwd"), bh, tq, k.shape[1], d,
            _DTYPE_CODES[qs.dtype], int(causal),
            piece=(tq, k.shape[1], bool(causal)))
    return o, lse


def _dq(qs, k, v, do, lse, delta, scale, causal):
    bh, tq, d = qs.shape
    if not qs.is_cuda:
        return _dq_plain(qs, k, v, do, lse, delta, scale, causal)
    kd = _kernel_dim(d)
    if kd != d:
        return _dq(*_pad(kd, qs, k, v, do), lse, delta, scale,
                   causal)[..., :d].contiguous()
    dq = torch.empty_like(qs)
    _launch("flash_dq", qs.device, qs, k, v, do, lse, delta, dq,
            *_scratch(qs, k, "flash_dq"), bh, tq, k.shape[1], d,
            _DTYPE_CODES[qs.dtype], int(causal), float(scale),
            piece=(tq, k.shape[1], bool(causal)))
    return dq


def _dkv(qs, k, v, do, lse, delta, causal):
    bh, tq, d = qs.shape
    if not qs.is_cuda:
        return _dkv_plain(qs, k, v, do, lse, delta, causal)
    kd = _kernel_dim(d)
    if kd != d:
        dk, dv = _dkv(*_pad(kd, qs, k, v, do), lse, delta, causal)
        return dk[..., :d].contiguous(), dv[..., :d].contiguous()
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch("flash_dkv", qs.device, qs, k, v, do, lse, delta, dk, dv,
            *_scratch(qs, k, "flash_dkv"), bh, tq, k.shape[1], d,
            _DTYPE_CODES[qs.dtype], int(causal),
            piece=(tq, k.shape[1], bool(causal)))
    return dk, dv


@torch.library.custom_op("mvt::flash_fwd", mutates_args=())
def _fwd_op(qs: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            causal: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward on prepared operands as a dispatcher op (see the
    module docstring): the kernel for CUDA tensors, the plain version for
    CPU tensors."""
    return _fwd(qs, k, v, causal)


@_fwd_op.register_fake
def _(qs, k, v, causal):
    return (torch.empty_like(qs),
            qs.new_empty(qs.shape[:2], dtype=torch.float32))


# ---------------------------------------------------------------- wrappers
def flash_fwd(q, k, v, scale: float, causal: bool
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q [bh,Tq,D], k/v [bh,Tk,D] (unscaled) → (o [bh,Tq,D] in q's dtype,
    lse [bh,Tq] float32)."""
    _check(q, k, v)
    return _fwd(*_prepare(q, k, v, scale), causal)


def flash_dq(q, k, v, do, lse, delta, scale: float, causal: bool
             ) -> torch.Tensor:
    """dq [bh,Tq,D] in q's dtype from the saved lse and Δ (float32
    [bh,Tq]); q unscaled."""
    _check(q, k, v, do, lse, delta)
    return _dq(*_prepare(q, k, v, scale), *_rows(do, lse, delta, q.dtype),
               scale, causal)


def flash_dkv(q, k, v, do, lse, delta, scale: float, causal: bool
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) [bh,Tk,D] in k's and v's dtype; q unscaled."""
    _check(q, k, v, do, lse, delta)
    return _dkv(*_prepare(q, k, v, scale), *_rows(do, lse, delta, q.dtype),
                causal)


# --------------------------------------------------------- plain versions
def _scores(qs, k, causal: bool) -> torch.Tensor:
    """float32 [bh,Tq,Tk] scores of pre-scaled q, masked with _NEG."""
    s = torch.einsum("btd,bsd->bts", qs.float(), k.float())
    if causal:
        tq, tk = s.shape[1], s.shape[2]
        keep = torch.ones(tq, tk, dtype=torch.bool,
                          device=s.device).tril()
        s = s.masked_fill(~keep, _NEG)
    return s


def _fwd_plain(qs, k, v, causal):
    s = _scores(qs, k, causal)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bts,bsd->btd", p.to(v.dtype).float(), v.float()) / l
    return o.to(qs.dtype), (m + torch.log(l))[..., 0]


def _probs_and_ds(qs, k, v, do, lse, delta, causal):
    p = torch.exp(_scores(qs, k, causal) - lse.float()[..., None])
    dp = torch.einsum("btd,bsd->bts", do.float(), v.float())
    return p, p * (dp - delta.float()[..., None])


def _dq_plain(qs, k, v, do, lse, delta, scale, causal):
    _, ds = _probs_and_ds(qs, k, v, do, lse, delta, causal)
    dq = torch.einsum("bts,bsd->btd", ds.to(k.dtype).float(), k.float())
    return (dq * scale).to(qs.dtype)


def _dkv_plain(qs, k, v, do, lse, delta, causal):
    p, ds = _probs_and_ds(qs, k, v, do, lse, delta, causal)
    dv = torch.einsum("bts,btd->bsd", p.to(do.dtype).float(), do.float())
    dk = torch.einsum("bts,btd->bsd", ds.to(qs.dtype).float(), qs.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_fwd_ref(q, k, v, scale: float, causal: bool
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`flash_fwd`: the same rounding points (q
    pre-scaled in its dtype, p cast to v's dtype before p·v, float32
    statistics), one softmax over the whole row."""
    return _fwd_plain(_prescale(q, scale), k, v, causal)


def flash_dq_ref(q, k, v, do, lse, delta, scale: float, causal: bool
                 ) -> torch.Tensor:
    """Plain version of :func:`flash_dq`."""
    return _dq_plain(_prescale(q, scale), k, v, do, lse, delta, scale,
                     causal)


def flash_dkv_ref(q, k, v, do, lse, delta, scale: float, causal: bool
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`flash_dkv`."""
    return _dkv_plain(_prescale(q, scale), k, v, do, lse, delta, causal)


# ------------------------------------------------------ autograd boundary
class _Flash(torch.autograd.Function):
    """Saves the prepared (pre-scaled q, k, v) with (o, lse), so the
    backward's two kernels share one set of operands; the backward folds
    the lse cotangent into Δ, so gradients flow through a returned lse."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal):
        _check(q, k, v)
        qs, k, v = _prepare(q, k, v, scale)
        o, lse = torch.ops.mvt.flash_fwd(qs, k, v, causal)
        ctx.save_for_backward(qs, k, v, o, lse)
        ctx.scale, ctx.causal = scale, causal
        ctx.set_materialize_grads(False)
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        qs, k, v, o, lse = ctx.saved_tensors
        if do is None:
            do = torch.zeros_like(o)
        delta = (do.float() * o.float()).sum(-1)
        if dlse is not None:
            delta = delta - dlse.float()
        do, lse, delta = _rows(do, lse, delta, qs.dtype)
        dq = _dq(qs, k, v, do, lse, delta, ctx.scale, ctx.causal)
        dk, dv = _dkv(qs, k, v, do, lse, delta, ctx.causal)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, scale: Optional[float] = None,
                    causal: bool = True, return_lse: bool = False):
    """q [B,H,Tq,D], k/v [B,H,Tk,D] → [B,H,Tq,D] (and lse [B,H,Tq]
    float32).  ``causal=True`` requires Tq == Tk.  Differentiable,
    including through lse.  Any T works: the kernels bound-check the
    ragged last block, so there is no block-fit policy to satisfy."""
    B, H, tq, d = q.shape
    tk = k.shape[2]
    if causal and tq != tk:
        raise ValueError(f"causal flash attention needs Tq == Tk, got "
                         f"{tq} != {tk}")
    if scale is None:
        scale = d ** -0.5
    bh = B * H
    o, lse = _Flash.apply(q.reshape(bh, tq, d), k.reshape(bh, tk, d),
                          v.reshape(bh, tk, d), float(scale), bool(causal))
    o = o.reshape(B, H, tq, d)
    if return_lse:
        return o, lse.reshape(B, H, tq)
    return o
