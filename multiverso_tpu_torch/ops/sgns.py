"""Skip-gram negative sampling's loss and gradients in one kernel.

word2vec's fused step (``apps/word2vec.py``) gathers each batch's rows
from its two tables, computes the SGNS loss and the gradients of the
gathered rows, and scatters those into the tables.  :func:`sgns_grads`
is the middle part: from the centre rows ``vc`` [B, D] and the output
rows ``out_emb`` [B·(1 + K), D] (the B contexts, then pair i's K
negatives at rows B + i·K ...: what ``rows_of`` gathers), it returns the
loss of ``-(Σ logsigmoid(pos) + Σ logsigmoid(-neg)) / B``, ``dvc`` [B, D]
and ``dout`` in ``out_emb``'s row order, which is the order the output
table's row scatter takes its deltas in.

A CUDA tensor launches ``csrc/sgns.cu`` (built for ``sm_90a`` on first
use by ``_build.py``), which replaces no TPU kernel: the JAX package
leaves this gradient to XLA's autograd.  The kernel reads each gathered
row once and writes each gradient row once (see its source for the
design and its bound).  A CPU tensor takes :func:`sgns_plain`, the same
closed form in dense tensor ops.  Nothing falls back: a type, shape or
layout the kernel does not take raises, and so does a failed launch.
Every launch adds one to :func:`launch_counts`, so a run can show that
its steps went through the kernel.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

__all__ = ["sgns_grads", "sgns_plain", "launch_counts",
           "reset_launch_counts"]

_LAUNCHES: Dict[str, int] = {"sgns": 0}
_P = ctypes.c_void_p
_I = ctypes.c_int
# vc, out_emb, dvc, dout, partials, their count, loss, b, k, d, stream.
_ARGS = [_P] * 5 + [_I, _P] + [_I] * 3 + [_P]
_FNS: Dict[str, tuple] = {}
_FNS_LOCK = threading.Lock()


def launch_counts() -> Dict[str, int]:
    """Kernel launches since the last :func:`reset_launch_counts`."""
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    _LAUNCHES["sgns"] = 0


def _kernel() -> tuple:
    with _FNS_LOCK:
        if not _FNS:
            from . import _build

            lib = _build.load("sgns")
            fn = lib.mvt_sgns
            fn.argtypes = _ARGS
            fn.restype = _I
            partials = lib.mvt_sgns_partials
            partials.argtypes = [_I]
            partials.restype = _I
            _FNS["sgns"] = (fn, partials, lib.mvt_error_string)
        return _FNS["sgns"]


def _check(vc: torch.Tensor, out_emb: torch.Tensor, negatives: int) -> None:
    """Validate what the kernel indexes before any pointer is passed."""
    if vc.dtype != torch.float32 or out_emb.dtype != torch.float32:
        raise ValueError(f"sgns_grads takes float32 rows, got {vc.dtype} "
                         f"and {out_emb.dtype}")
    if vc.dim() != 2 or out_emb.dim() != 2 or \
            out_emb.shape[1] != vc.shape[1]:
        raise ValueError(f"sgns_grads takes vc [B, D] and out_emb "
                         f"[B·(1 + K), D], got {tuple(vc.shape)} and "
                         f"{tuple(out_emb.shape)}")
    b = vc.shape[0]
    if b < 1 or negatives < 0 or out_emb.shape[0] != b * (1 + negatives):
        raise ValueError(f"out_emb has {out_emb.shape[0]} rows; {b} pairs "
                         f"with {negatives} negatives each need "
                         f"{b * (1 + negatives)} (and a pair at least)")
    if vc.device != out_emb.device:
        raise ValueError(f"vc on {vc.device}, out_emb on {out_emb.device}")
    if not (vc.is_contiguous() and out_emb.is_contiguous()):
        raise ValueError("sgns_grads takes contiguous rows")


def sgns_grads(vc: torch.Tensor, out_emb: torch.Tensor, negatives: int
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(loss, dvc, dout)`` of the SGNS loss over ``vc`` [B, D] and
    ``out_emb`` [B·(1 + K), D], K = ``negatives``; ``dout`` in
    ``out_emb``'s row order.  The kernel on a CUDA tensor, the plain
    version on a CPU one."""
    negatives = int(negatives)
    _check(vc, out_emb, negatives)
    if not vc.is_cuda:
        return sgns_plain(vc, out_emb, negatives)
    launch, partials_for, error_string = _kernel()
    b, d = vc.shape
    n = partials_for(b)
    loss = torch.empty((), dtype=torch.float32, device=vc.device)
    partials = torch.empty(n, dtype=torch.float32, device=vc.device)
    dvc, dout = torch.empty_like(vc), torch.empty_like(out_emb)
    with torch.cuda.device(vc.device):
        stream = torch.cuda.current_stream(vc.device).cuda_stream
        rc = launch(vc.data_ptr(), out_emb.data_ptr(), dvc.data_ptr(),
                    dout.data_ptr(), partials.data_ptr(), n,
                    loss.data_ptr(), b, negatives, d, stream)
    if rc != 0:
        raise RuntimeError(f"sgns kernel launch failed ({rc}): "
                           f"{error_string(rc).decode()}")
    _LAUNCHES["sgns"] += 1
    return loss, dvc, dout


def _sigmoid(t: torch.Tensor) -> torch.Tensor:
    """sigmoid(t) as the kernel forms it (``sig_of`` in ``csrc/sgns.cu``,
    and autograd's logsigmoid backward): q = z / (1 + z), z = exp(-|t|),
    below 0.5 and 1 - q above it, unbiased near t = 0 where
    ``1 / (1 + z)`` rounds up on average."""
    z = torch.exp(-t.abs())
    q = z / (1 + z)
    return torch.where(t > 0, 1 - q, q)


def sgns_plain(vc: torch.Tensor, out_emb: torch.Tensor, negatives: int
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of :func:`sgns_grads`: the gradients in closed form,
    ``d logsigmoid(x) / dx = sigmoid(-x)``, in the kernel's layout."""
    b, d = vc.shape
    uo = out_emb[:b]
    un = out_emb[b:].view(b, negatives, d)
    pos = (vc * uo).sum(-1)
    neg = (un * vc[:, None, :]).sum(-1)
    loss = -(F.logsigmoid(pos).sum() + F.logsigmoid(-neg).sum()) / b
    inv_b = 1.0 / b
    g_pos = -inv_b * _sigmoid(-pos)
    g_neg = inv_b * _sigmoid(neg)
    dvc = g_pos[:, None] * uo + (g_neg[..., None] * un).sum(1)
    dout = torch.empty_like(out_emb)
    torch.mul(g_pos[:, None], vc, out=dout[:b])
    torch.mul(g_neg[..., None], vc[:, None, :],
              out=dout[b:].view(b, negatives, d))
    return loss, dvc, dout
