"""The float32 plane design of the port's flash kernels (all three at
head dims 32, 64, 128 and 256, ``csrc/hopper_f32.cuh``), modelled on the
CPU.

The kernels split q, k, v and do (and, in registers, p, ds, pᵀ and dsᵀ)
into three bf16 planes, hi, mid and lo, and form every product as six
bf16 products summed in float32; at D 256 the stationary operands stay
float32 in shared memory and each thread splits its fragment of them in
registers at every 16-column step.  These tests model that arithmetic in
plain torch: the split, the six-product sum, the fragment loads of the
float32 tile, and the kernels' block schedules at the design's tiles (the
forward: 128-row q tiles, 64 rows a warpgroup, each walking the k blocks
with an online softmax; dq, and dk/dv at D 64 and 128: 64 stationary
rows shared by both warpgroups, which take every other streamed block and
meet once; at D 32: 128 stationary rows, 64 a warpgroup, both taking
every streamed block; dk/dv at D 256: 64 k rows, both warpgroups on every
32-row q block, one owning dv and the other dk) and the sums a kernel
keeps apart (at D 32 hi·hi of every product of dq and dk/dv, and of
the forward's o += p·v, in an accumulator of its own, and dk and dv
flushed into float32 sums every few blocks), held against the plain
versions at the schedule tests' tolerances (atol 2e-5, rtol 1e-4), against
the JAX package's Pallas kernels in interpret mode (float32: atol 2e-5 for the
forward, 2e-4 for gradients, as ``tests/test_flash_attention.py`` states
them), and against float64, where the model's error may be at most twice
the plain float32 version's; and the wrapper's split alone
(``plane_split``), which fills a launch's scratch as the launch does.
The CUDA kernels themselves run only on the card (``chip_smoke.py``'s
parity phase holds them).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiverso_tpu.ops import flash_attention as jax_flash
from multiverso_tpu_torch.ops import flash_attention as fa

_NEG = -1e30
# (a plane, b plane) of the six products, in the kernels' order.
PAIRS = ((2, 0), (1, 1), (0, 2), (1, 0), (0, 1), (0, 0))
# The design's tiles by head dim: (dq q rows, k block), (dk/dv k rows, q
# block) — F32Dq, and F32Dkv or (D 256) F32DkvRoles in the sources.  At D
# 32 a block's 128 stationary rows are 64 a warpgroup (kByRows).
_TILES = {32: ((128, 64), (128, 64)), 64: ((64, 64), (64, 64)),
          128: ((64, 32), (64, 32)), 256: ((64, 16), (64, 32))}
# Head dims whose dq and dk/dv keep 128 stationary rows, 64 a warpgroup
# (kByRows), with how dq and dk/dv sum there: (hi·hi apart, blocks of the
# warpgroup's loop between flushes, 0 for none) — kHiApart and kFlush of
# F32Dq and F32Dkv.
_BY_ROWS = {32: ((True, 0), (True, 8))}
# The forward's (q rows, k block) by head dim — F32Fwd.
_FWD_TILES = {32: (128, 64), 64: (128, 64), 128: (128, 32), 256: (128, 32)}
# Head dims whose forward sums o += p·v's hi·hi apart (kHiApart).
_FWD_APART = (32,)
_RAGGED = [(130, 130, True), (130, 130, False), (200, 200, True),
           (200, 200, False), (256, 256, True), (40, 136, False)]


def split3(x):
    """hi, mid and lo of float32 ``x``, each rounded to nearest bf16, as
    the split kernel and the register fragments form them (as float32
    tensors holding bf16 values)."""
    hi = x.to(torch.bfloat16).float()
    r = x - hi
    mid = r.to(torch.bfloat16).float()
    lo = (r - mid).to(torch.bfloat16).float()
    return hi, mid, lo


def mm6(a, b):
    """a @ b as the kernels form it: the six products of the operands'
    bf16 planes (each product of two bf16 values is exact in float32),
    summed in float32."""
    pa, pb = split3(a), split3(b)
    out = None
    for i, j in PAIRS:
        term = pa[i] @ pb[j]
        out = term if out is None else out + term
    return out


def mm6_parts(a, b):
    """a @ b's six plane products as a kernel sums them with hi·hi apart:
    (the five smaller ones summed in float32, hi·hi)."""
    pa, pb = split3(a), split3(b)
    lo = None
    for i, j in PAIRS[:-1]:
        term = pa[i] @ pb[j]
        lo = term if lo is None else lo + term
    return lo, pa[0] @ pb[0]


def mm6_apart(a, b):
    """a @ b with hi·hi summed apart from the five smaller products, then
    added once (a score product at D 32)."""
    lo, hi = mm6_parts(a, b)
    return lo + hi


class _Sum:
    """One T-long gradient sum of a warpgroup as a kernel keeps it: with
    ``apart`` the five smaller plane products and hi·hi in accumulators
    of their own; every ``flush`` blocks of the warpgroup's loop (0:
    never; a block it skips counts) both added into a float32 sum and
    zeroed."""

    def __init__(self, shape, mm, apart, flush):
        self.mm, self.apart, self.flush = mm, apart, flush
        self.acc, self.hi, self.sum = (torch.zeros(shape) for _ in range(3))
        self.blocks = 0

    def add(self, a, b):
        if self.apart:
            lo, hi = mm6_parts(a, b)
            self.acc += lo
            self.hi += hi
        else:
            self.acc += self.mm(a, b)
        self.blocks += 1
        if self.flush and self.blocks % self.flush == 0:
            self.sum += self.acc + self.hi
            self.acc.zero_()
            self.hi.zero_()

    def skip(self):
        self.blocks += 1

    def total(self):
        return self.sum + (self.acc + self.hi)


def _pad_rows(x, rows):
    return torch.nn.functional.pad(x, (0, 0, 0, rows - x.shape[1]))


def _pad_row_vec(x, n):
    return torch.nn.functional.pad(x, (0, n - x.shape[1]))


def fwd_f32_schedule(qs, k, v, causal, BQ=128, BK=32, mm=mm6,
                     apart=False):
    """o and lse as flash_fwd_hopper_f32 schedules them: a block per
    128-row q tile; warpgroup g owns 64 of its rows and walks the k blocks
    up to the tile's causal end with an online softmax (running max m and
    sum l, o rescaled by exp(m_old - m_new)), masking only the blocks
    that straddle its diagonal or Tk; p is split into planes like any
    operand.  With ``apart`` (D 32) o's hi·hi products sum in a second
    accumulator, rescaled with it and added once at the end."""
    bh, tq, d = qs.shape
    tk = k.shape[1]
    nqt, nk = -(-tq // BQ), -(-tk // BK)
    qp = _pad_rows(qs, nqt * BQ)
    kp, vp = _pad_rows(k, nk * BK), _pad_rows(v, nk * BK)
    o, lse = torch.zeros(bh, tq, d), torch.zeros(bh, tq)
    for qt in range(nqt):
        q0 = qt * BQ
        kend = min(nk, (q0 + BQ - 1) // BK + 1) if causal else nk
        for g in range(2):
            qw = q0 + 64 * g
            rows = torch.arange(qw, qw + 64)
            m = torch.full((bh, 64, 1), _NEG)
            l, acc = torch.zeros(bh, 64, 1), torch.zeros(bh, 64, d)
            hacc = torch.zeros(bh, 64, d)
            for kb in range(kend):
                k0 = kb * BK
                # Rows past tq are TMA zeros, masked by nothing.
                s = mm(qp[:, qw:qw + 64], kp[:, k0:k0 + BK].transpose(1, 2))
                if (causal and k0 + BK - 1 > qw) or k0 + BK > tk:
                    cols = torch.arange(k0, k0 + BK)
                    out = ((cols[None, :] >= tk)
                           | (causal & (cols[None, :] > rows[:, None])))
                    s = s.masked_fill(out, _NEG)
                mx = torch.maximum(m, s.amax(-1, keepdim=True))
                corr = torch.exp(m - mx)
                p = torch.exp(s - mx)
                l = l * corr + p.sum(-1, keepdim=True)
                if apart:
                    lo, hi = mm6_parts(p, vp[:, k0:k0 + BK])
                    acc = acc * corr + lo
                    hacc = hacc * corr + hi
                else:
                    acc = acc * corr + mm(p, vp[:, k0:k0 + BK])
                m = mx
            acc = acc + hacc
            lc = l.clamp_min(1e-30)
            n = max(0, min(64, tq - qw))
            o[:, qw:qw + n] = (acc / lc)[:, :n]
            lse[:, qw:qw + n] = (m + torch.log(lc))[:, :n, 0]
    return o, lse


def fwd_model(qs, k, v, causal, d, mm=mm6):
    """o and lse as the float32 forward at head dim d schedules them (with
    plain products nothing is apart)."""
    return fwd_f32_schedule(qs, k, v, causal, *_FWD_TILES[d], mm=mm,
                            apart=d in _FWD_APART and mm is mm6)


def dq_f32_schedule(qs, k, v, do, lse, delta, scale, causal, BQ=64, BK=32,
                    mm=mm6):
    """dq as flash_dq_hopper_f32 schedules it: a block per 64-row q tile;
    warpgroup g takes k blocks g, g + 2, ... up to the causal end, keeps a
    partial dq of all the tile's rows, and the two partials are summed
    once at the end."""
    bh, tq, d = qs.shape
    tk = k.shape[1]
    nqt, nk = -(-tq // BQ), -(-tk // BK)
    qp, dop = _pad_rows(qs, nqt * BQ), _pad_rows(do, nqt * BQ)
    kp, vp = _pad_rows(k, nk * BK), _pad_rows(v, nk * BK)
    # Rows past tq read lse and delta as 0 (their q and do are zeros).
    lsep, dlp = _pad_row_vec(lse, nqt * BQ), _pad_row_vec(delta, nqt * BQ)
    dq = torch.zeros(bh, tq, d)
    for qt in range(nqt):
        q0 = qt * BQ
        rows = torch.arange(q0, q0 + BQ)
        kend = min(nk, (q0 + BQ - 1) // BK + 1) if causal else nk
        parts = []
        for g in range(2):
            acc = torch.zeros(bh, BQ, d)
            for kb in range(g, kend, 2):
                k0 = kb * BK
                # Every block up to the causal end reaches the tile's rows.
                assert not (causal and k0 > q0 + BQ - 1)
                kt = kp[:, k0:k0 + BK]
                s = mm(qp[:, q0:q0 + BQ], kt.transpose(1, 2))
                dp = mm(dop[:, q0:q0 + BQ], vp[:, k0:k0 + BK].transpose(1, 2))
                if (causal and k0 + BK - 1 > q0) or k0 + BK > tk:
                    cols = torch.arange(k0, k0 + BK)
                    out = ((cols[None, :] >= tk) | (rows[:, None] >= tq)
                           | (causal & (cols[None, :] > rows[:, None])))
                    s = s.masked_fill(out, _NEG)
                p = torch.exp(s - lsep[:, q0:q0 + BQ, None])
                acc += mm(p * (dp - dlp[:, q0:q0 + BQ, None]), kt)
            parts.append(acc)
        n = max(0, min(BQ, tq - q0))
        dq[:, q0:q0 + n] = ((parts[0] + parts[1]) * scale)[:, :n]
    return dq


def dkv_f32_schedule(qs, k, v, do, lse, delta, causal, BK=64, BQ=32,
                     mm=mm6):
    """dk and dv as flash_dkv_hopper_f32 schedules them: a block per
    64-row k block; warpgroup g takes q blocks qstart + g, qstart + g + 2,
    ..., keeps partial dk and dv of all the block's rows, and the partials
    are summed once at the end."""
    bh, tq, d = qs.shape
    tk = k.shape[1]
    nk, nq = -(-tk // BK), -(-tq // BQ)
    qp, dop = _pad_rows(qs, nq * BQ), _pad_rows(do, nq * BQ)
    kp, vp = _pad_rows(k, nk * BK), _pad_rows(v, nk * BK)
    lsep, dlp = _pad_row_vec(lse, nq * BQ), _pad_row_vec(delta, nq * BQ)
    dk, dv = torch.zeros(bh, tk, d), torch.zeros(bh, tk, d)
    for kb in range(nk):
        k0 = kb * BK
        krows = torch.arange(k0, k0 + BK)
        kt, vt = kp[:, k0:k0 + BK], vp[:, k0:k0 + BK]
        qstart = k0 // BQ if causal else 0
        parts = []
        for g in range(2):
            dk_acc, dv_acc = torch.zeros(bh, BK, d), torch.zeros(bh, BK, d)
            for qb in range(qstart + g, nq, 2):
                q0 = qb * BQ
                # The causal start reaches the block's rows, and so does
                # every later block.
                assert not (causal and q0 + BQ - 1 < k0)
                qt, dot = qp[:, q0:q0 + BQ], dop[:, q0:q0 + BQ]
                st = mm(kt, qt.transpose(1, 2))
                dpt = mm(vt, dot.transpose(1, 2))
                if (causal and q0 < k0 + BK - 1) or k0 + BK > tk \
                        or q0 + BQ > tq:
                    qcols = torch.arange(q0, q0 + BQ)
                    out = ((krows[:, None] >= tk) | (qcols[None, :] >= tq)
                           | (causal & (krows[:, None] > qcols[None, :])))
                    st = st.masked_fill(out, _NEG)
                pt = torch.exp(st - lsep[:, None, q0:q0 + BQ])
                dst = pt * (dpt - dlp[:, None, q0:q0 + BQ])
                dv_acc += mm(pt, dot)
                dk_acc += mm(dst, qt)
            parts.append((dk_acc, dv_acc))
        n = max(0, min(BK, tk - k0))
        dk[:, k0:k0 + n] = (parts[0][0] + parts[1][0])[:, :n]
        dv[:, k0:k0 + n] = (parts[0][1] + parts[1][1])[:, :n]
    return dk, dv


def dq_f32_rows_schedule(qs, k, v, do, lse, delta, scale, causal, BQ=128,
                         BK=64, mm=mm6, apart=False, flush=0):
    """dq as flash_dq_hopper_f32<32> schedules it (kByRows): a block per
    128-row q tile; warpgroup g owns rows q0 + 64g + [0, 64) and walks
    every k block up to the tile's causal end, skipping those whose keys
    all follow its rows and masking those that straddle its diagonal or
    Tk; no partials to sum."""
    bh, tq, d = qs.shape
    tk = k.shape[1]
    nqt, nk = -(-tq // BQ), -(-tk // BK)
    qp, dop = _pad_rows(qs, nqt * BQ), _pad_rows(do, nqt * BQ)
    kp, vp = _pad_rows(k, nk * BK), _pad_rows(v, nk * BK)
    lsep, dlp = _pad_row_vec(lse, nqt * BQ), _pad_row_vec(delta, nqt * BQ)
    dq = torch.zeros(bh, tq, d)
    score = mm6_apart if apart else mm
    for qt in range(nqt):
        q0 = qt * BQ
        kend = min(nk, (q0 + BQ - 1) // BK + 1) if causal else nk
        for g in range(2):
            qw = q0 + 64 * g
            rows = torch.arange(qw, qw + 64)
            acc = _Sum((bh, 64, d), mm, apart, flush)
            for kb in range(kend):
                k0 = kb * BK
                if causal and k0 > qw + 63:
                    acc.skip()
                    continue
                kt = kp[:, k0:k0 + BK]
                s = score(qp[:, qw:qw + 64], kt.transpose(1, 2))
                dp = score(dop[:, qw:qw + 64],
                           vp[:, k0:k0 + BK].transpose(1, 2))
                if (causal and k0 + BK - 1 > qw) or k0 + BK > tk:
                    cols = torch.arange(k0, k0 + BK)
                    out = ((cols[None, :] >= tk) | (rows[:, None] >= tq)
                           | (causal & (cols[None, :] > rows[:, None])))
                    s = s.masked_fill(out, _NEG)
                p = torch.exp(s - lsep[:, qw:qw + 64, None])
                acc.add(p * (dp - dlp[:, qw:qw + 64, None]), kt)
            n = max(0, min(64, tq - qw))
            dq[:, qw:qw + n] = (acc.total() * scale)[:, :n]
    return dq


def dkv_f32_rows_schedule(qs, k, v, do, lse, delta, causal, BK=128, BQ=64,
                          mm=mm6, apart=False, flush=0):
    """dk and dv as flash_dkv_hopper_f32<32> schedules them (kByRows): a
    block per 128-row k block; warpgroup g owns rows k0 + 64g + [0, 64)
    and walks every q block from the block's causal start, skipping those
    whose queries all precede its rows and masking those that straddle
    its diagonal or an end; no partials to sum."""
    bh, tq, d = qs.shape
    tk = k.shape[1]
    nk, nq = -(-tk // BK), -(-tq // BQ)
    qp, dop = _pad_rows(qs, nq * BQ), _pad_rows(do, nq * BQ)
    kp, vp = _pad_rows(k, nk * BK), _pad_rows(v, nk * BK)
    lsep, dlp = _pad_row_vec(lse, nq * BQ), _pad_row_vec(delta, nq * BQ)
    dk, dv = torch.zeros(bh, tk, d), torch.zeros(bh, tk, d)
    score = mm6_apart if apart else mm
    for kb in range(nk):
        k0 = kb * BK
        qstart = k0 // BQ if causal else 0
        for g in range(2):
            kw = k0 + 64 * g
            krows = torch.arange(kw, kw + 64)
            kt, vt = kp[:, kw:kw + 64], vp[:, kw:kw + 64]
            dk_acc, dv_acc = (_Sum((bh, 64, d), mm, apart, flush)
                              for _ in range(2))
            for qb in range(qstart, nq):
                q0 = qb * BQ
                if causal and q0 + BQ - 1 < kw:
                    dk_acc.skip()
                    dv_acc.skip()
                    continue
                qt, dot = qp[:, q0:q0 + BQ], dop[:, q0:q0 + BQ]
                st = score(kt, qt.transpose(1, 2))
                dpt = score(vt, dot.transpose(1, 2))
                if (causal and q0 < kw + 63) or kw + 64 > tk \
                        or q0 + BQ > tq:
                    qcols = torch.arange(q0, q0 + BQ)
                    out = ((krows[:, None] >= tk) | (qcols[None, :] >= tq)
                           | (causal & (krows[:, None] > qcols[None, :])))
                    st = st.masked_fill(out, _NEG)
                pt = torch.exp(st - lsep[:, None, q0:q0 + BQ])
                dst = pt * (dpt - dlp[:, None, q0:q0 + BQ])
                dv_acc.add(pt, dot)
                dk_acc.add(dst, qt)
            n = max(0, min(64, tk - kw))
            dk[:, kw:kw + n] = dk_acc.total()[:, :n]
            dv[:, kw:kw + n] = dv_acc.total()[:, :n]
    return dk, dv


def dkv_f32_roles_schedule(qs, k, v, do, lse, delta, causal, BK=64, BQ=32,
                           mm=mm6, flush=8):
    """dk and dv as flash_dkv_hopper_f32<256> schedules them: a block per
    64-row k block; both warpgroups take every q block from qstart in
    order; warpgroup 0 forms sᵀ and pᵀ and keeps dv, warpgroup 1 forms sᵀ
    again, dpᵀ and dsᵀ and keeps dk; every ``flush`` blocks, and after
    the last, the sums so far are added to the outputs and start again
    from 0; a k block that no q block reaches keeps its 0s."""
    bh, tq, d = qs.shape
    tk = k.shape[1]
    nk, nq = -(-tk // BK), -(-tq // BQ)
    qp, dop = _pad_rows(qs, nq * BQ), _pad_rows(do, nq * BQ)
    kp, vp = _pad_rows(k, nk * BK), _pad_rows(v, nk * BK)
    lsep, dlp = _pad_row_vec(lse, nq * BQ), _pad_row_vec(delta, nq * BQ)
    dk, dv = torch.zeros(bh, tk, d), torch.zeros(bh, tk, d)
    for kb in range(nk):
        k0 = kb * BK
        krows = torch.arange(k0, k0 + BK)
        kt, vt = kp[:, k0:k0 + BK], vp[:, k0:k0 + BK]
        dk_acc, dv_acc = torch.zeros(bh, BK, d), torch.zeros(bh, BK, d)
        qstart = k0 // BQ if causal else 0
        n = max(0, min(BK, tk - k0))
        for qb in range(qstart, nq):
            q0 = qb * BQ
            assert not (causal and q0 + BQ - 1 < k0)
            qt, dot = qp[:, q0:q0 + BQ], dop[:, q0:q0 + BQ]
            masked = ((causal and q0 < k0 + BK - 1) or k0 + BK > tk
                      or q0 + BQ > tq)
            qcols = torch.arange(q0, q0 + BQ)
            out = ((krows[:, None] >= tk) | (qcols[None, :] >= tq)
                   | (causal & (krows[:, None] > qcols[None, :])))
            lse_b = lsep[:, None, q0:q0 + BQ]
            # Warpgroup 0: pᵀ, dv.
            st = mm(kt, qt.transpose(1, 2))
            if masked:
                st = st.masked_fill(out, _NEG)
            dv_acc += mm(torch.exp(st - lse_b), dot)
            # Warpgroup 1: sᵀ again, dpᵀ, dsᵀ, dk.
            st = mm(kt, qt.transpose(1, 2))
            if masked:
                st = st.masked_fill(out, _NEG)
            dpt = mm(vt, dot.transpose(1, 2))
            dst = torch.exp(st - lse_b) * (dpt - dlp[:, None, q0:q0 + BQ])
            dk_acc += mm(dst, qt)
            if (qb - qstart + 1) % flush == 0 or qb + 1 == nq:
                dk[:, k0:k0 + n] += dk_acc[:, :n]
                dv[:, k0:k0 + n] += dv_acc[:, :n]
                dk_acc.zero_()
                dv_acc.zero_()
    return dk, dv


def _sums(d, kernel, mm):
    """The rows schedule's ``apart`` and ``flush`` for kernel (0 dq, 1
    dk/dv) at head dim d (``_BY_ROWS``): with plain products nothing is
    apart, and the flushes stay."""
    apart, flush = _BY_ROWS[d][kernel]
    return dict(apart=apart and mm is mm6, flush=flush)


def dq_model(qs, k, v, do, lse, delta, scale, causal, d, mm=mm6):
    """dq as the float32 kernel at head dim d schedules it."""
    if d in _BY_ROWS:
        return dq_f32_rows_schedule(qs, k, v, do, lse, delta, scale, causal,
                                    *_TILES[d][0], mm=mm, **_sums(d, 0, mm))
    return dq_f32_schedule(qs, k, v, do, lse, delta, scale, causal,
                           *_TILES[d][0], mm=mm)


def dkv_model(qs, k, v, do, lse, delta, causal, d, mm=mm6):
    """dk and dv as the float32 kernel at head dim d schedules them."""
    if d in _BY_ROWS:
        return dkv_f32_rows_schedule(qs, k, v, do, lse, delta, causal,
                                     *_TILES[d][1], mm=mm, **_sums(d, 1, mm))
    schedule = dkv_f32_roles_schedule if d == 256 else dkv_f32_schedule
    return schedule(qs, k, v, do, lse, delta, causal, *_TILES[d][1], mm=mm)


def _case(tq, tk, causal, d, seed, bh=2):
    """Seeded float32 inputs and the plain forward's saved rows."""
    rng = np.random.RandomState(seed)
    q, k, v = (torch.tensor(rng.randn(bh, t, d).astype(np.float32))
               for t in (tq, tk, tk))
    do = torch.tensor(rng.randn(bh, tq, d).astype(np.float32))
    scale = d ** -0.5
    o, lse = fa.flash_fwd_ref(q, k, v, scale, causal)
    delta = (do * o).sum(-1) - torch.tensor(
        rng.randn(bh, tq).astype(np.float32))
    return q, k, v, do, lse, delta, scale


# ------------------------------------------------------------- the split
@pytest.mark.parametrize("seed,spread", [(0, 1), (1, 8), (2, 30), (3, 33)])
def test_three_planes_reproduce_float32(seed, spread):
    """hi + mid + lo is x within 2⁻²⁴ of |x|, and each piece is a bf16
    value, at magnitudes 10^±spread down to 2⁻¹¹⁰ (below it lo, about
    2⁻¹⁶|x|, falls under bf16's smallest normal, 2⁻¹²⁶)."""
    rng = np.random.RandomState(seed)
    x = torch.tensor((rng.randn(50_000)
                      * 10.0 ** rng.uniform(-spread, spread, 50_000))
                     .astype(np.float32))
    x = x[x.abs() >= 2.0 ** -110]
    pieces = split3(x)
    for p in pieces:
        assert torch.equal(p.to(torch.bfloat16).float(), p)
    err = ((pieces[0] + pieces[1] + pieces[2]).double() - x.double()).abs()
    assert bool((err <= 2.0 ** -24 * x.double().abs()).all())


def test_planes_shrink_by_bf16_steps():
    """Each piece is the remainder of the ones before it rounded to bf16:
    |mid| ≤ 2⁻⁸|hi| and |lo| ≤ 2⁻⁸|mid| (round to nearest)."""
    x = torch.tensor(np.random.RandomState(5).randn(10_000)
                     .astype(np.float32))
    hi, mid, lo = split3(x)
    assert bool((mid.abs() <= 2.0 ** -8 * hi.abs()).all())
    assert bool((lo.abs() <= 2.0 ** -8 * mid.abs()).all())


@pytest.mark.parametrize("m,k,n", [(64, 128, 32), (64, 64, 64),
                                   (64, 32, 128)])
def test_six_products_keep_float32_accuracy(m, k, n):
    """The six-product sum is deterministic on the CPU and within twice
    the plain float32 product's error against float64 (the three terms
    left out are of order 2⁻²⁴ of a·b), at the design's product shapes."""
    rng = np.random.RandomState(m + k + n)
    a = torch.tensor(rng.randn(4, m, k).astype(np.float32))
    b = torch.tensor(rng.randn(4, k, n).astype(np.float32))
    ref = a.double() @ b.double()
    got = mm6(a, b)
    assert torch.equal(got, mm6(a, b))
    err6 = float((got.double() - ref).abs().max())
    err32 = float(((a @ b).double() - ref).abs().max())
    assert err6 <= 2 * err32


def test_two_planes_or_one_miss_float32_accuracy():
    """What the float64 gate on the card rejects: two planes (four
    products' worth) or one lose bits a float32 product keeps."""
    rng = np.random.RandomState(11)
    a = torch.tensor(rng.randn(4, 64, 128).astype(np.float32))
    b = torch.tensor(rng.randn(4, 128, 64).astype(np.float32))
    ref = a.double() @ b.double()
    err32 = float(((a @ b).double() - ref).abs().max())
    (a0, a1, _), (b0, b1, _) = split3(a), split3(b)
    two = a0 @ b0 + a0 @ b1 + a1 @ b0
    one = a0 @ b0
    assert float((two.double() - ref).abs().max()) > 8 * err32
    assert float((one.double() - ref).abs().max()) > 8 * err32


# ------------------------------------------------- schedules at the tiles
@pytest.mark.parametrize("kernel", ["dq", "dkv"])
@pytest.mark.parametrize("d", [32, 64, 128, 256])
@pytest.mark.parametrize("tq,tk,causal", _RAGGED)
def test_plane_schedule_matches_plain(kernel, d, tq, tk, causal):
    """The plane design's block schedules at their tiles for head dim d
    (dq: 64-row q tiles over 64-key blocks at D 64, 32-key at D 128,
    16-key at D 256, 128-row tiles over 64-key blocks at D 32; dk/dv:
    64-row k blocks over 64-, 32- or (by role) 32-row q blocks, 128-row k
    blocks over 64-row q blocks at D 32), with every product as six plane
    products (at D 32 hi·hi apart, dk and dv flushed), against the plain
    versions, float32, at ragged T."""
    q, k, v, do, lse, delta, scale = _case(tq, tk, causal, d,
                                           seed=tq + tk + causal + d)
    qs = fa._prescale(q, scale)
    if kernel == "dq":
        got = (dq_model(qs, k, v, do, lse, delta, scale, causal, d),)
        want = (fa.flash_dq_ref(q, k, v, do, lse, delta, scale, causal),)
    else:
        got = dkv_model(qs, k, v, do, lse, delta, causal, d)
        want = fa.flash_dkv_ref(q, k, v, do, lse, delta, scale, causal)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=2e-5,
                                   rtol=1e-4)


@pytest.mark.parametrize("d", [32, 64, 128, 256])
@pytest.mark.parametrize("tq,tk,causal", _RAGGED)
def test_fwd_plane_schedule_matches_plain(d, tq, tk, causal):
    """The forward's block schedule at its tiles for head dim d (128-row q
    tiles over 64-key blocks at D 32 and 64, 32-key at D 128 and 256), s
    and p·v as six plane products (at D 32 o's hi·hi apart), against the
    plain forward, float32, at ragged T: o and lse."""
    q, k, v, *_, scale = _case(tq, tk, causal, d, seed=tq + tk + causal + d)
    got = fwd_model(fa._prescale(q, scale), k, v, causal, d)
    want = fa.flash_fwd_ref(q, k, v, scale, causal)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=2e-5,
                                   rtol=1e-4)


@pytest.mark.parametrize("d", [32, 64, 128, 256])
def test_plane_schedule_matches_plain_with_plain_products(d):
    """The same schedules with plain float32 products: the schedule alone
    (the alternating blocks and the partials' sum, the warpgroups' rows
    and skipped blocks, the flushes, or the roles) is exact
    bookkeeping."""
    q, k, v, do, lse, delta, scale = _case(200, 200, True, d, seed=d)
    qs = fa._prescale(q, scale)
    got = dq_model(qs, k, v, do, lse, delta, scale, True, d,
                   mm=torch.matmul)
    np.testing.assert_allclose(
        got.numpy(), fa.flash_dq_ref(q, k, v, do, lse, delta, scale,
                                     True).numpy(), atol=2e-5, rtol=1e-4)
    got = dkv_model(qs, k, v, do, lse, delta, True, d, mm=torch.matmul)
    want = fa.flash_dkv_ref(q, k, v, do, lse, delta, scale, True)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=2e-5,
                                   rtol=1e-4)
    if d in _FWD_TILES:
        got = fwd_model(qs, k, v, True, d, mm=torch.matmul)
        for g, w in zip(got, fa.flash_fwd_ref(q, k, v, scale, True)):
            np.testing.assert_allclose(g.numpy(), w.numpy(), atol=2e-5,
                                       rtol=1e-4)


# ------------------------------------------- against the Pallas kernels
def _jax_grads(x, causal):
    q, k, v = (jnp.asarray(x[n]) for n in ("q", "k", "v"))

    def f(q, k, v):
        return jax_flash(q, k, v, causal=causal, interpret=True,
                         return_lse=True)

    _, vjp = jax.vjp(f, q, k, v)
    dq, dk, dv = vjp((jnp.asarray(x["do"]), jnp.asarray(x["dlse"])))
    return {n: np.asarray(a) for n, a in dict(dq=dq, dk=dk, dv=dv).items()}


@pytest.mark.parametrize("kernel,d,T,causal", [("dq", 64, 128, True),
                                               ("dkv", 128, 96, False),
                                               ("dq", 256, 80, True),
                                               ("dkv", 256, 80, True),
                                               ("dkv", 256, 96, False),
                                               ("dq", 32, 200, True),
                                               ("dkv", 32, 130, False)])
def test_plane_schedule_matches_pallas(kernel, d, T, causal):
    """One case a kernel: the plane model from the plain forward's saved
    rows against the JAX package's gradients (Pallas kernels in interpret
    mode), float32 atol 2e-4."""
    rng = np.random.RandomState(T + d)
    x = {"q": (rng.randn(1, 2, T, d) * 0.5).astype(np.float32),
         "k": (rng.randn(1, 2, T, d) * 0.5).astype(np.float32),
         "v": rng.randn(1, 2, T, d).astype(np.float32),
         "do": rng.randn(1, 2, T, d).astype(np.float32),
         "dlse": rng.randn(1, 2, T).astype(np.float32)}
    want = _jax_grads(x, causal)
    q, k, v, do = (torch.tensor(x[n]).reshape(2, T, d)
                   for n in ("q", "k", "v", "do"))
    scale = d ** -0.5
    o, lse = fa.flash_fwd_ref(q, k, v, scale, causal)
    delta = (do * o).sum(-1) - torch.tensor(x["dlse"]).reshape(2, T)
    qs = fa._prescale(q, scale)
    if kernel == "dq":
        got = {"dq": dq_model(qs, k, v, do, lse, delta, scale, causal, d)}
    else:
        dk, dv = dkv_model(qs, k, v, do, lse, delta, causal, d)
        got = {"dk": dk, "dv": dv}
    for name, g in got.items():
        np.testing.assert_allclose(g.reshape(1, 2, T, d).numpy(),
                                   want[name], atol=2e-4, err_msg=name)


@pytest.mark.parametrize("d,T,causal", [(64, 200, True), (128, 96, False),
                                        (256, 80, True), (32, 200, True),
                                        (32, 130, False)])
def test_fwd_plane_schedule_matches_pallas(d, T, causal):
    """The forward's plane model against the JAX package's Pallas forward
    in interpret mode: o and lse, float32 atol 2e-5."""
    rng = np.random.RandomState(T + d)
    x = {n: rng.randn(1, 2, T, d).astype(np.float32) for n in "qkv"}
    want = jax_flash(*(jnp.asarray(x[n]) for n in "qkv"), causal=causal,
                     interpret=True, return_lse=True)
    q, k, v = (torch.tensor(x[n]).reshape(2, T, d) for n in "qkv")
    scale = d ** -0.5
    got = fwd_model(fa._prescale(q, scale), k, v, causal, d)
    for name, g, w in zip(("o", "lse"), got, want):
        np.testing.assert_allclose(g.reshape(np.shape(w)).numpy(),
                                   np.asarray(w), atol=2e-5, err_msg=name)


# ----------------------------------------------------- against float64
def _f64_grads(qs, k, v, do, lse, delta, scale, causal):
    s = qs.double() @ k.double().transpose(1, 2)
    if causal:
        keep = torch.ones(s.shape[1:], dtype=torch.bool).tril()
        s = s.masked_fill(~keep, -torch.inf)
    p = torch.exp(s - lse.double()[..., None])
    ds = p * (do.double() @ v.double().transpose(1, 2)
              - delta.double()[..., None])
    return {"dq": ds @ k.double() * scale,
            "dk": ds.transpose(1, 2) @ qs.double(),
            "dv": p.transpose(1, 2) @ do.double()}


@pytest.mark.parametrize("d", [32, 64, 128, 256])
def test_plane_model_error_within_twice_plain(d):
    """Against float64, the modelled kernels' largest error is at most
    twice the plain float32 version's, per gradient (the card's gate,
    F32_F64_RATIO, allows 8x for the tensor cores' accumulation)."""
    q, k, v, do, lse, delta, scale = _case(256, 256, True, d, seed=40 + d)
    qs = fa._prescale(q, scale)
    ref = _f64_grads(qs, k, v, do, lse, delta, scale, True)
    model = {"dq": dq_model(qs, k, v, do, lse, delta, scale, True, d)}
    model["dk"], model["dv"] = dkv_model(qs, k, v, do, lse, delta, True, d)
    plain = {"dq": fa.flash_dq_ref(q, k, v, do, lse, delta, scale, True)}
    plain["dk"], plain["dv"] = fa.flash_dkv_ref(q, k, v, do, lse, delta,
                                                scale, True)
    for name, r in ref.items():
        em = float((model[name].double() - r).abs().max())
        ep = float((plain[name].double() - r).abs().max())
        assert em <= 2 * ep, (name, em, ep)


@pytest.mark.parametrize("d", [32, 64, 128, 256])
def test_fwd_plane_model_error_within_twice_plain(d):
    """Against float64, the modelled forward's largest error in o and in
    lse is at most twice the plain float32 version's."""
    q, k, v, *_, scale = _case(256, 256, True, d, seed=50 + d)
    qs = fa._prescale(q, scale)
    s = qs.double() @ k.double().transpose(1, 2)
    s = s.masked_fill(~torch.ones(256, 256, dtype=torch.bool).tril(),
                      -torch.inf)
    lse = torch.logsumexp(s, -1)
    ref = (torch.exp(s - lse[..., None]) @ v.double(), lse)
    model = fwd_model(qs, k, v, True, d)
    plain = fa.flash_fwd_ref(q, k, v, scale, True)
    for name, m, p, r in zip(("o", "lse"), model, plain, ref):
        em = float((m.double() - r).abs().max())
        ep = float((p.double() - r).abs().max())
        assert em <= 2 * ep, (name, em, ep)


def test_wrapper_passes_plane_scratch_only_to_the_plane_design():
    """The wrapper's scratch for the planes: 6·(q + k elements) bf16 for
    float32 dq and dk/dv at D 32, 64 and 128 (q, do, k, v), 3·(q + 2·k
    elements) for the forward (q, k, v) at D 32, 64 and 128; at D 256 6·k
    elements for the forward and dq (k, v) and 6·q for dk/dv (q, do); none
    for bf16; a launch takes the scratch with its size (``_scratch``)."""
    f32 = torch.zeros(2, 8, 128)
    for kernel in ("flash_dq", "flash_dkv"):
        assert fa._planes(f32, torch.zeros(2, 4, 128), kernel).shape == (
            6 * (2 * 8 * 128 + 2 * 4 * 128),)
        assert fa._planes(f32, f32, kernel).dtype == torch.bfloat16
        assert fa._planes(torch.zeros(2, 8, 64), torch.zeros(2, 8, 64),
                          kernel) is not None
    assert fa._planes(f32, torch.zeros(2, 4, 128), "flash_fwd").shape \
        == (3 * (2 * 8 * 128 + 2 * 2 * 4 * 128),)
    assert fa._planes(torch.zeros(2, 8, 64), torch.zeros(2, 8, 64),
                      "flash_fwd").dtype == torch.bfloat16
    wide_q, wide_k = torch.zeros(2, 8, 256), torch.zeros(2, 4, 256)
    assert fa._planes(wide_q, wide_k, "flash_dq").shape == (
        6 * 2 * 4 * 256,)
    assert fa._planes(wide_q, wide_k, "flash_dkv").shape == (
        6 * 2 * 8 * 256,)
    assert fa._planes(wide_q, wide_k, "flash_fwd").shape == (
        6 * 2 * 4 * 256,)
    p, n = fa._scratch(wide_q, wide_k, "flash_dkv")
    assert p.shape == (n,)
    p, n = fa._scratch(wide_q, wide_k, "flash_fwd")
    assert p.shape == (n,) and n == 6 * 2 * 4 * 256
    narrow_q, narrow_k = torch.zeros(2, 8, 32), torch.zeros(2, 4, 32)
    for kernel in ("flash_dq", "flash_dkv"):
        assert fa._planes(narrow_q, narrow_k, kernel).shape == (
            6 * (2 * 8 * 32 + 2 * 4 * 32),)
    assert fa._planes(narrow_q, narrow_k, "flash_fwd").shape == (
        3 * (2 * 8 * 32 + 2 * 2 * 4 * 32),)
    for kernel in ("flash_fwd", "flash_dq", "flash_dkv"):
        bf = torch.zeros(2, 8, 128, dtype=torch.bfloat16)
        assert fa._planes(bf, bf, kernel) is None


@pytest.mark.parametrize("kernel", ["flash_fwd", "flash_dq", "flash_dkv"])
@pytest.mark.parametrize("d", [32, 64, 128, 256])
def test_plane_split_fills_the_launch_scratch(kernel, d):
    """The split alone (on CPU tensors its plain version) returns the
    scratch a float32 launch of ``kernel`` would take (``_planes``' size
    and type), holding split3's hi, mid and lo of each operand the launch
    splits, in the order q, do, k, v (the forward has no do; at D 256 k
    and v for the forward and dq, q and do for dk/dv), each as [3, bh, T,
    D]."""
    rng = np.random.RandomState(d)
    qs, do = (torch.tensor(rng.randn(2, 24, d).astype(np.float32))
              for _ in range(2))
    k, v = (torch.tensor(rng.randn(2, 40, d).astype(np.float32))
            for _ in range(2))
    got = fa.plane_split(kernel, qs, k, v,
                         None if kernel == "flash_fwd" else do)
    want = fa._planes(qs, k, kernel)
    assert got.dtype == want.dtype == torch.bfloat16
    assert got.shape == want.shape
    if d == 256:
        ops = (qs, do) if kernel == "flash_dkv" else (k, v)
    else:
        ops = (qs, k, v) if kernel == "flash_fwd" else (qs, do, k, v)
    at = 0
    for x in ops:
        planes = got[at:at + 3 * x.numel()].view(3, *x.shape).float()
        for p, w in zip(planes, split3(x)):
            assert torch.equal(p, w)
        at += 3 * x.numel()
    assert at == got.numel()


def test_plane_split_pads_as_the_launch_does():
    """At a head dim outside the compiled set the split is that of the
    operands zero-padded to the next one (D 200: 256's, whose forward
    splits k and v alone)."""
    rng = np.random.RandomState(200)
    qs, k = (torch.tensor(rng.randn(1, 8, 200).astype(np.float32))
             for _ in range(2))
    got = fa.plane_split("flash_fwd", qs, k, k)
    pad = torch.nn.functional.pad(k, (0, 56))
    assert got.shape == (2 * 3 * 8 * 256,)
    assert torch.equal(got, fa._split_plain("flash_fwd", pad, pad, pad,
                                            None))


def test_plane_split_refuses_bf16():
    x = torch.zeros(1, 8, 32, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="float32"):
        fa.plane_split("flash_fwd", x, x, x)


# ------------------------------------- the float32 tile's fragment loads
_GROUP = 64 * 8  # floats of one 8-column group of a 64-row F32Tile


def _f32_tile(x):
    """A [64, D] float32 tile laid out as F32Tile stores it: D / 8 groups
    of [64, 8] floats, flattened."""
    d = x.shape[1]
    return x.reshape(64, d // 8, 8).transpose(0, 1).reshape(-1)


def _fragment_planes(flat, d):
    """Each warpgroup thread's A fragments, as f32_rs_scores loads them
    from an F32Tile (``flat``) and splits them in registers, scattered back
    to [64, D] planes by the wgmma A layout (register i of step x: row r0
    + 8·(i % 2), columns 16x + cq + 8·(i // 2) and the next), with how
    often each element was loaded and each warp's load addresses."""
    planes = [torch.zeros(64, d) for _ in range(3)]
    seen = torch.zeros(64, d, dtype=torch.int64)
    addrs = {}
    for warp in range(4):
        for lane in range(32):
            r0, cq = 16 * warp + lane // 4, 2 * (lane % 4)
            for x in range(d // 16):
                lo = 2 * x * _GROUP + r0 * 8 + cq
                for i, at in enumerate((lo, lo + 64, lo + _GROUP,
                                        lo + _GROUP + 64)):
                    addrs.setdefault((warp, x, i), []).append(at)
                    pair = split3(flat[at:at + 2])
                    row = r0 + 8 * (i % 2)
                    col = 16 * x + cq + 8 * (i // 2)
                    for p in range(3):
                        planes[p][row, col:col + 2] = pair[p]
                    seen[row, col:col + 2] += 1
    return planes, seen, addrs


def test_register_split_of_fragments_matches_split_of_the_tensor():
    """Splitting each thread's float32 fragment of an F32Tile in registers
    (D 256, q or do in dq, k or v in dk/dv) gives, over the warpgroup, the
    planes of split3 of the whole tile bit for bit, every element loaded
    once; and each warp's load reads 256 contiguous bytes (no bank
    conflicts)."""
    rng = np.random.RandomState(9)
    x = torch.tensor((rng.randn(64, 256)
                      * 10.0 ** rng.uniform(-3, 3, (64, 256)))
                     .astype(np.float32))
    planes, seen, addrs = _fragment_planes(_f32_tile(x), 256)
    assert bool((seen == 1).all())
    for got, want in zip(planes, split3(x)):
        assert torch.equal(got, want)
    for at in addrs.values():
        assert sorted(at) == list(range(min(at), min(at) + 64, 2))


@pytest.mark.parametrize("causal", [True, False])
def test_roles_schedule_flushes_its_sums(causal):
    """dk/dv at D 256 past one flush (8 q blocks of 32 rows): T 330 runs
    up to 11 blocks a k block, so the first flush stores and the second
    adds; against the plain version, float32."""
    q, k, v, do, lse, delta, scale = _case(330, 330, causal, 256, seed=330)
    qs = fa._prescale(q, scale)
    got = dkv_model(qs, k, v, do, lse, delta, causal, 256)
    want = fa.flash_dkv_ref(q, k, v, do, lse, delta, scale, causal)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=2e-5,
                                   rtol=1e-4)


@pytest.mark.parametrize("causal", [True, False])
def test_d32_schedule_flushes_dk_and_dv(causal):
    """dk/dv at D 32 past a flush (every 8 of a warpgroup's 64-row q
    blocks): 1,090 queries run 18 q blocks over 130 keys' two 128-row k
    blocks, so each warpgroup flushes after its eighth and sixteenth
    block of the loop and sums on (causal, warpgroup 1 skips each k
    block's first q block, which counts); with hi·hi apart, against the
    plain version, float32."""
    assert _BY_ROWS[32][1] == (True, 8)
    q, k, v, do, lse, delta, scale = _case(1090, 130, causal, 32,
                                           seed=1090 + causal)
    qs = fa._prescale(q, scale)
    got = dkv_model(qs, k, v, do, lse, delta, causal, 32)
    want = fa.flash_dkv_ref(q, k, v, do, lse, delta, scale, causal)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=2e-5,
                                   rtol=1e-4)
