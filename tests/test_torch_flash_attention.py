"""Parity of the PyTorch port's flash attention with the JAX package.

On the CPU the port's wrappers run their plain versions (the CUDA
kernels run only on the card; ``chip_smoke.py`` holds each kernel against
its plain version there).  The JAX side runs its Pallas kernels in
interpret mode, as ``tests/test_flash_attention.py`` does.  Inputs are
seeded numpy arrays fed to both.

Tolerances, as ``tests/test_flash_attention.py`` states them: float32
atol 2e-5 for o and lse, 2e-4 for gradients; bfloat16 2e-2.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiverso_tpu.ops import flash_attention as jax_flash
from multiverso_tpu_torch.ops import flash_attention as fa

# The JAX package's parallel/__init__ re-exports a function named
# ring_attention that shadows its module; import both modules by path.
jax_ring = importlib.import_module("multiverso_tpu.parallel.ring_attention")
port_ring = importlib.import_module(
    "multiverso_tpu_torch.parallel.ring_attention")

B, H, D = 1, 2, 32
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(T, seed, tk=None, d=D):
    rng = np.random.RandomState(seed)
    tk = tk or T
    return {
        "q": (rng.randn(B, H, T, d) * 0.5).astype(np.float32),
        "k": (rng.randn(B, H, tk, d) * 0.5).astype(np.float32),
        "v": rng.randn(B, H, tk, d).astype(np.float32),
        "do": rng.randn(B, H, T, d).astype(np.float32),
        "dlse": rng.randn(B, H, T).astype(np.float32),
    }


def _jax_side(x, causal, dtype):
    jdt = JDT[dtype]
    q, k, v = (jnp.asarray(x[n]).astype(jdt) for n in ("q", "k", "v"))

    def f(q, k, v):
        return jax_flash(q, k, v, causal=causal, interpret=True,
                         return_lse=True)

    (o, lse), vjp = jax.vjp(f, q, k, v)
    dq, dk, dv = vjp((jnp.asarray(x["do"]).astype(jdt),
                      jnp.asarray(x["dlse"])))
    return {n: np.asarray(a.astype(jnp.float32)) for n, a in
            dict(o=o, lse=lse, dq=dq, dk=dk, dv=dv).items()}


def _port_side(x, causal, dtype):
    tdt = TDT[dtype]
    q, k, v = (torch.tensor(x[n]).to(tdt).requires_grad_()
               for n in ("q", "k", "v"))
    o, lse = fa.flash_attention(q, k, v, causal=causal, return_lse=True)
    torch.autograd.backward((o, lse), (torch.tensor(x["do"]).to(tdt),
                                       torch.tensor(x["dlse"])))
    out = dict(o=o, lse=lse, dq=q.grad, dk=k.grad, dv=v.grad)
    return {n: a.detach().float().numpy() for n, a in out.items()}


# Head dim D (32) at every T, and D 256 (the kernels' other column
# layouts: the forward's and dq's 128-column halves, dk/dv's split) at T
# 128; the earlier cases keep their ids.
@pytest.mark.parametrize("T,causal,d", [
    pytest.param(T, causal, D, id=f"{T}-{causal}")
    for T in (64, 128, 192, 256) for causal in (True, False)] + [
    pytest.param(128, causal, 256, id=f"128-{causal}-d256")
    for causal in (True, False)])
def test_plain_matches_pallas_f32(T, causal, d):
    x = _inputs(T, seed=T + causal, d=d)
    want = _jax_side(x, causal, "float32")
    got = _port_side(x, causal, "float32")
    for name in ("o", "lse"):
        np.testing.assert_allclose(got[name], want[name], atol=2e-5,
                                   err_msg=name)
    for name in ("dq", "dk", "dv"):
        np.testing.assert_allclose(got[name], want[name], atol=2e-4,
                                   err_msg=name)


@pytest.mark.parametrize("causal,d", [
    pytest.param(causal, D, id=f"{causal}") for causal in (True, False)] + [
    pytest.param(causal, 256, id=f"{causal}-d256")
    for causal in (True, False)])
def test_plain_matches_pallas_bf16(causal, d):
    x = _inputs(128, seed=7 + causal, d=d)
    want = _jax_side(x, causal, "bfloat16")
    got = _port_side(x, causal, "bfloat16")
    for name in ("o", "lse", "dq", "dk", "dv"):
        np.testing.assert_allclose(got[name], want[name], atol=2e-2,
                                   rtol=2e-2, err_msg=name)


def _dense_grads(x, causal):
    """Autograd of plain float64 softmax attention: the definition the
    kernels' pre-scaled-q bookkeeping must reproduce."""
    q, k, v = (torch.tensor(x[n], dtype=torch.float64).requires_grad_()
               for n in ("q", "k", "v"))
    s = torch.einsum("bhtd,bhsd->bhts", q, k) * D ** -0.5
    if causal:
        T = s.shape[-1]
        s = s.masked_fill(~torch.ones(T, T, dtype=torch.bool).tril(),
                          float("-inf"))
    lse = torch.logsumexp(s, -1)
    o = torch.einsum("bhts,bhsd->bhtd", torch.softmax(s, -1), v)
    torch.autograd.backward((o, lse), (torch.tensor(x["do"]).double(),
                                       torch.tensor(x["dlse"]).double()))
    return {"o": o, "lse": lse, "dq": q.grad, "dk": k.grad, "dv": v.grad}


@pytest.mark.parametrize("causal", [True, False])
def test_prescaled_q_grads_match_dense_definition(causal):
    """Trap: q is pre-scaled before the kernels; dq takes the scale once
    at the end and dk must not take it again.  Hold the plain path's
    gradients to autograd of unscaled dense attention."""
    x = _inputs(96, seed=11)
    want = {n: a.detach().numpy() for n, a in
            _dense_grads(x, causal).items()}
    got = _port_side(x, causal, "float32")
    for name in want:
        np.testing.assert_allclose(got[name], want[name], atol=2e-5,
                                   rtol=1e-4, err_msg=name)


def test_prescale_rounds_in_input_dtype():
    rng = np.random.RandomState(3)
    q = rng.randn(2, 64, 32).astype(np.float32)
    scale = 32 ** -0.5
    want = np.asarray((jnp.asarray(q).astype(jnp.bfloat16)
                       .astype(jnp.float32) * scale).astype(jnp.bfloat16)
                      .astype(jnp.float32))
    got = fa._prescale(torch.tensor(q).to(torch.bfloat16), scale).float()
    np.testing.assert_array_equal(got.numpy(), want)


def test_ragged_length_and_cross_length():
    """Any T works (no block-fit policy): T=100 causal, and Tq != Tk
    without the causal mask, against the float64 definition."""
    x = _inputs(100, seed=5)
    want = _dense_grads(x, causal=True)
    got = _port_side(x, True, "float32")
    np.testing.assert_allclose(got["o"], want["o"].detach().numpy(),
                               atol=2e-5)
    xs = _inputs(40, seed=6, tk=72)
    q, k, v = (torch.tensor(xs[n]) for n in ("q", "k", "v"))
    o = fa.flash_attention(q, k, v, causal=False)
    s = torch.einsum("bhtd,bhsd->bhts", q.double(), k.double()) * D ** -0.5
    ref = torch.einsum("bhts,bhsd->bhtd", torch.softmax(s, -1), v.double())
    np.testing.assert_allclose(o.numpy(), ref.numpy(), atol=2e-5)
    with pytest.raises(ValueError, match="Tq == Tk"):
        fa.flash_attention(q, k, v, causal=True)


def test_rejects_unsupported_head_dim_and_dtype():
    # A CUDA tensor runs the kernels of the next head dim in the set on
    # zero-padded operands, and one past the largest raises (the check
    # _check makes for a CUDA tensor); on the CPU any head dim runs (see
    # test_head_dims_outside_the_kernels_set_match_pallas).  An
    # unsupported dtype raises on either device.
    assert [fa._kernel_dim(d) for d in (16, 32, 48, 96, 200, 256)] == \
        [32, 32, 64, 128, 256, 256]
    with pytest.raises(ValueError, match=r"\(32, 64, 128, 256\)"):
        fa._kernel_dim(320)
    q = torch.zeros(1, 1, 16, 32, dtype=torch.float16)
    with pytest.raises(ValueError, match="not supported"):
        fa.flash_attention(q, q, q)


@pytest.mark.parametrize("d", [16, 48])
def test_head_dims_outside_the_kernels_set_match_pallas(d):
    """The JAX tests' transformer runs heads of 16; both packages take
    head dims the port's kernels were not compiled for."""
    x = _inputs(64, seed=40 + d, d=d)
    want = _jax_side(x, True, "float32")
    fa.reset_launch_counts()
    got = _port_side(x, True, "float32")
    assert fa.launch_counts() == {"flash_fwd": 0, "flash_dq": 0,
                                  "flash_dkv": 0}
    for name in ("o", "lse"):
        np.testing.assert_allclose(got[name], want[name], atol=2e-5)
    for name in ("dq", "dk", "dv"):
        np.testing.assert_allclose(got[name], want[name], atol=2e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [16, 48, 96])
def test_zero_padded_head_dim_leaves_outputs_unchanged(d, dtype):
    """What a CUDA launch at a head dim outside the set relies on: the
    three functions on operands zero-padded along D to ``_kernel_dim``,
    cut back to D, give the unpadded results (float32 2e-5, bfloat16
    2e-2)."""
    tol = 2e-5 if dtype == "float32" else 2e-2
    x = _inputs(40, seed=60 + d, d=d)
    q, k, v, do = (torch.tensor(x[n]).to(TDT[dtype])[0]
                   for n in ("q", "k", "v", "do"))
    scale = d ** -0.5
    o, lse = fa.flash_fwd_ref(q, k, v, scale, True)
    delta = (do.float() * o.float()).sum(-1)
    want = [o, lse,
            fa.flash_dq_ref(q, k, v, do, lse, delta, scale, True),
            *fa.flash_dkv_ref(q, k, v, do, lse, delta, scale, True)]
    pq, pk, pv, pdo = fa._pad(fa._kernel_dim(d), q, k, v, do)
    po, plse = fa.flash_fwd_ref(pq, pk, pv, scale, True)
    got = [po, plse,
           fa.flash_dq_ref(pq, pk, pv, pdo, lse, delta, scale, True),
           *fa.flash_dkv_ref(pq, pk, pv, pdo, lse, delta, scale, True)]
    for g, w in zip(got, want):
        if g.dim() == 2:                          # lse: no head dim
            np.testing.assert_allclose(g.numpy(), w.numpy(), atol=tol)
            continue
        assert not g[..., d:].any()               # the padding stays zero
        np.testing.assert_allclose(g[..., :d].float().numpy(),
                                   w.float().numpy(), atol=tol)


def test_cpu_tensors_take_plain_path_without_launches():
    fa.reset_launch_counts()
    x = _inputs(64, seed=9)
    _port_side(x, True, "float32")
    assert fa.launch_counts() == {"flash_fwd": 0, "flash_dq": 0,
                                  "flash_dkv": 0}


def test_forward_is_a_dispatcher_op():
    """The forward launch is ``torch.ops.mvt.flash_fwd``: on CPU tensors
    it runs the plain version; its fake (meta) version gives the output
    shapes a checkpoint policy or a tracer sees without running it."""
    x = _inputs(48, seed=10)
    q, k, v = (torch.as_tensor(x[n][0]) for n in ("q", "k", "v"))
    qs, kc, vc = fa._prepare(q, k, v, D ** -0.5)
    o, lse = torch.ops.mvt.flash_fwd(qs, kc, vc, True)
    want_o, want_lse = fa.flash_fwd_ref(q, k, v, D ** -0.5, True)
    assert torch.equal(o, want_o) and torch.equal(lse, want_lse)
    meta = [t.to("meta") for t in (qs, kc, vc)]
    mo, mlse = torch.ops.mvt.flash_fwd(*meta, True)
    assert mo.shape == o.shape and mo.dtype == o.dtype
    assert mlse.shape == lse.shape and mlse.dtype == torch.float32


@pytest.mark.parametrize("causal", [True, False])
def test_blockwise_local_matches_jax(causal):
    """The dispatcher the transformer calls, against the JAX package's
    CPU path (its jnp streaming softmax)."""
    x = _inputs(128, seed=13)
    scale = D ** -0.5
    want = jax_ring.blockwise_attention_local(
        *(jnp.asarray(x[n]) for n in ("q", "k", "v")), scale, causal=causal)
    got = port_ring.blockwise_attention_local(
        *(torch.tensor(x[n]) for n in ("q", "k", "v")), scale,
        causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def test_offset_blocks_and_attn_piece_match_jax():
    x = _inputs(64, seed=15)
    scale = D ** -0.5
    jq, jk, jv = (jnp.asarray(x[n]) for n in ("q", "k", "v"))
    tq, tk, tv = (torch.tensor(x[n]) for n in ("q", "k", "v"))
    want = jax_ring.blockwise_attention_local(jq, jk, jv, scale, True,
                                              q_offset=64, k_offset=32)
    got = port_ring.blockwise_attention_local(tq, tk, tv, scale, True,
                                              q_offset=64, k_offset=32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
    jo, jlse = jax_ring._attn_piece(jq, jk, jv, scale, True)
    po, plse = port_ring._attn_piece(tq, tk, tv, scale, True)
    np.testing.assert_allclose(po.numpy(), np.asarray(jo), atol=2e-5)
    np.testing.assert_allclose(plse.numpy(), np.asarray(jlse), atol=2e-5)
    # Without a mesh the ring is the local path, as on a JAX mesh whose
    # sp, batch and head axes are absent (the ring: test_torch_mesh.py).
    np.testing.assert_array_equal(
        port_ring.ring_attention(tq, tk, tv).numpy(),
        port_ring.blockwise_attention_local(tq, tk, tv, scale).numpy())


# ------------------------------------------------ the Hopper kernels' schedule
# Plain-torch models of the block schedules that csrc/flash_fwd.cu,
# csrc/flash_dq.cu and csrc/flash_dkv.cu run for bf16 (all three at D 32,
# 64, 128 and 256; one block of two 64-row consumer warpgroups per tile),
# so their index arithmetic is held to the plain versions here, in
# float32, before it runs on the card: zero-filled tiles past T (what the
# TMA loads give), the causal start and end blocks, the per-warpgroup skip
# of dk/dv and of dq's 64-key blocks at D 32 (which 128-key blocks and D
# 256's 64-row blocks never need), D 256's column split of dk and dv and
# of dq, and masks only on straddling or ragged blocks.  The tiles by D
# are the kernels' (HopFwd, HopDq, HopDqCols, HopDkv, HopDkvCols).
_NEG = -1e30


def _pad_rows(x, rows):
    return torch.nn.functional.pad(x, (0, 0, 0, rows - x.shape[1]))


def _fwd_schedule(qs, k, v, causal, BQ=128, BK=128):
    bh, tq, d = qs.shape
    tk = k.shape[1]
    nqt, nk = -(-tq // BQ), -(-tk // BK)
    qp, kp, vp = _pad_rows(qs, nqt * BQ), _pad_rows(k, nk * BK), \
        _pad_rows(v, nk * BK)
    o = torch.zeros(bh, tq, d)
    lse = torch.zeros(bh, tq)
    for qt in range(nqt):
        q0 = qt * BQ
        kend = min(nk, (q0 + BQ - 1) // BK + 1) if causal else nk
        for g in range(2):
            qw = q0 + 64 * g
            rows = torch.arange(qw, qw + 64)
            acc = torch.zeros(bh, 64, d)
            m = torch.full((bh, 64), _NEG)
            l = torch.zeros(bh, 64)
            for kb in range(kend):
                k0 = kb * BK
                s = qp[:, qw:qw + 64] @ kp[:, k0:k0 + BK].transpose(1, 2)
                if (causal and k0 + BK - 1 > qw) or k0 + BK > tk:
                    cols = torch.arange(k0, k0 + BK)
                    out = (cols >= tk)[None, :] | (
                        causal & (cols[None, :] > rows[:, None]))
                    s = s.masked_fill(out, _NEG)
                mx = torch.maximum(m, s.amax(-1))
                corr = torch.exp(m - mx)
                p = torch.exp(s - mx[..., None])
                l = l * corr + p.sum(-1)
                acc = acc * corr[..., None] + p @ vp[:, k0:k0 + BK]
                m = mx
            n = max(0, min(64, tq - qw))
            lc = l.clamp_min(1e-30)
            o[:, qw:qw + n] = (acc / lc[..., None])[:, :n]
            lse[:, qw:qw + n] = (m + torch.log(lc))[:, :n]
    return o, lse


def _dkv_schedule(qs, k, v, do, lse, delta, causal, BK=128, BQ=64):
    bh, tq, d = qs.shape
    if BK == BQ == 64:
        return _dkv_cols_schedule(qs, k, v, do, lse, delta, causal)
    tk = k.shape[1]
    nk, nq = -(-tk // BK), -(-tq // BQ)
    qp, dop = _pad_rows(qs, nq * BQ), _pad_rows(do, nq * BQ)
    kp, vp = _pad_rows(k, nk * BK), _pad_rows(v, nk * BK)
    lsep = torch.nn.functional.pad(lse, (0, nq * BQ - tq))
    dlp = torch.nn.functional.pad(delta, (0, nq * BQ - tq))
    dk, dv = torch.zeros(bh, tk, d), torch.zeros(bh, tk, d)
    for kb in range(nk):
        k0 = kb * BK
        qstart = k0 // BQ if causal else 0
        for g in range(2):
            kw = k0 + 64 * g
            krows = torch.arange(kw, kw + 64)
            dk_acc, dv_acc = torch.zeros(bh, 64, d), torch.zeros(bh, 64, d)
            for qb in range(qstart, nq):
                q0 = qb * BQ
                if causal and q0 + BQ - 1 < kw:
                    continue
                qt, dot = qp[:, q0:q0 + BQ], dop[:, q0:q0 + BQ]
                st = kp[:, kw:kw + 64] @ qt.transpose(1, 2)
                dpt = vp[:, kw:kw + 64] @ dot.transpose(1, 2)
                if (causal and q0 < kw + 63) or kw + 64 > tk or q0 + BQ > tq:
                    qcols = torch.arange(q0, q0 + BQ)
                    out = ((krows[:, None] >= tk) | (qcols[None, :] >= tq)
                           | (causal & (krows[:, None] > qcols[None, :])))
                    st = st.masked_fill(out, _NEG)
                pt = torch.exp(st - lsep[:, None, q0:q0 + BQ])
                dst = pt * (dpt - dlp[:, None, q0:q0 + BQ])
                dv_acc += pt @ dot
                dk_acc += dst @ qt
            n = max(0, min(64, tk - kw))
            dk[:, kw:kw + n] = dk_acc[:, :n]
            dv[:, kw:kw + n] = dv_acc[:, :n]
    return dk, dv


def _dkv_cols_schedule(qs, k, v, do, lse, delta, causal):
    """D 256's dk/dv: one block of 64 k rows shared by both warpgroups;
    warpgroup g forms sᵀ and dpᵀ over q columns [32g, 32g + 32) of each
    64-row q block, the two halves meet as whole pᵀ and dsᵀ tiles (shared
    memory on the card), and warpgroup g keeps dk and dv over D columns
    [d/2·g, d/2·(g + 1))."""
    BK = BQ = 64
    bh, tq, d = qs.shape
    tk = k.shape[1]
    nk, nq = -(-tk // BK), -(-tq // BQ)
    qp, dop = _pad_rows(qs, nq * BQ), _pad_rows(do, nq * BQ)
    kp, vp = _pad_rows(k, nk * BK), _pad_rows(v, nk * BK)
    lsep = torch.nn.functional.pad(lse, (0, nq * BQ - tq))
    dlp = torch.nn.functional.pad(delta, (0, nq * BQ - tq))
    dk, dv = torch.zeros(bh, tk, d), torch.zeros(bh, tk, d)
    half = d // 2
    for kb in range(nk):
        k0 = kb * BK
        krows = torch.arange(k0, k0 + BK)
        kt, vt = kp[:, k0:k0 + BK], vp[:, k0:k0 + BK]
        acc = {g: (torch.zeros(bh, BK, half), torch.zeros(bh, BK, half))
               for g in range(2)}
        for qb in range(k0 // BQ if causal else 0, nq):
            q0 = qb * BQ
            # BQ == BK: every visited block reaches the block's k rows.
            assert not (causal and q0 + BQ - 1 < k0)
            mask = (causal and q0 < k0 + 63) or k0 + BK > tk or q0 + BQ > tq
            pts, dsts = [], []
            for g in range(2):
                c0 = q0 + 32 * g
                qt, dot = qp[:, c0:c0 + 32], dop[:, c0:c0 + 32]
                st = kt @ qt.transpose(1, 2)
                dpt = vt @ dot.transpose(1, 2)
                if mask:
                    qcols = torch.arange(c0, c0 + 32)
                    out = ((krows[:, None] >= tk) | (qcols[None, :] >= tq)
                           | (causal & (krows[:, None] > qcols[None, :])))
                    st = st.masked_fill(out, _NEG)
                pt = torch.exp(st - lsep[:, None, c0:c0 + 32])
                pts.append(pt)
                dsts.append(pt * (dpt - dlp[:, None, c0:c0 + 32]))
            pt, dst = torch.cat(pts, -1), torch.cat(dsts, -1)
            for g in range(2):
                cols = slice(half * g, half * (g + 1))
                acc[g][0].add_(dst @ qp[:, q0:q0 + BQ, cols])
                acc[g][1].add_(pt @ dop[:, q0:q0 + BQ, cols])
        n = max(0, min(BK, tk - k0))
        for g in range(2):
            cols = slice(half * g, half * (g + 1))
            dk[:, k0:k0 + n, cols] = acc[g][0][:, :n]
            dv[:, k0:k0 + n, cols] = acc[g][1][:, :n]
    return dk, dv


def _dq_schedule(qs, k, v, do, lse, delta, scale, causal, BQ=128, BK=128):
    bh, tq, d = qs.shape
    if BQ == BK == 64:
        return _dq_cols_schedule(qs, k, v, do, lse, delta, scale, causal)
    tk = k.shape[1]
    nqt, nk = -(-tq // BQ), -(-tk // BK)
    qp, dop = _pad_rows(qs, nqt * BQ), _pad_rows(do, nqt * BQ)
    kp, vp = _pad_rows(k, nk * BK), _pad_rows(v, nk * BK)
    # Rows past tq read lse and delta as 0 (their q and do are zeros).
    lsep = torch.nn.functional.pad(lse, (0, nqt * BQ - tq))
    dlp = torch.nn.functional.pad(delta, (0, nqt * BQ - tq))
    dq = torch.zeros(bh, tq, d)
    for qt in range(nqt):
        q0 = qt * BQ
        kend = min(nk, (q0 + BQ - BK) // BK + 1) if causal else nk
        for g in range(2):
            qw = q0 + 64 * g
            rows = torch.arange(qw, qw + 64)
            acc = torch.zeros(bh, 64, d)
            for kb in range(kend):
                k0 = kb * BK
                if causal and k0 > qw + 63:
                    # Only 64-key blocks (BK < BQ) reach past warpgroup
                    # 0's rows: the kernel skips the last for it.
                    assert BK < BQ and g == 0 and kb == kend - 1
                    continue
                kt = kp[:, k0:k0 + BK]
                s = qp[:, qw:qw + 64] @ kt.transpose(1, 2)
                dp = dop[:, qw:qw + 64] @ vp[:, k0:k0 + BK].transpose(1, 2)
                if (causal and k0 + BK - 1 > qw) or k0 + BK > tk:
                    cols = torch.arange(k0, k0 + BK)
                    out = ((cols[None, :] >= tk) | (rows[:, None] >= tq)
                           | (causal & (cols[None, :] > rows[:, None])))
                    s = s.masked_fill(out, _NEG)
                p = torch.exp(s - lsep[:, qw:qw + 64, None])
                acc += (p * (dp - dlp[:, qw:qw + 64, None])) @ kt
            n = max(0, min(64, tq - qw))
            dq[:, qw:qw + n] = (acc * scale)[:, :n]
    return dq


def _dq_cols_schedule(qs, k, v, do, lse, delta, scale, causal):
    """D 256's dq: one block of 64 q rows shared by both warpgroups;
    warpgroup g forms s and dp over keys [32g, 32g + 32) of each 64-key
    block, the two halves meet as one whole ds tile (shared memory on the
    card), and warpgroup g keeps dq over D columns [d/2·g, d/2·(g + 1))."""
    BQ = BK = 64
    bh, tq, d = qs.shape
    tk = k.shape[1]
    nqt, nk = -(-tq // BQ), -(-tk // BK)
    qp, dop = _pad_rows(qs, nqt * BQ), _pad_rows(do, nqt * BQ)
    kp, vp = _pad_rows(k, nk * BK), _pad_rows(v, nk * BK)
    lsep = torch.nn.functional.pad(lse, (0, nqt * BQ - tq))
    dlp = torch.nn.functional.pad(delta, (0, nqt * BQ - tq))
    dq = torch.zeros(bh, tq, d)
    half = d // 2
    for qt in range(nqt):
        q0 = qt * BQ
        rows = torch.arange(q0, q0 + BQ)
        qt_, dot = qp[:, q0:q0 + BQ], dop[:, q0:q0 + BQ]
        lrow, drow = lsep[:, q0:q0 + BQ, None], dlp[:, q0:q0 + BQ, None]
        acc = {g: torch.zeros(bh, BQ, half) for g in range(2)}
        for kb in range(min(nk, q0 // BK + 1) if causal else nk):
            k0 = kb * BK
            # BK == BQ: every visited block reaches the tile's rows.
            assert not (causal and k0 > q0 + BQ - 1)
            mask = (causal and k0 + BK - 1 > q0) or k0 + BK > tk
            dss = []
            for g in range(2):
                c0 = k0 + 32 * g
                s = qt_ @ kp[:, c0:c0 + 32].transpose(1, 2)
                dp = dot @ vp[:, c0:c0 + 32].transpose(1, 2)
                if mask:
                    cols = torch.arange(c0, c0 + 32)
                    out = ((cols[None, :] >= tk) | (rows[:, None] >= tq)
                           | (causal & (cols[None, :] > rows[:, None])))
                    s = s.masked_fill(out, _NEG)
                dss.append(torch.exp(s - lrow) * (dp - drow))
            ds = torch.cat(dss, -1)
            for g in range(2):
                acc[g].add_(ds @ kp[:, k0:k0 + BK, half * g:half * (g + 1)])
        n = max(0, min(BQ, tq - q0))
        for g in range(2):
            dq[:, q0:q0 + n, half * g:half * (g + 1)] = \
                (acc[g] * scale)[:, :n]
    return dq


# The kernels' tiles by head dim: (forward BQ, BK), (dq BQ, BK), (dk/dv
# BK, BQ).
_TILES = {32: ((128, 64), (128, 64), (128, 32)),
          64: ((128, 128), (128, 128), (128, 64)),
          256: ((128, 64), (64, 64), (64, 64))}
_RAGGED = [(130, 130, True), (130, 130, False), (200, 200, True),
           (200, 200, False), (256, 256, True), (40, 136, False)]
_SCHEDULE_CASES = (
    [pytest.param(kern, tq, tk, causal, 64,
                  id=f"{kern}-{tq}-{tk}-{causal}")
     for tq, tk, causal in _RAGGED for kern in ("fwd", "dq", "dkv")]
    + [pytest.param(kern, tq, tk, causal, d,
                    id=f"{kern}-{tq}-{tk}-{causal}-d{d}")
       for d in (32, 256)
       for tq, tk, causal in _RAGGED + ([(66, 66, True), (66, 66, False),
                                         (136, 40, False)]
                                        if d == 256 else [])
       for kern in ("fwd", "dq", "dkv")])


@pytest.mark.parametrize("kernel,tq,tk,causal,d", _SCHEDULE_CASES)
def test_hopper_schedule_matches_plain(kernel, tq, tk, causal, d):
    """The Hopper kernels' block schedules at their tiles for head dim
    ``d`` (fwd and dq: 128-row q tiles split over two 64-row warpgroups,
    over 128-row k blocks, or 64-row ones at D 32 and at D 256's
    forward; dq at D 256: 64-row q tiles over 64-row k blocks with the
    columns split; dk/dv: 128-row k blocks over 64-row q blocks, 32-row
    ones at D 32, or at D 256 64-row k blocks with the columns split)
    against the plain versions, float32, at ragged T."""
    rng = np.random.RandomState(tq + tk + causal + d)
    bh = 2
    q, k, v = (torch.tensor(rng.randn(bh, t, d).astype(np.float32))
               for t in (tq, tk, tk))
    scale = d ** -0.5
    qs = fa._prescale(q, scale)
    o, lse = fa.flash_fwd_ref(q, k, v, scale, causal)
    fwd_tiles, dq_tiles, dkv_tiles = _TILES.get(d, _TILES[64])
    if kernel == "fwd":
        got, want = _fwd_schedule(qs, k, v, causal, *fwd_tiles), (o, lse)
    else:
        do = torch.tensor(rng.randn(bh, tq, d).astype(np.float32))
        delta = (do * o).sum(-1) - torch.tensor(
            rng.randn(bh, tq).astype(np.float32))
    if kernel == "dq":
        got = (_dq_schedule(qs, k, v, do, lse, delta, scale, causal,
                            *dq_tiles),)
        want = (fa.flash_dq_ref(q, k, v, do, lse, delta, scale, causal),)
    elif kernel == "dkv":
        got = _dkv_schedule(qs, k, v, do, lse, delta, causal, *dkv_tiles)
        want = fa.flash_dkv_ref(q, k, v, do, lse, delta, scale, causal)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=2e-5,
                                   rtol=1e-4)
