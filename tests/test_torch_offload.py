"""The port's state offload (``multiverso_tpu_torch/parallel/offload.py``
and ``TransformerTrainer.offload_state``) against the in-memory trainer
and the JAX package's offloaded trainer, on the CPU.

Both stores keep float32 bits verbatim: the local one and the native
runtime's ``assign`` table (the port's own library, one runtime at a
time in this process).  So the offloaded trainer must equal the
in-memory one bit for bit (losses, parameters and state), across
``save``/``restore`` too, and the native arm the local one; against the
JAX package's offloaded trainer (``backend="local"``) the tolerance is
the trainer tests' rtol 1e-5 with a floor at 1e-5 of each tensor's
largest entry.  A runtime whose updater does not assign fails the
bridge's ``init`` probe.  Several processes raise, naming their
ROADMAP.md item.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ranks as R
from multiverso_tpu.models import transformer as jt
from multiverso_tpu_torch import metrics, native as nat, tracing
from multiverso_tpu_torch.models import transformer as pt
from multiverso_tpu_torch.parallel.offload import OffloadedState, _LocalStore

# tests/test_host_bridge.py's trainer config.
CFG = dict(vocab_size=64, dim=32, n_layers=2, n_heads=2, hidden=64,
           max_seq=32)


def _tokens():
    return np.random.RandomState(0).randint(64, size=(4, 16)).astype(
        np.int32)


def _trainer(**kw):
    cfg = pt.TransformerConfig(**{**CFG, **kw}, compute_dtype=torch.float32)
    return pt.TransformerTrainer(cfg, device="cpu", updater_type="momentum",
                                 seed=1)


def _offloaded(rt=None, **kw):
    tr = _trainer(**kw)
    bridge = (OffloadedState(rt, tr.offload_size()) if rt is not None else
              OffloadedState(None, tr.offload_size(), backend="local"))
    tr.offload_state(bridge)
    return tr, bridge


@pytest.fixture()
def rt():
    """The port's native runtime under the offload store's updater."""
    r = nat.NativeRuntime(args=["-updater_type=assign", "-log_level=error"])
    yield r
    r.shutdown()


def _bits(x):
    return np.asarray(x, np.float32).tobytes()


def _same_trainers(a, b, a_state=None, b_state=None):
    """Parameters and state of two trainers, bit for bit (a state given
    explicitly stands for an offloaded trainer's)."""
    for p, q in zip(pt._leaves(a.params), pt._leaves(b.params)):
        assert _bits(p) == _bits(q)
    for s, t in zip(a_state or a.state, b_state or b.state):
        for x, y in zip(s, t):
            assert _bits(x) == _bits(y)


def _bridge_state(tr):
    return tr._flat_to_state(tr._offload.wait())


def test_local_store_round_trips_bit_for_bit():
    """The double-buffered protocol (wait, compute, push, prefetch) over
    five steps, subnormal-adjacent and negative-zero entries included:
    the last vector equals the same arithmetic on the host, bit for bit
    (the JAX package's ``test_offloaded_state_bit_exact_native``)."""
    off = OffloadedState(None, 333, backend="local")
    v = np.random.RandomState(5).randn(333).astype(np.float32)
    v[0], v[1] = np.float32(1e-38), np.float32(-0.0)
    off.init(v)
    ref = v.copy()
    pushes = metrics.counter("bridge.push").value
    tracing.enable()
    try:
        for i in range(5):
            s = off.wait()
            new = (s * np.float32(0.99) + np.float32(i * 0.1)).astype(
                np.float32)
            off.push(new)
            off.prefetch()
            ref = (ref * np.float32(0.99) + np.float32(i * 0.1)).astype(
                np.float32)
        names = [e.name for e in tracing.events()]
    finally:
        tracing.disable()
        tracing.clear()
    assert off.wait().tobytes() == ref.tobytes()
    assert metrics.counter("bridge.push").value == pushes + 5
    assert names.count("bridge::push") == 5
    assert names.count("bridge::wait") == 5
    off.close()


def test_init_probe_rejects_a_store_that_adds():
    """``init`` seeds the store twice and reads it back: a store that
    accumulates instead of assigning doubles the vector and is refused."""
    class Adding(_LocalStore):
        def assign(self, vec):
            self._data += vec

    off = OffloadedState(None, 64, backend="local")
    off._store = Adding(64)
    with pytest.raises(RuntimeError, match="not bit-exact"):
        off.init(np.arange(64, dtype=np.float32))
    good = OffloadedState(None, 64, backend="local")
    good.init(np.arange(64, dtype=np.float32))
    with pytest.raises(ValueError, match="expected 64"):
        good.init(np.zeros(63, np.float32))


def test_offloaded_trainer_equals_in_memory_bit_for_bit():
    """Three momentum steps offloaded against three in memory: losses,
    parameters and state bit for bit; between steps the offloaded
    trainer holds no state."""
    base = _trainer()
    mem = [float(base.train_step_async(_tokens())) for _ in range(3)]
    tr, _ = _offloaded()
    off = [float(tr.train_step_async(_tokens())) for _ in range(3)]
    assert [_bits(x) for x in mem] == [_bits(x) for x in off]
    assert all(s is None for sl in tr.state for s in sl)
    _same_trainers(tr, base, a_state=_bridge_state(tr))


def test_offloaded_trainer_across_save_and_restore(tmp_path):
    """An offloaded trainer's snapshot (the state fetched from the
    bridge) equals the in-memory trainer's; restored into an offloaded
    and an in-memory trainer it continues bit for bit with the original
    in-memory run."""
    base = _trainer()
    tr, _ = _offloaded()
    for _ in range(2):
        assert tr.train_step(_tokens()) == base.train_step(_tokens())
    snap_off, snap_mem = str(tmp_path / "off.tree"), str(tmp_path / "m.tree")
    tr.save(snap_off)
    base.save(snap_mem)
    with open(snap_off, "rb") as f, open(snap_mem, "rb") as g:
        assert f.read() == g.read()
    want = [float(base.train_step_async(_tokens())) for _ in range(2)]
    again, _ = _offloaded()
    again.restore(snap_off)
    mem = _trainer()
    mem.restore(snap_off)
    for t in (again, mem):
        got = [float(t.train_step_async(_tokens())) for _ in range(2)]
        assert [_bits(x) for x in got] == [_bits(x) for x in want]
    _same_trainers(again, base, a_state=_bridge_state(again))
    _same_trainers(mem, base)


def test_offloaded_trainer_matches_jax_offloaded_trainer():
    """Three momentum steps of the port's offloaded trainer against the
    JAX package's offloaded trainer with its local store, from the same
    seed: losses, parameters and state at rtol 1e-5."""
    from multiverso_tpu.parallel.offload import \
        OffloadedState as JOffloadedState

    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:1]), ("dp",))
    jtr = jt.TransformerTrainer(
        jt.TransformerConfig(**CFG, compute_dtype=jnp.float32), mesh,
        updater_type="momentum", seed=1)
    jtr.offload_state(JOffloadedState(None, jtr.offload_size(),
                                      backend="local"))
    jl = [float(jtr.train_step_async(_tokens())) for _ in range(3)]
    tr, _ = _offloaded()
    assert tr.offload_size() == jtr.offload_size()
    pl = [float(tr.train_step_async(_tokens())) for _ in range(3)]
    np.testing.assert_allclose(pl, jl, rtol=1e-5)
    jstate = jtr._flat_to_state(jtr._offload.wait())
    pairs = list(zip(pt._leaves(tr.params), pt._leaves(jtr.params)))
    pairs += [(a, b) for sa, sb in zip(_bridge_state(tr),
                                       pt._leaves(jstate))
              for a, b in zip(sa, sb)]
    for got, want in pairs:
        want = np.asarray(want)
        floor = 1e-5 * float(np.max(np.abs(want)))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=floor)


def test_native_store_round_trips_bit_for_bit(rt):
    """The JAX package's ``test_offloaded_state_bit_exact_native`` on the
    port's runtime: the protocol over five steps through the arena's
    buffers, borrowed async pushes and async prefetches; ``close`` hands
    the four buffers back to the arena."""
    off = OffloadedState(rt, 333)
    assert all(rt.arena().owns(b) for b in off._get_bufs + off._push_bufs)
    v = np.random.RandomState(5).randn(333).astype(np.float32)
    v[0], v[1] = np.float32(1e-38), np.float32(-0.0)
    off.init(v)
    ref = v.copy()
    for i in range(5):
        s = off.wait()
        new = (s * np.float32(0.99) + np.float32(i * 0.1)).astype(
            np.float32)
        off.push(new)
        off.prefetch()
        ref = (ref * np.float32(0.99) + np.float32(i * 0.1)).astype(
            np.float32)
    assert off.wait().tobytes() == ref.tobytes()
    free = rt.arena().stats()["free_buffers"]
    off.close()
    assert rt.arena().stats()["free_buffers"] == free + 4


@pytest.mark.parametrize("updater", ["default", "sgd"])
def test_native_probe_rejects_a_runtime_that_does_not_assign(updater):
    """A fleet under any other updater accumulates (or steps) the probe's
    second push, and ``init`` refuses it, as in the JAX package."""
    r = nat.NativeRuntime(args=[f"-updater_type={updater}",
                                "-log_level=error"])
    try:
        off = OffloadedState(r, 64)
        with pytest.raises(RuntimeError, match="updater_type=assign"):
            off.init(np.arange(1, 65, dtype=np.float32))
        off.close()
    finally:
        r.shutdown()


def test_native_offloaded_trainer_equals_local_bit_for_bit(rt):
    """Three momentum steps at dim 64 with the state in the native store,
    in the local store and in memory: losses, parameters and state bit
    for bit across all three."""
    base = _trainer(dim=64)
    mem = [float(base.train_step_async(_tokens())) for _ in range(3)]
    runs = {}
    for name, store in (("local", None), ("native", rt)):
        tr, bridge = _offloaded(store, dim=64)
        losses = [float(tr.train_step_async(_tokens())) for _ in range(3)]
        assert [_bits(x) for x in losses] == [_bits(x) for x in mem]
        _same_trainers(tr, base, a_state=_bridge_state(tr))
        runs[name] = tr
        bridge.close()
    assert runs["native"]._offload.backend == "native"


def test_native_offloaded_trainer_matches_jax_offloaded_trainer(rt):
    """The port's trainer offloaded to the native store against the JAX
    package's offloaded trainer (its local store, which its own
    ``test_trainer_offload_bit_exact`` holds bit for bit with its native
    one): losses, parameters and state at rtol 1e-5 after 3 steps."""
    from multiverso_tpu.parallel.offload import \
        OffloadedState as JOffloadedState

    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:1]), ("dp",))
    jtr = jt.TransformerTrainer(
        jt.TransformerConfig(**CFG, compute_dtype=jnp.float32), mesh,
        updater_type="momentum", seed=1)
    jtr.offload_state(JOffloadedState(None, jtr.offload_size(),
                                      backend="local"))
    jl = [float(jtr.train_step_async(_tokens())) for _ in range(3)]
    tr, bridge = _offloaded(rt)
    pl = [float(tr.train_step_async(_tokens())) for _ in range(3)]
    np.testing.assert_allclose(pl, jl, rtol=1e-5)
    jstate = jtr._flat_to_state(jtr._offload.wait())
    pairs = list(zip(pt._leaves(tr.params), pt._leaves(jtr.params)))
    pairs += [(a, b) for sa, sb in zip(_bridge_state(tr),
                                       pt._leaves(jstate))
              for a, b in zip(sa, sb)]
    for got, want in pairs:
        want = np.asarray(want)
        floor = 1e-5 * float(np.max(np.abs(want)))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=floor)
    bridge.close()


def test_offload_refusals():
    """The JAX trainer's refusals: a stateless updater, a bridge of
    another size, the native store without a runtime, the fused
    steps."""
    cfg = pt.TransformerConfig(**CFG, compute_dtype=torch.float32)
    sgd = pt.TransformerTrainer(cfg, device="cpu", updater_type="sgd")
    assert sgd.offload_size() == 0
    with pytest.raises(ValueError, match="keeps no optimizer state"):
        sgd.offload_state(OffloadedState(None, 1, backend="local"))
    tr = _trainer()
    with pytest.raises(ValueError, match="bridge sized 7"):
        tr.offload_state(OffloadedState(None, 7, backend="local"))
    with pytest.raises(ValueError,
                       match="backend='native' needs a NativeRuntime"):
        OffloadedState(None, tr.offload_size())
    with pytest.raises(ValueError, match="unknown backend"):
        OffloadedState(None, 4, backend="disk")
    tr, _ = _offloaded()
    with pytest.raises(RuntimeError, match="incompatible with offload"):
        tr.train_steps_fused(_tokens(), 2)


def test_offload_refused_under_several_processes(tmp_path):
    """Two gloo ranks on a (dp 2) mesh: ``offload_state`` raises, naming
    its ROADMAP.md item."""
    plan = [dict(key="dp2", sizes=[2], names=["dp"],
                 cases=[["offload", "offload_raises", {}]])]
    R.launch(plan, str(tmp_path), 2)
    for r in R.results(str(tmp_path), "offload", 2):
        assert 'ROADMAP.md Queue 1, "Several processes"' in str(r["error"])
