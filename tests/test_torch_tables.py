"""The port's ArrayTable against the JAX package's, value for value.

Each scenario runs the same seeded numpy inputs through
``multiverso_tpu`` (its 8-device CPU mesh) and ``multiverso_tpu_torch``
(``device="cpu"``) and compares what the tables hold, at atol = rtol =
1e-6: both sides run the same float32 formulas.  The cases follow the
ArrayTable cases of ``test_tables.py`` and the table cases of
``test_quantization.py``: every updater, stacked worker deltas, BSP with
AddOptions, SSP, the device-resident add/get, the 1-bit add, concurrent
adds, ``close``, duplicate names, and snapshots crossing packages.
"""

import threading
from functools import partial
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

TOL = 1e-6
UPDATERS = ["default", "sgd", "adagrad", "momentum", "smooth_gradient",
            "assign"]


@pytest.fixture()
def tmv():
    """Fresh multiverso_tpu_torch runtime per test."""
    import multiverso_tpu_torch as tmv

    def clean():
        if tmv.initialized():
            tmv.shutdown()
        tmv.config.reset()
        tmv.fault.reset()

    clean()
    yield tmv
    clean()


def _sides(mv, tmv):
    """The JAX package and the port, each with a CPU init and a way to
    make a device array."""
    return [SimpleNamespace(name="jax", m=mv, init=mv.init,
                            dev=jnp.asarray),
            SimpleNamespace(name="torch", m=tmv,
                            init=partial(tmv.init, device="cpu"),
                            dev=torch.as_tensor)]


@pytest.fixture(params=["jax", "torch"])
def pkg(request, mv, tmv):
    """One package per case, for checks that differ only by package."""
    request.addfinalizer(mv.fault.reset)
    return {s.name: s for s in _sides(mv, tmv)}[request.param]


def _close(got, want):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _close(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _close(g, w)
    elif isinstance(want, (str, int)) and not isinstance(want, bool):
        assert got == want
    else:
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=TOL, atol=TOL)


def _parity(mv, tmv, scenario):
    """Run ``scenario(side)`` on both packages; assert equal results."""
    out = {}
    for side in _sides(mv, tmv):
        out[side.name] = scenario(side)
        side.m.shutdown()
    _close(out["torch"], out["jax"])
    return out["torch"]


def _rand(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


# --------------------------------------------------------------- basics

def test_get_initial_and_init_value(mv, tmv):
    def run(s):
        s.init()
        a = s.m.ArrayTable(10)
        b = s.m.ArrayTable(13, init=np.arange(13, dtype=np.float32))
        return [a.get(), b.get(), b.get().shape]

    got = _parity(mv, tmv, run)
    assert got[2] == (13,)


def test_add_get_roundtrip(mv, tmv):
    d = _rand(0, 100)

    def run(s):
        s.init()
        t = s.m.ArrayTable(100)
        t.add(d)
        t.add(d)
        return t.get()

    _close(_parity(mv, tmv, run), 2 * d)


def test_add_stacked_workers(mv, tmv):
    """[k, size] delta = k workers' contributions summed before update."""
    d = _rand(1, 4, 16)

    def run(s):
        s.init(updater_type="sgd")
        t = s.m.ArrayTable(16)
        t.add(d, option=s.m.AddOption(learning_rate=0.5))
        return t.get()

    _close(_parity(mv, tmv, run), -0.5 * d.sum(0))


@pytest.mark.parametrize("name", UPDATERS)
def test_every_updater_three_adds(mv, tmv, name):
    """Each updater through three host adds with its own AddOption, and
    its state slots, against the JAX table."""
    w0 = _rand(2, 37)
    grads = [_rand(3 + i, 37) for i in range(3)]

    def run(s):
        s.init(updater_type=name)
        t = s.m.ArrayTable(37, init=w0)
        opt = s.m.AddOption(learning_rate=0.1, momentum=0.9, rho=0.5)
        for g in grads:
            t.add(g, option=opt)
        snap = t.store_state()
        return [t.get(), snap["state"]]

    _parity(mv, tmv, run)


def test_odd_size_has_no_padding_in_view(mv, tmv):
    d = np.arange(13, dtype=np.float32)

    def run(s):
        s.init()
        t = s.m.ArrayTable(13)
        t.add(d)
        return t.get()

    _close(_parity(mv, tmv, run), d)


def test_int_table(mv, tmv):
    def run(s):
        s.init()
        t = s.m.ArrayTable(6, dtype=np.int32)
        t.add(np.arange(6, dtype=np.int32))
        t.add(np.ones(6, np.int32))
        out = t.get()
        assert out.dtype == np.int32
        return out

    _close(_parity(mv, tmv, run), np.arange(6) + 1)


def test_dtype_forms_agree(tmv):
    tmv.init(device="cpu")
    for dt in (np.float32, "float32", torch.float32):
        t = tmv.ArrayTable(4, dtype=dt)
        assert t.dtype == np.dtype(np.float32)
        assert t.torch_dtype == torch.float32
        assert t.raw_value()[0].dtype == torch.float32
    with pytest.raises(ValueError, match="numpy"):
        tmv.ArrayTable(4, dtype=torch.bfloat16)


def test_get_returns_a_copy(tmv):
    """Mutating what get() returned leaves the table as it was (on a CPU
    tensor ``.numpy()`` would be a view of the table itself; the JAX
    package hands out read-only arrays instead)."""
    tmv.init(device="cpu")
    t = tmv.ArrayTable(8, init=np.ones(8, np.float32))
    got = t.get()
    got[:] = 42.0
    np.testing.assert_allclose(t.get(), 1.0)
    t.get(device=True)[:] = 7.0
    t.store_state()["data"][:] = 3.0
    np.testing.assert_allclose(t.get(), 1.0)


def test_init_and_delta_are_not_aliased(tmv):
    """The table owns its memory: neither the init array nor an assigned
    delta (device or host) stays tied to the caller's buffer."""
    tmv.init(device="cpu", updater_type="assign")
    init = np.zeros(4, np.float32)
    t = tmv.ArrayTable(4, init=init)
    init[:] = 5.0
    np.testing.assert_allclose(t.get(), 0.0)
    d = torch.ones(4)
    t.add(d)
    d[:] = 9.0
    np.testing.assert_allclose(t.get(), 1.0)
    h = np.full(4, 2.0, np.float32)
    t.add(h)
    h[:] = 9.0
    np.testing.assert_allclose(t.get(), 2.0)


def test_out_buffer(pkg):
    pkg.init()
    t = pkg.m.ArrayTable(5, init=np.arange(5, dtype=np.float32))
    buf = np.empty(5, np.float32)
    assert t.get(out=buf) is buf
    np.testing.assert_allclose(buf, np.arange(5))
    with pytest.raises(ValueError, match="host-path"):
        t.get(device=True, out=buf)


def test_delta_shape_error(pkg):
    pkg.init()
    t = pkg.m.ArrayTable(8)
    with pytest.raises(ValueError, match="delta shape"):
        t.add(np.ones(9, np.float32))
    with pytest.raises(ValueError, match="delta shape"):
        t.add(pkg.dev(np.ones(9, np.float32)))


# ------------------------------------------------------------ BSP / SSP

def test_bsp_sync_buffering(mv, tmv):
    """sync=True: adds invisible until the clock boundary (barrier)."""
    def run(s):
        s.init(sync=True)
        t = s.m.ArrayTable(4)
        t.add(np.ones(4, np.float32))
        t.add(np.ones(4, np.float32))
        before = t.get()
        s.m.barrier()
        return [before, t.get()]

    _close(_parity(mv, tmv, run), [np.zeros(4), np.full(4, 2.0)])


def test_bsp_respects_add_options(mv, tmv):
    """A flush applies each buffered option's sum with its own option."""
    g1, g2, g3 = _rand(10, 6), _rand(11, 6), _rand(12, 6)

    def run(s):
        s.init(sync=True, updater_type="adagrad")
        t = s.m.ArrayTable(6, init=np.ones(6, np.float32))
        a = s.m.AddOption(learning_rate=0.5)
        b = s.m.AddOption(learning_rate=2.0)
        t.add(g1, option=a)
        t.add(g2, option=b)
        t.add(g3, option=a)
        s.m.barrier()
        return [t.get(), t.store_state()["state"]]

    _parity(mv, tmv, run)


def test_bsp_borrowed_delta_is_not_written(pkg):
    pkg.init(sync=True)
    t = pkg.m.ArrayTable(4)
    d = np.ones(4, np.float32)
    t.add(d, borrow=True)
    t.add(d, borrow=True)
    np.testing.assert_allclose(d, 1.0)
    pkg.m.barrier()
    np.testing.assert_allclose(t.get(), 2.0)
    with pytest.raises(ValueError, match="dtype"):
        t.add(np.ones(4, np.float64), borrow=True)
    with pytest.raises(TypeError, match="ndarray"):
        t.add([1.0] * 4, borrow=True)


@pytest.mark.parametrize("staleness,visible", [
    (0, [0.0, 1.0, 1.0]), (1, [0.0, 0.0, 1.0]), (2, [0.0, 0.0, 0.0])])
def test_ssp_defers_by_staleness(mv, tmv, staleness, visible):
    """staleness=s: a clock's adds land s barriers after their own."""
    def run(s):
        s.init()
        t = s.m.ArrayTable(4, sync=True, staleness=staleness, name="ssp",
                           updater_type="default")
        t.add(np.ones(4, np.float32))
        seen = [t.get()[0]]
        s.m.barrier()
        seen.append(t.get()[0])
        s.m.barrier()
        seen.append(t.get()[0])
        return seen

    _close(_parity(mv, tmv, run), visible)


def test_ssp_idle_clock_releases_backlog(mv, tmv):
    def run(s):
        s.init()
        t = s.m.ArrayTable(2, sync=True, staleness=2, name="ssp_idle",
                           updater_type="default")
        t.add(np.ones(2, np.float32))
        s.m.barrier()
        s.m.barrier()
        held = t.get()
        s.m.barrier()        # idle clock: matures and applies
        return [held, t.get()]

    _close(_parity(mv, tmv, run), [np.zeros(2), np.ones(2)])


def test_ssp_requires_sync(pkg):
    pkg.init()
    with pytest.raises(ValueError, match="sync=True"):
        pkg.m.ArrayTable(4, sync=False, staleness=1, name="ssp_bad")
    with pytest.raises(ValueError, match=">= 0"):
        pkg.m.ArrayTable(4, sync=True, staleness=-1, name="ssp_bad2")


def test_ssp_discard_pending_drops_queue(mv, tmv):
    def run(s):
        s.init()
        t = s.m.ArrayTable(2, sync=True, staleness=1, name="ssp_disc",
                           updater_type="default")
        t.add(np.ones(2, np.float32))
        s.m.barrier()
        t.discard_pending()
        s.m.barrier()
        return t.get()

    _close(_parity(mv, tmv, run), np.zeros(2))


# --------------------------------------------------- device-resident path

def test_device_add_and_get(mv, tmv):
    d = _rand(20, 100)

    def run(s):
        s.init()
        t = s.m.ArrayTable(100)
        t.add(s.dev(d))
        t.add(d)
        dev = t.get(device=True)
        assert tuple(dev.shape) == (100,)
        before = np.array(dev)
        t.add(d)                          # the snapshot must not move
        return [t.get(), before, np.array(dev)]

    _close(_parity(mv, tmv, run), [3 * d, 2 * d, 2 * d])


@pytest.mark.parametrize("name", ["sgd", "adagrad", "momentum"])
def test_device_add_respects_updater(mv, tmv, name):
    g = _rand(21, 8)

    def run(s):
        s.init(updater_type=name)
        t = s.m.ArrayTable(8, init=np.ones(8, np.float32))
        opt = s.m.AddOption(learning_rate=0.5)
        t.add(s.dev(g), option=opt, sync=True)
        t.add(s.dev(g), option=opt)
        return [t.get(), t.store_state()["state"]]

    _parity(mv, tmv, run)


def test_device_add_stacked(mv, tmv):
    d = _rand(22, 4, 16)

    def run(s):
        s.init()
        t = s.m.ArrayTable(16)
        t.add(s.dev(d))
        return t.get()

    _close(_parity(mv, tmv, run), d.sum(0))


def test_device_add_bsp_falls_back(mv, tmv):
    """sync=True tables buffer device deltas like host ones."""
    def run(s):
        s.init()
        t = s.m.ArrayTable(8, sync=True)
        t.add(s.dev(np.ones(8, np.float32)))
        before = t.get()
        s.m.barrier()
        return [before, t.get()]

    _close(_parity(mv, tmv, run), [np.zeros(8), np.ones(8)])


def test_fused_raw_value_roundtrip(tmv):
    tmv.init(device="cpu", updater_type="sgd")
    t = tmv.ArrayTable(6, init=np.ones(6, np.float32))
    data, state = t.raw_value()
    assert isinstance(data, torch.Tensor) and state == ()
    data, state = t.updater.apply_dense(data, state, torch.ones(6),
                                        t.default_option)
    t.raw_assign(data, state)
    np.testing.assert_allclose(t.get(), 0.9)
    assert t.sharding == torch.device("cpu")


# ------------------------------------------------------------- 1-bit add

def test_compressed_add_decodes_bit_for_bit(mv, tmv):
    """One 1-bit add from zeros under the default updater lands exactly
    the decoded payload: the same on both packages, bit for bit, and
    equal to the quantizer's own dequantize_1bit (an MSB/LSB slip in the
    device unpack would flip signs inside every byte)."""
    from multiverso_tpu_torch.util.quantization import (dequantize_1bit,
                                                        quantize_1bit)

    d = _rand(30, 1003)
    out = {}
    for s in _sides(mv, tmv):
        s.init()
        t = s.m.ArrayTable(1003, name="q_bits")
        t.add(d, compress="1bit")
        out[s.name] = t.get()
        s.m.shutdown()
    packed, p, m, _ = quantize_1bit(d)
    want = dequantize_1bit(packed, p, m, d.size)
    np.testing.assert_array_equal(out["torch"], out["jax"])
    np.testing.assert_array_equal(out["torch"], want)
    np.testing.assert_array_equal(out["torch"] >= 0, d >= 0)


def test_compressed_add_converges(mv, tmv):
    """Gradient descent through compress='1bit' adds reaches the optimum
    of a quadratic on both packages, along the same path.  The two
    packages round ``w - lr·d`` a float32 ulp apart now and then (XLA
    may fuse the multiply-add), and the sign quantizer carries such
    ulps on, so the paths are held together over the first 20 steps
    (where they stay within 3e-7) and each end to the optimum."""
    target = np.linspace(-1, 1, 32).astype(np.float32)
    paths = {}
    for s in _sides(mv, tmv):
        s.init(updater_type="sgd")
        t = s.m.ArrayTable(32, name="q_lr")
        opt = s.m.AddOption(learning_rate=0.3)
        path = []
        for _ in range(80):
            w = t.get()
            path.append(w)
            t.add(w - target, option=opt, compress="1bit")
        paths[s.name] = path + [t.get()]
        s.m.shutdown()
    _close(paths["torch"][:20], paths["jax"][:20])
    for path in paths.values():
        np.testing.assert_allclose(path[-1], target, atol=0.05)


def test_wire_codec_flag_defaults_to_1bit(mv, tmv):
    d = _rand(31, 16)

    def run(s):
        s.init(args=["-wire_codec=1bit"])
        t = s.m.ArrayTable(16, name="q_flag")
        t.add(d)
        assert t._compressor is not None
        return t.get()

    _parity(mv, tmv, run)


def test_compress_rejects_bsp_unknown_and_int(pkg):
    pkg.init()
    m = pkg.m
    t = m.ArrayTable(8, name="q_err")
    with pytest.raises(ValueError, match="unknown compress"):
        t.add(np.ones(8, np.float32), compress="2bit")
    ts = m.ArrayTable(8, name="q_bsp", sync=True)
    with pytest.raises(ValueError, match="BSP"):
        ts.add(np.ones(8, np.float32), compress="1bit")
    ti = m.ArrayTable(8, dtype=np.int32, name="q_int")
    with pytest.raises(ValueError, match="floating"):
        ti.add(np.ones(8, np.int32), compress="1bit")


def test_compressor_residual_resets_on_restore(pkg):
    pkg.init()
    t = pkg.m.ArrayTable(8, name="q_ck")
    snap = t.store_state()
    t.add(np.full(8, 0.7, np.float32), compress="1bit")
    assert t._compressor._residual is not None
    t.load_state(snap)
    assert t._compressor._residual is None


# --------------------------------------------------------- concurrency etc.

def test_concurrent_adds_threadsafe(mv, tmv):
    """Concurrent eager adds must not lose updates or crash."""
    d = np.ones(16, np.float32)

    def run(s):
        s.init()
        t = s.m.ArrayTable(16)

        def work():
            for _ in range(10):
                t.add(d)

        threads = [threading.Thread(target=work) for _ in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
        return t.get()

    _close(_parity(mv, tmv, run), np.full(16, 40.0))


def test_close_releases_name_and_refuses_ops(pkg):
    pkg.init(sync=True)
    m = pkg.m
    t = m.ArrayTable(4, name="scratch")
    t.add(np.ones(4, np.float32))
    t.close()
    assert t not in m.get_context().tables()
    with pytest.raises(RuntimeError, match="closed"):
        t.get()
    with pytest.raises(RuntimeError, match="closed"):
        t.add(np.ones(4, np.float32))
    m.barrier()                        # the discarded add never flushes
    again = m.ArrayTable(4, name="scratch")
    np.testing.assert_allclose(again.get(), 0.0)


def test_duplicate_names_rejected(pkg):
    pkg.init()
    m = pkg.m
    m.ArrayTable(4, name="dup")
    with pytest.raises(ValueError, match="duplicate table name"):
        m.ArrayTable(4, name="dup")
    assert len(m.get_context().tables()) == 1


def test_table_fault_seam(pkg):
    """The chaos seam scripts a failed Add exactly where a transport
    error would surface; the next add lands."""
    pkg.init()
    m = pkg.m
    t = m.ArrayTable(4)
    m.fault.configure(seed=1, sites={"table.Add": {"times": 1}})
    with pytest.raises(m.fault.FaultError, match="table.Add"):
        t.add(np.ones(4, np.float32))
    t.add(np.ones(4, np.float32))
    np.testing.assert_allclose(t.get(), 1.0)


def test_serve_cache_and_workload(mv, tmv):
    """With the serve cache armed, repeat gets hit and adds invalidate;
    the workload tracker counts the same traffic on both packages."""
    d = _rand(40, 8)

    def run(s):
        s.init(args=["-serve_cache_entries=8"])
        t = s.m.ArrayTable(8, name="served")
        first = t.get()
        t.add(d)
        second = t.get()
        second[:] = 0.0                 # a caller's copy, not the cache
        rep = t.workload_report()
        return [first, t.get(), rep["armed"], rep["gets"], rep["adds"]]

    got = _parity(mv, tmv, run)
    _close(got[1], d)


# ------------------------------------------------------------- snapshots

@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_snapshot_crosses_packages(mv, tmv, direction):
    """A snapshot of either package loads into the other, and training
    goes on identically from it."""
    g1, g2 = _rand(50, 12), _rand(51, 12)
    sides = {s.name: s for s in _sides(mv, tmv)}
    src, dst = (("jax", "torch") if direction == "jax_to_torch"
                else ("torch", "jax"))

    def trained(s, snap=None):
        s.init(updater_type="adagrad")
        t = s.m.ArrayTable(12, name="ck", init=np.ones(12, np.float32))
        if snap is None:
            t.add(g1)
        else:
            t.load_state(snap)
        return t

    a = trained(sides[src])
    snap = a.store_state()
    a.add(g2)
    want = [a.get(), a.store_state()["state"]]
    sides[src].m.shutdown()
    b = trained(sides[dst], snap)
    _close(b.store_state()["data"], snap["data"])
    b.add(g2)
    _close([b.get(), b.store_state()["state"]], want)
    sides[dst].m.shutdown()


def test_checkpoint_roundtrip(mv, tmv):
    def run(s):
        s.init(updater_type="adagrad")
        t = s.m.ArrayTable(8)
        t.add(np.ones(8, np.float32))
        snap = t.store_state()
        t.add(np.ones(8, np.float32))
        t.load_state(snap)
        t2 = s.m.ArrayTable(8, updater_type="adagrad")
        t2.add(np.ones(8, np.float32))
        return [t.get(), t2.get(), snap["kind"], snap["size"]]

    got = _parity(mv, tmv, run)
    _close(got[0], got[1])


def test_load_state_rejects_a_mismatch(tmv):
    tmv.init(device="cpu")
    t = tmv.ArrayTable(8)
    snap = t.store_state()
    with pytest.raises(ValueError, match="size 8"):
        tmv.ArrayTable(9).load_state(snap)
