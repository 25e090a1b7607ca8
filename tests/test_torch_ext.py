"""The port's ``ext`` managers against the JAX package's.

Each case of ``test_ext.py`` runs on both packages from the same seeded
inputs (the JAX package on its CPU mesh, the port with
``device="cpu"``), and the results agree within rtol 1e-6; the 1-bit
cases exactly, since the port's quantizer is a copy.  What only the port
has to show: the uncompressed sync makes no host copy, a module on
another device than the table raises, and the managers' values are
tensors on the table's device.
"""

import numpy as np
import pytest
import torch

RTOL = 1e-6


@pytest.fixture()
def tmv():
    import multiverso_tpu_torch as tmv

    def clean():
        if tmv.initialized():
            tmv.shutdown()
        tmv.config.reset()

    clean()
    yield tmv
    clean()


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _both(mv, tmv, fn, **init):
    """``fn(m, ext)`` under each package's runtime: (jax, torch) results
    as numpy."""
    import multiverso_tpu.ext.jax_ext as jext
    import multiverso_tpu_torch.ext.shared as text

    mv.init(**init)
    want = fn(mv, jext)
    mv.shutdown()
    tmv.init(device="cpu", **init)
    got = fn(tmv, text)
    tmv.shutdown()
    return want, got


def _close(got, want, exact=False):
    for g, w in zip(got, want):
        if exact:
            np.testing.assert_array_equal(_np(g), _np(w))
        else:
            np.testing.assert_allclose(_np(g), _np(w), rtol=RTOL)


def test_mv_shared_delta_sync(mv, tmv):
    def run(m, ext):
        v = ext.mv_shared(np.zeros((2, 3), np.float32), average=False)
        v.set_value(v.get_value() + 1.0)
        return v.mv_sync(), v.mv_sync()

    want, got = _both(mv, tmv, run)
    _close(got, want)
    np.testing.assert_allclose(_np(got[1]), 1.0)
    assert isinstance(got[0], torch.Tensor) and got[0].shape == (2, 3)


def test_mv_shared_two_workers_average(mv, tmv):
    def run(m, ext):
        v = ext.mv_shared(np.zeros(4, np.float32), average=False)
        v.table.add(np.ones(4, np.float32))     # the other worker's push
        v.set_value(v.get_value() + 1.0)
        return (v.mv_sync(),)

    want, got = _both(mv, tmv, run)
    _close(got, want)
    np.testing.assert_allclose(_np(got[0]), 2.0)


def test_sync_all_mv_shared_vars(mv, tmv):
    def run(m, ext):
        a = ext.mv_shared(np.zeros(2, np.float32), average=False)
        b = ext.mv_shared(np.ones(2, np.float32), average=False)
        a.set_value(np.full(2, 3.0))
        ext.sync_all_mv_shared_vars()
        return a.get_value(), b.get_value()

    want, got = _both(mv, tmv, run)
    _close(got, want)


def test_sync_all_prunes_the_variables_of_a_dead_context(tmv):
    from multiverso_tpu_torch.ext.shared import (_ALL_SHARED, mv_shared,
                                                 sync_all_mv_shared_vars)

    tmv.init(device="cpu")
    old = mv_shared(np.zeros(2, np.float32))
    tmv.shutdown()
    tmv.init(device="cpu")
    new = mv_shared(np.ones(2, np.float32), average=False)
    new.set_value(np.full(2, 5.0))
    sync_all_mv_shared_vars()
    assert old not in _ALL_SHARED and new in _ALL_SHARED
    np.testing.assert_array_equal(_np(new.get_value()), 5.0)


def test_shared_param_manager_tree(mv, tmv):
    rng = np.random.RandomState(0)
    w0 = rng.randn(3, 2).astype(np.float32)
    step = rng.randn(3, 2).astype(np.float32)

    def run(m, ext):
        # Keys out of sorted order: both packages lay leaves out sorted.
        params = {"w": w0, "b": np.zeros(2, np.float32)}
        mgr = ext.SharedParamManager(params, average=False)
        merged = mgr.sync({"w": params["w"] + step, "b": params["b"] - 1.0})
        return merged["w"], merged["b"], mgr.table.get()

    want, got = _both(mv, tmv, run)
    _close(got, want)
    assert tuple(got[0].shape) == (3, 2)


def test_shared_param_manager_returns_leaves_the_caller_may_update(tmv):
    from multiverso_tpu_torch.ext import SharedParamManager

    tmv.init(device="cpu")
    mgr = SharedParamManager([torch.ones(3), (torch.zeros(2),)],
                             average=False)
    merged = mgr.sync([torch.full((3,), 2.0), (torch.zeros(2),)])
    assert isinstance(merged, list) and isinstance(merged[1], tuple)
    merged[0].add_(10.0)                 # a caller's in-place update
    again = mgr.sync(merged)
    np.testing.assert_array_equal(_np(again[0]), 12.0)


def test_mv_shared_compressed_sync_converges(mv, tmv):
    target = np.linspace(-1, 1, 32).astype(np.float32)

    def run(m, ext):
        sv = ext.mv_shared(np.zeros(32, np.float32), name="ext_q")
        v = np.zeros(32, np.float32)
        trail = []
        for _ in range(60):
            v = v + 0.2 * (target - v)          # local training drift
            sv.set_value(v)
            v = _np(sv.mv_sync(compress="1bit"))
            trail.append(v)
        return trail

    want, got = _both(mv, tmv, run)
    _close(got, want, exact=True)
    np.testing.assert_allclose(got[-1], target, atol=0.05)


def test_shared_param_manager_compressed_sync(mv, tmv):
    def run(m, ext):
        params = {"w": np.ones((4, 4), np.float32),
                  "b": np.zeros(4, np.float32)}
        mgr = ext.SharedParamManager(params, name="ext_qm")
        rng = np.random.RandomState(3)
        out = []
        for _ in range(3):
            params = {k: np.asarray(_np(params[k])) + rng.randn(
                *np.shape(params[k])).astype(np.float32)
                for k in sorted(params)}
            params = mgr.sync(params, compress="1bit")
            out += [params["w"], params["b"]]
        return out

    want, got = _both(mv, tmv, run)
    _close(got, want, exact=True)


def test_delta_sync_pins_asp_under_bsp_runtime(mv, tmv):
    def run(m, ext):
        v = ext.mv_shared(np.zeros(4, np.float32), average=False)
        v.set_value(np.full(4, 2.0, np.float32))
        return (v.mv_sync(),)                 # visible before a barrier

    want, got = _both(mv, tmv, run, sync=True)
    _close(got, want)
    np.testing.assert_allclose(_np(got[0]), 2.0)


def _net(seed, sizes=(4, 3, 2)):
    torch.manual_seed(seed)
    layers = []
    for a, b in zip(sizes[:-1], sizes[1:]):
        layers += [torch.nn.Linear(a, b), torch.nn.ReLU()]
    return torch.nn.Sequential(*layers[:-1])


def _params(net):
    return [p.detach().cpu().numpy().copy() for p in net.parameters()]


def _torch_mgr(m):
    if m.__name__ == "multiverso_tpu":
        from multiverso_tpu.ext.torch_ext import TorchParamManager
    else:
        from multiverso_tpu_torch.ext.torch_ext import TorchParamManager
    return TorchParamManager


def test_torch_param_manager_sync(mv, tmv):
    def run(m, ext):
        net = _net(0)
        mgr = _torch_mgr(m)(net, average=False)
        with torch.no_grad():
            for i, p in enumerate(net.parameters()):
                p.add_(1.0 + i)
        mgr.sync_all_param()
        return _params(net) + [mgr.table.get()]

    want, got = _both(mv, tmv, run)
    _close(got, want)


def test_torch_param_manager_compressed_sync(mv, tmv):
    def run(m, ext):
        net = _net(1)
        mgr = _torch_mgr(m)(net, average=False, name="tq")
        rng = np.random.RandomState(5)
        out = []
        for _ in range(3):
            with torch.no_grad():
                for p in net.parameters():
                    p.add_(torch.from_numpy(
                        rng.randn(*p.shape).astype(np.float32)))
            mgr.sync_all_param(compress="1bit")
            out += _params(net)
        return out

    want, got = _both(mv, tmv, run)
    _close(got, want, exact=True)


def test_torch_data_parallel_training_converges(mv, tmv):
    """test_ext.py's two-worker MLP: both packages train the same shards
    through one table, and every parameter agrees."""
    rng = np.random.RandomState(0)
    x = rng.randn(256, 8).astype(np.float32)
    y = (x @ rng.randn(8, 2).astype(np.float32)).argmax(1)

    def run(m, ext):
        TorchParamManager = _torch_mgr(m)
        nets = [_net(1, (8, 16, 2)), _net(1, (8, 16, 2))]
        mgrs = [TorchParamManager(n, name=f"net{i}")
                for i, n in enumerate(nets)]
        mgrs[1].table = mgrs[0].table
        loss_fn = torch.nn.CrossEntropyLoss()
        opts = [torch.optim.SGD(n.parameters(), lr=0.1) for n in nets]
        xt, yt = torch.from_numpy(x), torch.from_numpy(y)
        first = None
        for _ in range(40):
            for wid in (0, 1):
                opts[wid].zero_grad()
                loss = loss_fn(nets[wid](xt[wid::2]), yt[wid::2])
                loss.backward()
                opts[wid].step()
                first = float(loss) if first is None else first
            for mg in mgrs:
                mg.sync_all_param()
        for mg in mgrs:
            mg.sync_all_param()
        last = float(loss_fn(nets[0](xt), yt))
        return _params(nets[0]) + _params(nets[1]) + [first, last]

    want, got = _both(mv, tmv, run)
    _close(got, want)
    assert got[-1] < got[-2] * 0.6


def test_torch_param_manager_shared_table_shape_check(tmv):
    from multiverso_tpu_torch.ext.torch_ext import TorchParamManager

    tmv.init(device="cpu")
    a = TorchParamManager(torch.nn.Linear(4, 2), name="shape_a")
    with pytest.raises(ValueError, match="shared table"):
        TorchParamManager(torch.nn.Linear(8, 2), table=a.table)


def test_shared_table_adopts_the_tables_weights(tmv):
    from multiverso_tpu_torch.ext.torch_ext import TorchParamManager

    tmv.init(device="cpu")
    a = TorchParamManager(_net(0), name="adopt")
    b_net = _net(7)
    TorchParamManager(b_net, table=a.table)
    np.testing.assert_array_equal(np.concatenate(
        [p.ravel() for p in _params(b_net)]), a.table.get())


def test_module_on_another_device_raises(tmv):
    from multiverso_tpu_torch.ext.torch_ext import TorchParamManager

    tmv.init(device="cpu")
    with pytest.raises(ValueError, match="table's device"):
        TorchParamManager(torch.nn.Linear(4, 2, device="meta"))
    a = TorchParamManager(torch.nn.Linear(4, 2), name="dev_a")
    with pytest.raises(ValueError, match="table's device"):
        TorchParamManager(torch.nn.Linear(4, 2, device="meta"),
                          table=a.table)


def test_uncompressed_sync_makes_no_host_copy(tmv, monkeypatch):
    """Every way a tensor reaches the host raises during the sync: the
    push, the pull and the write-back stay tensors on the device."""
    from multiverso_tpu_torch.ext.shared import SharedParamManager, mv_shared
    from multiverso_tpu_torch.ext.torch_ext import TorchParamManager

    tmv.init(device="cpu")
    net = _net(0)
    mgr = TorchParamManager(net, average=False, name="nohost")
    sv = mv_shared(np.zeros(3, np.float32), name="nohost_sv")
    tree = SharedParamManager({"a": torch.ones(2)}, name="nohost_tree")
    with torch.no_grad():
        for p in net.parameters():
            p.add_(1.0)
    want = np.concatenate([p.ravel() for p in _params(net)])

    def host(*_a, **_k):
        raise AssertionError("the sync copied a tensor to the host")

    for name in ("numpy", "tolist", "item", "__float__", "cpu"):
        monkeypatch.setattr(torch.Tensor, name, host)
    mgr.sync_all_param()
    sv.set_value(torch.full((3,), 2.0))
    sv.mv_sync()
    tree.sync({"a": torch.zeros(2)})
    monkeypatch.undo()
    np.testing.assert_array_equal(mgr.table.get(), want)
    np.testing.assert_array_equal(_np(sv.get_value()), 2.0)


def test_managers_default_to_the_card(tmv, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tmv.init()
