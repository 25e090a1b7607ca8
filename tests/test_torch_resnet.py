"""The port's data-parallel ResNet-20 against the JAX package's.

Both packages build the same ``nn.Module`` and train it with CPU torch in
float32 here, so the data, the initial weights, and every worker's
parameters and the table after two epochs at the reference test's toy
size agree exactly (held within rtol 1e-6, the stated tolerance; found
equal bit for bit).  A JAX app's nets and table carry over to the port
through ``state_dict()`` and the cross-package checkpoint, bit for bit.
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


def _state(net):
    return {k: v.detach().cpu().numpy() for k, v in net.state_dict().items()}


@pytest.mark.parametrize("n,classes,seed", [(64, 10, 0), (256, 4, 3)])
def test_synthetic_cifar_is_the_same_draw(n, classes, seed):
    from multiverso_tpu.apps.resnet import synthetic_cifar as jax_cifar
    from multiverso_tpu_torch.apps.resnet import synthetic_cifar

    for got, want in zip(synthetic_cifar(n, classes, seed),
                         jax_cifar(n, classes, seed)):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("classes", [10, 4])
def test_build_resnet20_same_initial_weights(classes):
    from multiverso_tpu.apps.resnet import build_resnet20 as jax_build
    from multiverso_tpu_torch.apps.resnet import build_resnet20

    torch.manual_seed(11)
    want = _state(jax_build(classes))
    torch.manual_seed(11)
    net = build_resnet20(classes)
    got = _state(net)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    n = sum(p.numel() for p in net.parameters())
    assert n == 272_474 - 65 * (10 - classes)   # the head is 64·C + C


def _pair(mv, tmv, epochs, x, y, **kw):
    from multiverso_tpu.apps.resnet import ResNet20DataParallel as JaxApp
    from multiverso_tpu_torch.apps.resnet import ResNet20DataParallel

    mv.init()
    want = JaxApp(**kw)
    want_losses = [want.train_epoch(x, y, batch_size=64)
                   for _ in range(epochs)]
    tmv.init(device="cpu")
    got = ResNet20DataParallel(device="cpu", **kw)
    got_losses = [got.train_epoch(x, y, batch_size=64)
                  for _ in range(epochs)]
    return want, got, want_losses, got_losses


def test_data_parallel_matches_the_jax_app(mv, tmv):
    """Two epochs at test_ext.py's toy size (256 samples, 4 classes, lr
    0.05, batch 64): every worker's parameters, BatchNorm statistics and
    the table agree with the JAX app's; held-out accuracy > 0.4 (chance
    0.25)."""
    from multiverso_tpu_torch.apps.resnet import synthetic_cifar

    x, y = synthetic_cifar(256, num_classes=4, seed=0)
    want, got, want_losses, got_losses = _pair(
        mv, tmv, 2, x, y, num_workers=2, lr=0.05, num_classes=4)
    np.testing.assert_allclose(got_losses, want_losses, rtol=RTOL)
    for g_net, w_net in zip(got.nets, want.nets):
        g, w = _state(g_net), _state(w_net)
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=RTOL, atol=0)
    np.testing.assert_allclose(got.mgrs[0].table.get(),
                               want.mgrs[0].table.get(), rtol=RTOL, atol=0)
    assert got.mgrs[1].table is got.mgrs[0].table
    acc = got.accuracy(x[:128], y[:128])
    assert acc == want.accuracy(x[:128], y[:128])
    assert acc > 0.4, acc
    assert got.nets[0].training        # accuracy() restores train mode


def test_asp_order_worker_zero_lags_one_push(tmv):
    """After a step worker 1 holds the table; worker 0 holds it as it
    was before worker 1's push, as in the JAX app."""
    from multiverso_tpu_torch.apps.resnet import (ResNet20DataParallel,
                                                  synthetic_cifar)

    tmv.init(device="cpu")
    x, y = synthetic_cifar(64, num_classes=4, seed=1)
    app = ResNet20DataParallel(lr=0.05, num_classes=4, device="cpu")
    xb, yb = app.place(x, y)
    app.local_steps(xb, yb)
    m0, m1 = app.mgrs
    m0.sync_all_param()
    after0 = m0.table.get()
    m1.sync_all_param()
    table = m0.table.get()
    np.testing.assert_array_equal(m0._flatten().numpy(), after0)
    np.testing.assert_array_equal(m1._flatten().numpy(), table)
    assert not np.array_equal(after0, table)


def test_construction_leaves_the_callers_rng_alone(tmv):
    from multiverso_tpu_torch.apps.resnet import ResNet20DataParallel

    tmv.init(device="cpu")
    torch.manual_seed(123)
    before = torch.random.get_rng_state()
    ResNet20DataParallel(num_classes=4, device="cpu")
    assert torch.equal(torch.random.get_rng_state(), before)


def test_no_device_means_the_card(tmv, monkeypatch):
    from multiverso_tpu_torch.apps.resnet import ResNet20DataParallel

    tmv.init(device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ResNet20DataParallel(num_classes=4)


def test_weights_carry_across_packages(mv, tmv, tmp_path):
    """A JAX app's nets (``state_dict``) and its ``"resnet20"`` table (the
    cross-package checkpoint) load into the port's app bit for bit."""
    from multiverso_tpu.apps.resnet import ResNet20DataParallel as JaxApp
    from multiverso_tpu_torch.apps.resnet import (ResNet20DataParallel,
                                                  synthetic_cifar)

    x, y = synthetic_cifar(128, num_classes=4, seed=2)
    uri = str(tmp_path / "resnet.ckpt")
    mv.init()
    src = JaxApp(num_classes=4, lr=0.05, seed=5)
    src.train_epoch(x, y, batch_size=64)
    mv.checkpoint.save(uri)
    want_table = src.mgrs[0].table.get()
    want_nets = [_state(n) for n in src.nets]
    mv.shutdown()

    tmv.init(device="cpu")
    dst = ResNet20DataParallel(num_classes=4, lr=0.05, seed=9, device="cpu")
    for net, state in zip(dst.nets, src.nets):
        net.load_state_dict(state.state_dict())
    tmv.checkpoint.restore(uri)
    np.testing.assert_array_equal(dst.mgrs[0].table.get(), want_table)
    for net, want in zip(dst.nets, want_nets):
        got = _state(net)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
