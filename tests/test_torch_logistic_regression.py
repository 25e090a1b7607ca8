"""The port's logistic regression against the JAX package's.

The four LR cases of ``test_apps.py`` run on both packages (the JAX
package on its 8-device CPU mesh, the port with ``device="cpu"``), and a
20-step trajectory of each training path — the push-pull
``train_batch`` and the fused step — is held to the JAX package's at
rtol 1e-4 / atol 1e-5 (the JAX package's own tolerance between its two
paths).
"""

from functools import partial
from types import SimpleNamespace

import numpy as np
import pytest
import torch

RTOL, ATOL = 1e-4, 1e-5


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


def _sides(mv, tmv):
    import multiverso_tpu.apps as japps
    import multiverso_tpu_torch.apps as tapps

    return [SimpleNamespace(name="jax", m=mv, init=mv.init, apps=japps),
            SimpleNamespace(name="torch", m=tmv,
                            init=partial(tmv.init, device="cpu"),
                            apps=tapps)]


@pytest.fixture(params=["jax", "torch"])
def pkg(request, mv, tmv):
    return {s.name: s for s in _sides(mv, tmv)}[request.param]


def test_synthetic_data_is_the_same(mv, tmv):
    jx, jy = _sides(mv, tmv)[0].apps.synthetic_classification(64, 8, 3, 5)
    tx, ty = _sides(mv, tmv)[1].apps.synthetic_classification(64, 8, 3, 5)
    np.testing.assert_array_equal(tx, jx)
    np.testing.assert_array_equal(ty, jy)


def test_lr_parity_path_converges(pkg):
    pkg.init(updater_type="sgd")
    x, y = pkg.apps.synthetic_classification(512, 16, 4, seed=0)
    lr = pkg.apps.LogisticRegression(16, 4, learning_rate=0.5)
    first = lr.evaluate(x, y)[0]
    for _ in range(5):
        for i in range(0, 512, 64):
            lr.train_batch(x[i:i + 64], y[i:i + 64])
    last, acc = lr.evaluate(x, y)
    assert last < first * 0.5
    assert acc > 0.8


def test_lr_fused_path_converges(pkg):
    pkg.init(updater_type="sgd")
    x, y = pkg.apps.synthetic_classification(1024, 16, 4, seed=1)
    lr = pkg.apps.LogisticRegression(16, 4, learning_rate=0.5)
    first = lr.evaluate(x, y)[0]
    for _ in range(5):
        lr.train_epoch_fused(x, y, batch_size=128)
    last, acc = lr.evaluate(x, y)
    assert last < first * 0.5
    assert acc > 0.8
    with pytest.raises(ValueError, match="no full batch"):
        lr.train_epoch_fused(x[:10], y[:10], batch_size=128)


def test_lr_fused_matches_parity_single_step(pkg):
    """The fused step computes the same math as the push-pull loop."""
    pkg.init(updater_type="sgd")
    x, y = pkg.apps.synthetic_classification(128, 8, 3, seed=2)
    a = pkg.apps.LogisticRegression(8, 3, learning_rate=0.1, name="lr_a",
                                    seed=7)
    b = pkg.apps.LogisticRegression(8, 3, learning_rate=0.1, name="lr_b",
                                    seed=7)
    np.testing.assert_allclose(a.table.get(), b.table.get())

    a.train_batch(x, y)

    step, place = b.make_fused_step()
    assert b.make_fused_step() == (step, place)   # built once
    data, state = b.table.raw_value()
    data, state, _ = step(data, state, place(x), place(y))
    b.table.raw_assign(data, state)

    np.testing.assert_allclose(a.table.get(), b.table.get(),
                               rtol=RTOL, atol=ATOL)


def test_lr_workers_consistent_bsp(pkg):
    """Sync mode: k workers' adds all apply at the barrier; every worker
    then pulls identical parameters."""
    pkg.init(sync=True, updater_type="sgd")
    x, y = pkg.apps.synthetic_classification(256, 8, 3, seed=3)
    lr = pkg.apps.LogisticRegression(8, 3, learning_rate=0.1)
    w0 = lr.table.get()
    for wid in range(4):
        lr.train_batch(x[wid * 64:(wid + 1) * 64],
                       y[wid * 64:(wid + 1) * 64])
    np.testing.assert_allclose(lr.table.get(), w0)  # clock still open
    pkg.m.barrier()
    assert not np.allclose(lr.table.get(), w0)


def _pushpull(side, x, y, steps):
    side.init(updater_type="sgd")
    lr = side.apps.LogisticRegression(32, 5, learning_rate=0.2, seed=4)
    losses = [lr.train_batch(x, y) for _ in range(steps)]
    return losses, lr.table.get()


def _fused(side, x, y, steps):
    side.init(updater_type="sgd")
    lr = side.apps.LogisticRegression(32, 5, learning_rate=0.2, seed=4)
    step, place = lr.make_fused_step()
    data, state = lr.table.raw_value()
    xb, yb = place(x), place(y)
    losses = []
    for _ in range(steps):
        data, state, loss = step(data, state, xb, yb)
        losses.append(loss)
    lr.table.raw_assign(data, state)
    return [float(v) for v in losses], lr.table.get()


@pytest.mark.parametrize("path", [_pushpull, _fused],
                         ids=["pushpull", "fused"])
def test_twenty_step_trajectory_matches_jax(mv, tmv, path):
    x, y = _sides(mv, tmv)[0].apps.synthetic_classification(256, 32, 5,
                                                            seed=6)
    out = {}
    for side in _sides(mv, tmv):
        out[side.name] = path(side, x, y, 20)
        side.m.shutdown()
    (jl, jw), (tl, tw) = out["jax"], out["torch"]
    np.testing.assert_allclose(tl, jl, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tw, jw, rtol=RTOL, atol=ATOL)
    assert tl[-1] < tl[0]


def test_fused_step_keeps_the_loss_on_the_device(tmv):
    """The fused step hands back a 0-d tensor: nothing in it waits for
    the device (no ``.item()``) until the caller asks for a float."""
    tmv.init(device="cpu")
    from multiverso_tpu_torch.apps import (LogisticRegression,
                                           synthetic_classification)

    x, y = synthetic_classification(64, 8, 3, seed=8)
    lr = LogisticRegression(8, 3)
    step, place = lr.make_fused_step()
    data, state = lr.table.raw_value()
    data, state, loss = step(data, state, place(x), place(y))
    assert isinstance(loss, torch.Tensor) and loss.shape == ()
    assert data.device == lr.table.device == torch.device("cpu")
