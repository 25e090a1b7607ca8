"""Parity of the PyTorch port's updaters with the JAX package.

Every updater, dense path and row path (unique rows, duplicate rows,
masked padding, rows past the table, aggregate-then-apply), on the same
seeded numpy inputs fed to ``multiverso_tpu.updaters`` and
``multiverso_tpu_torch.updaters``.  Tolerance 1e-6: both sides run the
same float32 formulas.  The port's row path also holds its own
contract: it scatters in place into the tensors it is given, and a
dropped entry changes no weight and no state.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiverso_tpu import updaters as jup
from multiverso_tpu_torch import updaters as tup

NAMES = ["default", "sgd", "adagrad", "momentum", "smooth_gradient",
         "assign"]
OPT = dict(learning_rate=0.1, momentum=0.9, rho=0.5, eps=1e-8)
TOL = 1e-6


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=TOL, atol=TOL)


def _both(name, w0, steps_fn):
    """Run ``steps_fn(updater, w, state, opt, asarray)`` on both sides."""
    ju, tu = jup.get_updater(name), tup.get_updater(name)
    js = ju.init_state(w0.shape, jnp.float32)
    ts = tu.init_state(w0.shape, torch.float32, "cpu")
    jw, js = steps_fn(ju, jnp.asarray(w0), js, jup.AddOption(**OPT),
                      jnp.asarray)
    tw, ts = steps_fn(tu, torch.from_numpy(w0.copy()), ts,
                      tup.AddOption(**OPT), torch.as_tensor)
    _close(tw, jw)
    assert len(ts) == len(js) == tu.num_slots
    for a, b in zip(ts, js):
        _close(a, b)


def test_registry_matches():
    assert tup.updater_names() == jup.updater_names()
    with pytest.raises(ValueError, match="unknown updater_type"):
        tup.get_updater("nope")
    for name in tup.updater_names():
        assert tup.get_updater(name).linear == jup.get_updater(name).linear
        assert (tup.get_updater(name).num_slots
                == jup.get_updater(name).num_slots)


@pytest.mark.parametrize("name", NAMES)
def test_dense_three_steps(name):
    rng = np.random.RandomState(0)
    w0 = rng.randn(5, 7).astype(np.float32)
    grads = [rng.randn(5, 7).astype(np.float32) for _ in range(3)]

    def steps(u, w, s, opt, arr):
        for g in grads:
            w, s = u.apply_dense(w, s, arr(g), opt)
        return w, s

    _both(name, w0, steps)


@pytest.mark.parametrize("name", NAMES)
def test_rows_unique(name):
    rng = np.random.RandomState(1)
    w0 = rng.randn(8, 4).astype(np.float32)
    rows = np.array([6, 1, 3, 0], np.int32)
    deltas = [rng.randn(4, 4).astype(np.float32) for _ in range(2)]

    def steps(u, w, s, opt, arr):
        for d in deltas:
            w, s = u.apply_rows(w, s, arr(rows), arr(d), opt)
        return w, s

    _both(name, w0, steps)


@pytest.mark.parametrize("name", NAMES)
def test_rows_masked_padding(name):
    """Padding (mask False, and the out-of-range row num_rows) touches
    nothing on either side; the JAX side drops it in its scatter, the
    port filters it before ``index_add``."""
    rng = np.random.RandomState(2)
    w0 = rng.randn(6, 3).astype(np.float32)
    rows = np.array([1, 6, 0, 4, 6], np.int32)
    mask = np.array([True, False, False, True, False])
    d = (rng.randn(5, 3) * 5).astype(np.float32)

    def steps(u, w, s, opt, arr):
        return u.apply_rows(w, s, arr(rows), arr(d), opt, mask=arr(mask))

    _both(name, w0, steps)


@pytest.mark.parametrize("name", ["default", "sgd", "adagrad"])
def test_rows_duplicates_direct(name):
    """Duplicate rows straight into apply_rows, where both packages
    define the result: linear updaters accumulate; adagrad accumulates
    its state first, then reads it back for every entry."""
    rng = np.random.RandomState(3)
    w0 = rng.randn(5, 2).astype(np.float32)
    rows = np.array([2, 0, 2, 2, 4], np.int32)
    d = rng.randn(5, 2).astype(np.float32)

    def steps(u, w, s, opt, arr):
        return u.apply_rows(w, s, arr(rows), arr(d), opt)

    _both(name, w0, steps)


@pytest.mark.parametrize("name", NAMES)
def test_scatter_apply_duplicates(name):
    """The fused-step spelling: non-linear updaters segment-sum the
    duplicates first (aggregate_rows), linear ones scatter them."""
    rng = np.random.RandomState(4)
    w0 = rng.randn(7, 3).astype(np.float32)
    rows = np.array([5, 1, 5, 0, 1, 5], np.int32)
    deltas = [rng.randn(6, 3).astype(np.float32) for _ in range(2)]

    def steps(u, w, s, opt, arr):
        mod = jup if arr is jnp.asarray else tup
        for d in deltas:
            w, s = mod.base.scatter_apply(u, w, s, arr(rows), arr(d), opt)
        return w, s

    _both(name, w0, steps)


def test_aggregate_rows_matches():
    rng = np.random.RandomState(5)
    rows = np.array([3, 1, 3, 7, 1, 3], np.int32)
    d = rng.randn(6, 4).astype(np.float32)
    ju, jd, jm = jup.base.aggregate_rows(jnp.asarray(rows), jnp.asarray(d))
    tu, td, tm = tup.aggregate_rows(torch.as_tensor(rows),
                                    torch.as_tensor(d))
    np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    _close(td, jd)


def test_masked_and_effective_rows_match():
    rows = np.array([0, 2, 1], np.int32)
    mask = np.array([True, False, True])
    d = np.ones((3, 2), np.float32)
    np.testing.assert_array_equal(
        tup.effective_rows(torch.as_tensor(rows), torch.as_tensor(mask),
                           5).numpy(),
        np.asarray(jup.base.effective_rows(jnp.asarray(rows),
                                           jnp.asarray(mask), 5)))
    _close(tup.masked(torch.as_tensor(d), torch.as_tensor(mask)),
           jup.base.masked(jnp.asarray(d), jnp.asarray(mask)))


@pytest.mark.parametrize("name", NAMES)
def test_rows_out_of_range_dropped(name):
    """Unmasked entries past the table's last row are dropped on both
    sides: the JAX scatter's mode="drop", and the port's dropped entries
    aimed at a real row with nothing to write."""
    rng = np.random.RandomState(6)
    w0 = rng.randn(6, 3).astype(np.float32)
    rows = np.array([1, 9, 0, 6, 12], np.int32)
    d = (rng.randn(5, 3) * 5).astype(np.float32)

    def steps(u, w, s, opt, arr):
        return u.apply_rows(w, s, arr(rows), arr(d), opt)

    _both(name, w0, steps)


def _apply_kept_only(u, w0, s0, rows, d, keep, opt):
    """The reference result: only the kept entries, on fresh copies."""
    w = torch.from_numpy(w0.copy())
    s = tuple(torch.from_numpy(x.copy()) for x in s0)
    k = np.flatnonzero(keep)
    return u.apply_rows(w, s, torch.as_tensor(rows[k]), torch.as_tensor(d[k]),
                        opt)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("kept_any", [True, False])
def test_row_apply_in_place_leaves_dropped_rows(name, kept_any):
    """The row path writes into the tensors it is given and returns them,
    and masked-off, negative and past-the-end entries change no weight
    and no state: the result equals applying the kept entries alone."""
    u = tup.get_updater(name)
    opt = tup.AddOption(**OPT)
    rng = np.random.RandomState(7)
    w0 = rng.randn(8, 3).astype(np.float32)
    s0 = [np.abs(rng.randn(8, 3)).astype(np.float32)
          for _ in range(u.num_slots)]
    rows = np.array([5, -1, 2, 8, 0, 30], np.int64)
    mask = np.array([True, True, False, True, True, True])
    if not kept_any:
        mask[:] = False
    keep = mask & (rows >= 0) & (rows < 8)
    d = (rng.randn(6, 3) * 3).astype(np.float32)
    w = torch.from_numpy(w0.copy())
    s = tuple(torch.from_numpy(x.copy()) for x in s0)
    w2, s2 = u.apply_rows(w, s, torch.as_tensor(rows), torch.as_tensor(d),
                          opt, mask=torch.as_tensor(mask))
    assert w2 is w and len(s2) == len(s)
    assert all(a is b for a, b in zip(s2, s))
    want_w, want_s = _apply_kept_only(u, w0, s0, rows, d, keep, opt)
    np.testing.assert_array_equal(w2.numpy(), want_w.numpy())
    for a, b in zip(s2, want_s):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    untouched = np.setdiff1d(np.arange(8), rows[keep])
    np.testing.assert_array_equal(w2.numpy()[untouched], w0[untouched])
    for a, b in zip(s2, s0):
        np.testing.assert_array_equal(a.numpy()[untouched], b[untouched])


def test_assign_rows_last_write_wins_past_dropped_entries():
    """Duplicates of a kept row resolve by order, and a dropped entry
    after them (aimed at that row) does not undo the last write."""
    u = tup.get_updater("assign")
    w = torch.zeros(4, 2)
    rows = torch.tensor([3, 1, 3, 9])
    d = torch.tensor([[1.0, 1.0], [2.0, 2.0], [3.0, 3.0], [7.0, 7.0]])
    w2, _ = u.apply_rows(w, (), rows, d, tup.AddOption())
    np.testing.assert_array_equal(
        w2.numpy(), [[0, 0], [2, 2], [0, 0], [3, 3]])


def test_empty_row_batch_is_a_no_op():
    for name in NAMES:
        u = tup.get_updater(name)
        w = torch.ones(3, 2)
        s = u.init_state((3, 2), torch.float32, "cpu")
        w2, s2 = u.apply_rows(w, s, torch.zeros(0, dtype=torch.int64),
                              torch.zeros(0, 2), tup.AddOption())
        np.testing.assert_array_equal(w2.numpy(), 1.0)
