"""Checkpoints of the port, and checkpoints crossing packages.

The port writes the JAX package's file format (magic, CRC framing,
pickle of numpy arrays), so a table checkpoint written by either package
restores in the other, exactly: after the restore both hold what the
writer held, and a further add lands the same.  The pytree checkpoints
cross the same way.  The trainer's ``save``/``restore`` is an exact
round trip at the small config ``test_torch_transformer.py`` uses.
"""

import os
from functools import partial
from types import SimpleNamespace

import numpy as np
import pytest
import torch


@pytest.fixture()
def tmv():
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
    return {"jax": SimpleNamespace(m=mv, init=mv.init),
            "torch": SimpleNamespace(m=tmv,
                                     init=partial(tmv.init, device="cpu"))}


def _rand(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _make_tables(m):
    """One table of every kind, under adagrad (one state slot each)."""
    return [m.ArrayTable(10, name="arr", init=np.ones(10, np.float32)),
            m.MatrixTable(13, 3, name="mat", init=_rand(0, 13, 3)),
            m.SparseMatrixTable(6, 2, name="sparse"),
            m.KVTable(value_shape=(2,), name="kv")]


def _train(tables, seed):
    arr, mat, sp, kv = tables
    arr.add(_rand(seed, 10))
    mat.add_rows([0, 4, 4, 12], _rand(seed + 1, 4, 3))
    sp.add_rows([5, 1], _rand(seed + 2, 2, 2))
    kv.add({"a": _rand(seed + 3, 2), 3: _rand(seed + 4, 2)})


def _state(tables):
    return [t.store_state() for t in tables]


def _assert_same(got, want):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _assert_same(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_same(g, w)
    elif isinstance(want, np.ndarray):
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want


@pytest.mark.parametrize("direction", ["torch_to_jax", "jax_to_torch"])
def test_table_checkpoint_crosses_packages(mv, tmv, tmp_path, direction):
    sides = _sides(mv, tmv)
    src, dst = direction.split("_to_")
    uri = str(tmp_path / "tables.ckpt")

    s = sides[src]
    s.init(updater_type="adagrad")
    tables = _make_tables(s.m)
    _train(tables, 1)
    s.m.barrier()
    s.m.checkpoint.save(uri, extra={"epoch": 3})
    saved = _state(tables)
    _train(tables, 2)
    want_after = _state(tables)
    s.m.shutdown()

    d = sides[dst]
    d.init(updater_type="adagrad")
    fresh = _make_tables(d.m)
    _train(fresh, 9)                     # overwritten by the restore
    assert d.m.checkpoint.restore(uri) == {"epoch": 3}
    assert d.m.clock() == 2
    _assert_same(_state(fresh), saved)
    _train(fresh, 2)
    got_after = _state(fresh)
    d.m.shutdown()
    for g, w in zip(got_after, want_after):
        for key in ("data", "store"):
            if key in w:
                np.testing.assert_allclose(
                    np.asarray(g[key] if key == "data" else
                               [g[key][k] for k in sorted(g[key], key=str)]),
                    np.asarray(w[key] if key == "data" else
                               [w[key][k] for k in sorted(w[key], key=str)]),
                    rtol=1e-6, atol=1e-6)


def test_restore_strict_names_the_mismatch(tmv, tmp_path):
    tmv.init(device="cpu")
    uri = str(tmp_path / "a.ckpt")
    tmv.ArrayTable(4, name="a")
    tmv.checkpoint.save(uri)
    tmv.ArrayTable(4, name="b")
    with pytest.raises(ValueError, match=r"\['b'\]"):
        tmv.checkpoint.restore(uri)
    assert tmv.checkpoint.restore(uri, strict=False) == {}


def test_restore_discards_pending_bsp_adds(tmv, tmp_path):
    tmv.init(device="cpu", sync=True)
    uri = str(tmp_path / "bsp.ckpt")
    t = tmv.MatrixTable(4, 2, name="m")
    tmv.checkpoint.save(uri)
    t.add_rows([1], np.ones((1, 2), np.float32))
    tmv.checkpoint.restore(uri)
    tmv.barrier()
    np.testing.assert_array_equal(t.get(), 0.0)


@pytest.mark.parametrize("where", ["header", "body", "truncate"])
def test_corrupt_file_raises(tmv, tmp_path, where):
    tmv.init(device="cpu")
    uri = str(tmp_path / "c.ckpt")
    tmv.ArrayTable(64, name="a", init=np.arange(64, dtype=np.float32))
    tmv.checkpoint.save(uri)
    raw = bytearray(open(uri, "rb").read())
    if where == "truncate":
        raw = raw[:-5]
    else:
        raw[4 if where == "header" else len(raw) - 20] ^= 0x10
    open(uri, "wb").write(bytes(raw))
    with pytest.raises(tmv.checkpoint.CheckpointCorrupt):
        tmv.checkpoint.restore(uri)


def test_checkpoint_manager_rolls_and_falls_back(tmv, tmp_path):
    tmv.init(device="cpu")
    t = tmv.ArrayTable(4, name="a")
    mgr = tmv.checkpoint.CheckpointManager(str(tmp_path / "run"), keep=2)
    for step in (1, 2, 3):
        t.add(np.ones(4, np.float32))
        mgr.save_step(step, extra={"note": step})
    assert mgr.steps() == [2, 3]
    files = sorted(f for f in os.listdir(tmp_path / "run")
                   if f.endswith(".ckpt"))
    assert files == ["step_0000000002.ckpt", "step_0000000003.ckpt"]
    with open(tmp_path / "run" / files[-1], "r+b") as f:
        f.seek(30)
        f.write(b"\xff\xff")
    t.add(np.ones(4, np.float32))
    step, extra = mgr.restore_latest()
    assert (step, extra) == (2, {"note": 2})
    np.testing.assert_array_equal(t.get(), 2.0)
    with pytest.raises(ValueError, match="keep"):
        tmv.checkpoint.CheckpointManager(str(tmp_path / "x"), keep=0)


# ------------------------------------------------------------ pytrees

def test_pytree_crosses_packages(mv, tmv, tmp_path):
    """A tree of tensors saved by the port loads in the JAX package (as
    numpy, and placed into a tree of jax arrays), and a tree of jax
    arrays saved by the JAX package restores into tensors."""
    import jax.numpy as jnp

    tree = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "layers": [(torch.ones(2),), ()], "step": 7, "name": "x"}
    uri = str(tmp_path / "t.tree")
    tmv.checkpoint.save_pytree(uri, tree)           # works before init()
    mv.init()
    got = mv.checkpoint.restore_pytree(uri)
    np.testing.assert_array_equal(got["w"], tree["w"].numpy())
    assert got["step"] == 7 and got["name"] == "x"
    assert got["layers"][1] == ()
    like = {"w": jnp.zeros((2, 3)), "layers": [(jnp.zeros(2),), ()],
            "step": 0, "name": ""}
    placed = mv.checkpoint.restore_pytree(uri, like=like)
    np.testing.assert_array_equal(np.asarray(placed["layers"][0][0]), 1.0)

    uri2 = str(tmp_path / "j.tree")
    mv.checkpoint.save_pytree(uri2, {"w": jnp.full((2, 3), 2.5),
                                     "layers": [(jnp.ones(2),), ()],
                                     "step": 9, "name": "y"})
    mv.shutdown()
    back = tmv.checkpoint.restore_pytree(uri2, like=tree)
    assert isinstance(back["w"], torch.Tensor)
    np.testing.assert_array_equal(back["w"].numpy(), 2.5)
    assert back["step"] == 9 and isinstance(back["layers"][0], tuple)


def test_pytree_leaf_and_structure_mismatch(tmv, tmp_path):
    uri = str(tmp_path / "t.tree")
    tmv.checkpoint.save_pytree(uri, {"w": torch.zeros(2, 3)})
    with pytest.raises(ValueError, match=r"\['w'\]"):
        tmv.checkpoint.restore_pytree(uri, like={"w": torch.zeros(3, 2)})
    with pytest.raises(ValueError, match="structure"):
        tmv.checkpoint.restore_pytree(uri, like={"v": torch.zeros(2, 3)})


def test_pytree_async_save(tmv, tmp_path):
    tmv.init(device="cpu")
    uri = str(tmp_path / "a.tree")
    handle = tmv.checkpoint.save_pytree_async(uri, {"w": torch.ones(3)})
    handle.result(timeout=60)
    assert handle.done()
    np.testing.assert_array_equal(
        tmv.checkpoint.restore_pytree(uri)["w"], 1.0)
    bad = tmv.checkpoint.save_pytree_async(     # a file is not a directory
        str(tmp_path / "a.tree" / "b.tree"), {"w": torch.ones(3)})
    with pytest.raises(OSError):
        bad.result(timeout=60)


# ------------------------------------------------------------- trainer

def test_trainer_save_restore_is_exact(tmv, tmp_path):
    from multiverso_tpu_torch.models import transformer as pt

    cfg = pt.TransformerConfig(vocab_size=16384, dim=64, n_layers=2,
                               n_heads=2, hidden=128, max_seq=64,
                               compute_dtype=torch.float32)
    tokens = np.random.RandomState(0).randint(0, 16384, size=(2, 64))
    uri = str(tmp_path / "trainer.tree")
    a = pt.TransformerTrainer(cfg, device="cpu", updater_type="momentum",
                              seed=1)
    a.train_step(tokens)
    a.save(uri)
    want = [a.train_step(tokens) for _ in range(2)]
    want_leaves = [p.clone() for p in pt._leaves(a.params)]
    a.restore(uri)
    assert [a.train_step(tokens) for _ in range(2)] == want
    b = pt.TransformerTrainer(cfg, device="cpu", updater_type="momentum",
                              seed=2)
    b.restore(uri)
    assert [b.train_step(tokens) for _ in range(2)] == want
    for x, y in zip(pt._leaves(b.params), want_leaves):
        assert torch.equal(x, y)
    c = pt.TransformerTrainer(cfg, device="cpu", updater_type="sgd")
    with pytest.raises(ValueError, match="structure"):
        c.restore(uri)


@pytest.mark.parametrize("layout", ["loop", "scan", "scan_moe"])
@pytest.mark.parametrize("direction", ["torch_to_jax", "jax_to_torch"])
def test_trainer_checkpoint_crosses_packages(mv, tmv, tmp_path, direction,
                                             layout):
    """The port's trainer writes the tree the JAX trainer writes for the
    same config ({"params", "state"}, per-leaf tuples of updater slots,
    layers stacked [L, ...] under scan_layers) and reads either
    package's: a run saved after one step by one package and continued
    for two by the other follows the uninterrupted run (losses rtol 1e-5,
    parameters 1e-4 of each tensor's scale, as the trajectory test)."""
    import jax
    from jax.sharding import Mesh

    from multiverso_tpu.models import transformer as jt
    from multiverso_tpu_torch.models import transformer as pt

    kw = dict(vocab_size=16384, dim=64, n_layers=2, n_heads=2, hidden=128,
              max_seq=64, scan_layers=layout != "loop")
    if layout == "scan_moe":
        kw.update(num_experts=4, moe_dispatch="capacity")
    jcfg = jt.TransformerConfig(**kw, compute_dtype=jax.numpy.float32)
    pcfg = pt.TransformerConfig(**kw, compute_dtype=torch.float32)
    mesh = Mesh(np.asarray(jax.devices()[:1]), ("dp",))
    tokens = np.random.RandomState(3).randint(0, 16384, size=(2, 64)
                                              ).astype(np.int32)
    uri = str(tmp_path / "trainer.tree")
    mv.init()
    if direction == "torch_to_jax":
        writer = pt.TransformerTrainer(pcfg, device="cpu",
                                       updater_type="momentum", seed=1)
        reader = jt.TransformerTrainer(jcfg, mesh, updater_type="momentum",
                                       seed=2)
    else:
        writer = jt.TransformerTrainer(jcfg, mesh, updater_type="momentum",
                                       seed=1)
        reader = pt.TransformerTrainer(pcfg, device="cpu",
                                       updater_type="momentum", seed=2)
    writer.train_step(tokens)
    writer.save(uri)
    want = [writer.train_step(tokens) for _ in range(2)]
    reader.restore(uri)
    got = [reader.train_step(tokens) for _ in range(2)]
    np.testing.assert_allclose(got, want, rtol=1e-5)

    def layout(tr):
        """Either trainer's tree in the JAX trainer's layout, as numpy."""
        if isinstance(tr, pt.TransformerTrainer):
            tree = tr._tree()
            tree = pt._stacked(tree) if pcfg.scan_layers else tree
        else:
            tree = {"params": tr.params, "state": tr.state}
        return jax.tree_util.tree_leaves(
            jax.tree_util.tree_map(np.asarray, tree))

    got_leaves, want_leaves = layout(reader), layout(writer)
    assert len(got_leaves) == len(want_leaves) > 0
    for a, b in zip(got_leaves, want_leaves):
        assert a.shape == b.shape
        scale = float(np.max(np.abs(b))) or 1.0
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4 * scale)
