"""The port's row tables against the JAX package's, value for value.

Each scenario runs the same seeded numpy inputs through
``multiverso_tpu`` (its 8-device CPU mesh) and ``multiverso_tpu_torch``
(``device="cpu"``) and compares what the tables hold, at atol = rtol =
1e-6: both sides run the same float32 formulas.  The cases follow the
Matrix, SparseMatrix, KV and factory cases of ``test_tables.py`` and
the prefetch case of ``test_apps.py``.

MatrixTables have 13 rows, which 8 devices do not divide: the JAX table
pads to 16 rows, so ids 13-15 read its padding and larger ids clamp to
row 15 — zeros while nothing lands there, which is what the port reads
for every id outside the table.  Adds to ids past the table are dropped
by the port; the JAX package writes ids 13-15 into its padding, which
no whole-table read shows.  That is the port's contract for ids past a
table (``multiverso_tpu_torch/tables/matrix_table.py``), and
``test_ids_past_the_table_contract`` pins both the agreement and the one
difference.
"""

from functools import partial
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

TOL = 1e-6
UPDATERS = ["default", "sgd", "adagrad", "momentum", "smooth_gradient",
            "assign"]
ROWS, COLS = 13, 4


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
    return [SimpleNamespace(name="jax", m=mv, init=mv.init, dev=jnp.asarray),
            SimpleNamespace(name="torch", m=tmv,
                            init=partial(tmv.init, device="cpu"),
                            dev=torch.as_tensor)]


@pytest.fixture(params=["jax", "torch"])
def pkg(request, mv, tmv):
    request.addfinalizer(mv.fault.reset)
    return {s.name: s for s in _sides(mv, tmv)}[request.param]


def _close(got, want):
    if isinstance(want, dict):
        assert sorted(got, key=str) == sorted(want, key=str)
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
    out = {}
    for side in _sides(mv, tmv):
        out[side.name] = scenario(side)
        side.m.shutdown()
    _close(out["torch"], out["jax"])
    return out["torch"]


def _rand(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


# ------------------------------------------------------------ MatrixTable

def test_matrix_whole_add_and_get(mv, tmv):
    d = _rand(0, ROWS, COLS)

    def run(s):
        s.init()
        t = s.m.MatrixTable(ROWS, COLS)
        t.add(d)
        t.add(d)
        return [t.get(), t.get().shape]

    got = _parity(mv, tmv, run)
    _close(got[0], 2 * d)


def test_matrix_get_rows_reads_zeros_past_the_table(mv, tmv):
    init = np.arange(ROWS * COLS, dtype=np.float32).reshape(ROWS, COLS)

    def run(s):
        s.init()
        t = s.m.MatrixTable(ROWS, COLS, init=init)
        return [t.get_rows([3, 7, 0, 12]), t.get_rows([13, 5, 14, 15, 30]),
                t.get_rows([])]

    got = _parity(mv, tmv, run)
    _close(got[0], init[[3, 7, 0, 12]])
    assert got[2].shape == (0, COLS)
    np.testing.assert_array_equal(got[1][[0, 2, 3, 4]], 0.0)


def test_ids_past_the_table_contract(mv, tmv):
    """Ids past the table: both packages read zeros while the JAX
    package's padding is untouched (ids 13-15 lie in it, larger ids read
    its last padded row, 15).  Once an ``add_rows`` of ids 14 and 15
    writes into the padding, the JAX package reads that write at 14, 15
    and every id past the padding; the port dropped the add and reads
    zeros there.  Whole-table reads agree throughout."""
    init = _rand(5, ROWS, COLS)
    past = [13, 14, 15, 16, 40]

    def run(s):
        s.init()
        t = s.m.MatrixTable(ROWS, COLS, init=init)
        untouched = t.get_rows(past)
        t.add_rows([15, 14, 2], np.full((3, COLS), 7, np.float32))
        return [untouched, t.get(), t.get_rows(past)]

    got, want = {}, {}
    for side in _sides(mv, tmv):
        (got if side.name == "torch" else want)[side.name] = run(side)
        side.m.shutdown()
    got, want = got["torch"], want["jax"]
    np.testing.assert_array_equal(got[0], 0.0)
    np.testing.assert_array_equal(want[0], 0.0)
    _close(got[1], want[1])
    np.testing.assert_array_equal(want[1][2], init[2] + 7)
    np.testing.assert_array_equal(got[2], 0.0)
    np.testing.assert_array_equal(want[2][0], 0.0)        # id 13
    np.testing.assert_array_equal(want[2][1:], 7.0)       # 14, 15, past


def _assign_case(seed, n_ids, rows, cols):
    """Ids each repeated 2-4 times in shuffled order, every entry with its
    own values, about a tenth masked off, and ids past the table."""
    rng = np.random.RandomState(seed)
    ids = np.repeat(rng.choice(rows + 6, size=n_ids, replace=False),
                    rng.randint(2, 5, size=n_ids))
    ids = ids[rng.permutation(ids.size)].astype(np.int64)
    values = rng.randn(ids.size, cols).astype(np.float32)
    mask = rng.rand(ids.size) > 0.1
    return ids, values, mask


@pytest.mark.parametrize("rows, n_ids, cols", [(40, 30, COLS),
                                               (20_000, 2_731, 64)])
def test_assign_duplicate_ids_last_write_wins(mv, tmv, rows, n_ids, cols):
    """``assign``'s row apply resolves duplicate ids by order: the last
    kept entry aimed at a row wins, as in the JAX package's
    ``.at[].set`` on the CPU.  Masked entries and ids past the table
    change nothing.  The large case runs on four threads: the CPU's
    ``index_put_`` then splits one batch's writes between threads and,
    like CUDA, leaves their order to one row undefined."""
    from multiverso_tpu import updaters as jup
    from multiverso_tpu_torch import updaters as tup

    w0 = _rand(6, rows, cols)
    ids, values, mask = _assign_case(7, n_ids, rows, cols)
    want = w0.copy()
    for i, v, m in zip(ids, values, mask):
        if m and i < rows:
            want[i] = v
    jw, _ = jup.get_updater("assign").apply_rows(
        jnp.asarray(w0), (), jnp.asarray(ids), jnp.asarray(values),
        jup.AddOption(), mask=jnp.asarray(mask))
    threads = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        tw, _ = tup.get_updater("assign").apply_rows(
            torch.from_numpy(w0.copy()), (), torch.from_numpy(ids),
            torch.from_numpy(values), tup.AddOption(),
            mask=torch.from_numpy(mask))
    finally:
        torch.set_num_threads(threads)
    np.testing.assert_array_equal(np.asarray(jw), want)
    np.testing.assert_array_equal(tw.numpy(), want)


@pytest.mark.parametrize("name", UPDATERS)
def test_matrix_add_rows_every_updater(mv, tmv, name):
    """Three row batches with duplicate ids and ids past the table, each
    with its own AddOption, through every updater; the weights, the
    state slots and row reads agree with the JAX table."""
    w0 = _rand(1, ROWS, COLS)
    batches = [(np.array([2, 5, 2, 13, 0, 21]), _rand(2, 6, COLS)),
               (np.array([12, 5, 5, 5]), _rand(3, 4, COLS)),
               (np.arange(11), _rand(4, 11, COLS))]

    def run(s):
        s.init(updater_type=name)
        t = s.m.MatrixTable(ROWS, COLS, init=w0)
        opt = s.m.AddOption(learning_rate=0.1, momentum=0.9, rho=0.5)
        for rows, d in batches:
            t.add_rows(rows, d, option=opt)
        snap = t.store_state()
        return [t.get(), snap["state"], t.get_rows([0, 5, 12, 3, 5])]

    _parity(mv, tmv, run)


def test_matrix_add_rows_duplicates_aggregate(mv, tmv):
    def run(s):
        s.init()
        t = s.m.MatrixTable(6, 2)
        t.add_rows(np.array([1, 1, 3]), np.ones((3, 2), np.float32))
        return t.get()

    got = _parity(mv, tmv, run)
    np.testing.assert_allclose(got[1], 2.0)
    np.testing.assert_allclose(got[3], 1.0)


def test_matrix_rows_with_adagrad_matches_formula(mv, tmv):
    def run(s):
        s.init(updater_type="adagrad")
        t = s.m.MatrixTable(6, 2)
        opt = s.m.AddOption(learning_rate=0.1)
        t.add_rows([1], np.ones((1, 2), np.float32), option=opt)
        t.add_rows([1], np.ones((1, 2), np.float32), option=opt)
        return t.get()

    got = _parity(mv, tmv, run)
    np.testing.assert_allclose(got[1], -0.1 - 0.1 / np.sqrt(2.0), rtol=1e-6)
    np.testing.assert_allclose(got[0], 0.0)


def test_matrix_large_row_batch(mv, tmv):
    """37 rows: past the JAX package's smallest power-of-two bucket."""
    def run(s):
        s.init()
        t = s.m.MatrixTable(100, 3)
        t.add_rows(np.arange(37), np.ones((37, 3), np.float32))
        return t.get()

    got = _parity(mv, tmv, run)
    np.testing.assert_allclose(got[:37], 1.0)
    np.testing.assert_allclose(got[37:], 0.0)


def test_matrix_bsp_flushes_per_option(mv, tmv):
    """BSP: row and whole-matrix adds are invisible until the barrier,
    then each buffered AddOption applies with its own options."""
    g = [_rand(10 + i, 2, COLS) for i in range(3)]
    dense = _rand(13, ROWS, COLS)

    def run(s):
        s.init(sync=True, updater_type="adagrad")
        t = s.m.MatrixTable(ROWS, COLS, init=np.ones((ROWS, COLS),
                                                     np.float32))
        a = s.m.AddOption(learning_rate=0.5)
        b = s.m.AddOption(learning_rate=2.0)
        t.add_rows([0, 4], g[0], option=a)
        t.add_rows([4, 7], g[1], option=b)
        t.add_rows([0, 14], g[2], option=a)
        t.add(dense, option=b)
        before = t.get()
        s.m.barrier()
        return [before, t.get(), t.store_state()["state"]]

    got = _parity(mv, tmv, run)
    np.testing.assert_allclose(got[0], 1.0)


@pytest.mark.parametrize("staleness,visible", [(0, [0.0, 1.0, 1.0]),
                                               (1, [0.0, 0.0, 1.0])])
def test_matrix_and_kv_ssp_defer(mv, tmv, staleness, visible):
    def run(s):
        s.init()
        m = s.m.MatrixTable(4, 2, sync=True, staleness=staleness, name="m",
                            updater_type="default")
        k = s.m.KVTable(value_shape=(), sync=True, staleness=staleness,
                        name="k", updater_type="default")
        m.add_rows([1], np.ones((1, 2), np.float32))
        k.add({"x": np.float32(1.0)})
        seen = [[m.get()[1, 0], k.get(["x"])["x"]]]
        for _ in range(2):
            s.m.barrier()
            seen.append([m.get()[1, 0], k.get(["x"])["x"]])
        return seen

    _close(_parity(mv, tmv, run), [[v, v] for v in visible])


def test_matrix_borrowed_delta_is_not_written(pkg):
    pkg.init(sync=True)
    t = pkg.m.MatrixTable(3, 2)
    d = np.ones((3, 2), np.float32)
    t.add(d, borrow=True)
    t.add(d, borrow=True)
    r = np.ones((1, 2), np.float32)
    t.add_rows([1], r, borrow=True)
    np.testing.assert_allclose(d, 1.0)
    pkg.m.barrier()
    np.testing.assert_allclose(t.get(), [[2, 2], [3, 3], [2, 2]])
    with pytest.raises(ValueError, match="dtype"):
        t.add_rows([0], np.ones((1, 2), np.float64), borrow=True)


def test_matrix_out_buffers(pkg):
    pkg.init()
    init = np.arange(12, dtype=np.float32).reshape(6, 2)
    t = pkg.m.MatrixTable(6, 2, init=init)
    buf = np.empty((2, 2), np.float32)
    assert t.get_rows([4, 1], out=buf) is buf
    np.testing.assert_allclose(buf, init[[4, 1]])
    whole = np.empty((6, 2), np.float32)
    assert t.get(out=whole) is whole
    np.testing.assert_allclose(whole, init)
    with pytest.raises(ValueError, match="host-path"):
        t.get(device=True, out=whole)


def test_matrix_shape_errors(pkg):
    pkg.init()
    t = pkg.m.MatrixTable(4, 2)
    with pytest.raises(ValueError, match="mismatch"):
        t.add_rows([0, 1], np.ones((3, 2), np.float32))
    with pytest.raises(ValueError, match="delta shape"):
        t.add(np.ones((4, 3), np.float32))


def test_matrix_one_bit_add_bit_for_bit(mv, tmv):
    d = _rand(20, ROWS, COLS)

    def run(s):
        s.init()
        t = s.m.MatrixTable(ROWS, COLS, name="q")
        t.add(d, compress="1bit")
        return t.get()

    out = {}
    for s in _sides(mv, tmv):
        out[s.name] = run(s)
        s.m.shutdown()
    np.testing.assert_array_equal(out["torch"], out["jax"])
    np.testing.assert_array_equal(out["torch"] >= 0, d >= 0)


def test_matrix_device_add_and_get(mv, tmv):
    d = _rand(21, ROWS, COLS)

    def run(s):
        s.init(updater_type="sgd")
        t = s.m.MatrixTable(ROWS, COLS)
        t.add(s.dev(d), sync=True)
        dev = t.get(device=True)
        before = np.array(dev)
        t.add_rows([0], np.ones((1, COLS), np.float32))
        return [t.get(), before, np.array(dev)]

    got = _parity(mv, tmv, run)
    _close(got[1], -0.1 * d)
    _close(got[2], got[1])          # the device snapshot did not move


def test_matrix_row_add_is_in_place(tmv):
    """A row add scatters into the tensor the table owns (no copy of the
    table), while what ``get(device=True)`` returned stays as it was."""
    tmv.init(device="cpu", updater_type="adagrad")
    t = tmv.MatrixTable(8, 3)
    data, (h,) = t.raw_value()
    ptrs = (data.data_ptr(), h.data_ptr())
    snap = t.get(device=True)
    t.add_rows([1, 6, 1, 40], np.ones((4, 3), np.float32))
    data2, (h2,) = t.raw_value()
    assert (data2.data_ptr(), h2.data_ptr()) == ptrs
    np.testing.assert_array_equal(snap.numpy(), 0.0)
    assert np.count_nonzero(t.get().any(axis=1)) == 2


def test_matrix_handler_parity_api(mv, tmv):
    def run(s):
        s.init()
        t = s.m.MatrixTableHandler(5, 3)
        t.add_all(np.ones((5, 3), np.float32))
        t.add_by_rows(np.ones((2, 3), np.float32), [0, 4])
        return [t.get_all(), t.get_by_rows([0, 4])]

    got = _parity(mv, tmv, run)
    np.testing.assert_allclose(got[1], 2.0)


def test_matrix_serve_row_cache_and_workload(mv, tmv):
    """With the serve cache armed, row reads hit per row, an add to a row
    invalidates it, and the workload tracker counts the same traffic."""
    def run(s):
        s.init(args=["-serve_cache_entries=64"])
        t = s.m.MatrixTable(ROWS, COLS, name="served")
        first = t.get_rows([1, 2, 3])
        t.add_rows([2], np.ones((1, COLS), np.float32))
        second = t.get_rows([3, 2, 1, 2])
        second[:] = 7.0               # a caller's copy, not the cache
        rep = t.workload_report()
        return [first, t.get_rows([2, 3]), rep["gets"], rep["adds"],
                [k["key"] for k in rep["hotkeys"]["topk"][:2]]]

    got = _parity(mv, tmv, run)
    _close(got[1][0], np.ones(COLS))


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_matrix_snapshot_crosses_packages(mv, tmv, direction):
    g1, g2 = _rand(50, 5, COLS), _rand(51, 5, COLS)
    rows = np.array([0, 3, 3, 12, 7])
    sides = {s.name: s for s in _sides(mv, tmv)}
    src, dst = (("jax", "torch") if direction == "jax_to_torch"
                else ("torch", "jax"))

    def trained(s, snap=None):
        s.init(updater_type="adagrad")
        t = s.m.MatrixTable(ROWS, COLS, name="ck",
                            init=np.ones((ROWS, COLS), np.float32))
        if snap is None:
            t.add_rows(rows, g1)
        else:
            t.load_state(snap)
        return t

    a = trained(sides[src])
    snap = a.store_state()
    a.add_rows(rows, g2)
    want = [a.get(), a.store_state()["state"]]
    sides[src].m.shutdown()
    b = trained(sides[dst], snap)
    _close(b.store_state()["data"], snap["data"])
    b.add_rows(rows, g2)
    _close([b.get(), b.store_state()["state"]], want)
    sides[dst].m.shutdown()


def test_matrix_load_state_rejects_a_mismatch(tmv):
    tmv.init(device="cpu")
    snap = tmv.MatrixTable(4, 2).store_state()
    with pytest.raises(ValueError, match="shape"):
        tmv.MatrixTable(4, 3).load_state(snap)


# ------------------------------------------------------ SparseMatrixTable

def test_sparse_cache_hit_miss_invalidate(mv, tmv):
    """The host mirror serves repeat reads, and every kind of write
    (row add, whole add, flush, load_state, raw_assign) invalidates."""
    def run(s):
        s.init()
        t = s.m.SparseMatrixTable(8, 2)
        seen = [t.get_rows([1, 2])]
        assert t._cache_valid[[1, 2]].all() and not t._cache_valid[0]
        t.add_rows([1], np.ones((1, 2), np.float32))
        assert not t._cache_valid[1] and t._cache_valid[2]
        seen.append(t.get_rows([1, 2, 9]))
        t.add(np.ones((8, 2), np.float32))
        assert not t._cache_valid.any()
        seen.append(t.get_rows([1, 2]))
        snap = t.store_state()
        t.add_rows([2], np.ones((1, 2), np.float32))
        seen.append(t.get_rows([2]))
        t.load_state(snap)
        assert not t._cache_valid.any()
        seen.append(t.get_rows([2]))
        data, state = t.raw_value()
        t.raw_assign(data, state)
        assert not t._cache_valid.any()
        seen.append(t.get_rows([]))
        return seen

    got = _parity(mv, tmv, run)
    np.testing.assert_allclose(got[1], [[1, 1], [0, 0], [0, 0]])
    np.testing.assert_allclose(got[4], [[1, 1]])
    assert got[5].shape == (0, 2)


def test_sparse_bsp_flush_invalidates(mv, tmv):
    def run(s):
        s.init(sync=True, updater_type="sgd")
        t = s.m.SparseMatrixTable(8, 2)
        first = t.get_rows([3])
        t.add_rows([3], np.ones((1, 2), np.float32),
                   option=s.m.AddOption(learning_rate=1.0))
        before = t.get_rows([3])
        s.m.barrier()
        return [first, before, t.get_rows([3])]

    _close(_parity(mv, tmv, run), [np.zeros((1, 2)), np.zeros((1, 2)),
                                   -np.ones((1, 2))])


def test_sparse_cache_off_reads_through(pkg):
    pkg.init()
    t = pkg.m.SparseMatrixTable(4, 2, cache=False)
    t.add_rows([1], np.ones((1, 2), np.float32))
    np.testing.assert_allclose(t.get_rows([1]), 1.0)
    assert t._cache_valid is None


# ---------------------------------------------------------------- KVTable

@pytest.mark.parametrize("name", UPDATERS)
def test_kv_every_updater(mv, tmv, name):
    g = [_rand(60 + i, 3) for i in range(3)]

    def run(s):
        s.init(updater_type=name)
        t = s.m.KVTable(value_shape=(3,))
        opt = s.m.AddOption(learning_rate=0.1, momentum=0.9, rho=0.5)
        t.add({"a": g[0], 7: g[1]}, option=opt)
        t.add({"a": g[2]}, option=opt)
        snap = t.store_state()
        return [t.get(["a", 7, "missing"]), snap["store"], snap["state"]]

    _parity(mv, tmv, run)


def test_kv_basic_raw_and_scalar_momentum(mv, tmv):
    def run(s):
        s.init()
        t = s.m.KVTable(value_shape=(3,))
        t.add({"a": np.ones(3, np.float32)})
        t.add({"a": np.ones(3, np.float32), "b": 2 * np.ones(3, np.float32)})
        out = t.get(["a", "b", "missing"])
        raw = dict(t.raw)
        m = s.m.KVTable(value_shape=(), updater_type="momentum", name="mom")
        m.add({"x": np.float32(1.0)},
              option=s.m.AddOption(learning_rate=0.1, momentum=0.9))
        return [out, raw, m.get(["x"])]

    got = _parity(mv, tmv, run)
    np.testing.assert_allclose(got[0]["a"], 2.0)
    np.testing.assert_allclose(got[2]["x"], -0.1, rtol=1e-6)


def test_kv_coalesce_and_add_many(mv, tmv):
    """coalesce=True buffers eager adds until the barrier; add_many is
    one apply of the merged dicts."""
    def run(s):
        s.init(updater_type="adagrad")
        c = s.m.KVTable(value_shape=(2,), coalesce=True, name="co")
        c.add({"k": np.ones(2, np.float32)})
        c.add({"k": np.ones(2, np.float32)})
        held = c.get(["k"])
        s.m.barrier()
        m = s.m.KVTable(value_shape=(2,), name="many")
        m.add_many([{"k": np.ones(2, np.float32)},
                    {"k": np.ones(2, np.float32), "j": np.ones(2, np.float32)}])
        m.add_many([])
        return [held, c.get(["k"]), m.get(["k", "j"]), m.store_state()["state"]]

    got = _parity(mv, tmv, run)
    np.testing.assert_allclose(got[0]["k"], 0.0)


def test_kv_sync_flush(mv, tmv):
    def run(s):
        s.init(sync=True)
        t = s.m.KVTable(value_shape=())
        t.add({"x": np.float32(1.0)})
        t.add({"x": np.float32(2.0)})
        before = t.get(["x"])
        s.m.barrier()
        return [before, t.get(["x"])]

    _close(_parity(mv, tmv, run), [{"x": 0.0}, {"x": 3.0}])


def test_kv_borrow_rejects_a_wrong_dtype(pkg):
    pkg.init()
    t = pkg.m.KVTable(value_shape=(2,))
    with pytest.raises(ValueError, match="borrow"):
        t.add({"a": np.ones(2, np.float64)}, borrow=True)


# ---------------------------------------------------------------- factory

def test_create_table_every_kind(pkg):
    pkg.init()
    a = pkg.m.create_table("array", 8)
    m = pkg.m.create_table("matrix", 4, 2)
    s = pkg.m.create_table("sparse_matrix", 4, 2)
    k = pkg.m.create_table("kv", value_shape=(1,))
    assert [t.kind for t in (a, m, s, k)] == ["array", "matrix",
                                              "sparse_matrix", "kv"]
    with pytest.raises(ValueError, match="unknown table kind"):
        pkg.m.create_table("nope")


def test_port_tables_live_on_the_context_device(tmv):
    tmv.init(device="cpu")
    t = tmv.create_table("matrix", 4, 2)
    assert t.sharding == torch.device("cpu")
    assert t.raw_value()[0].device == torch.device("cpu")


# ------------------------------------------------------ prefetch_to_device

def test_prefetch_to_device_on_the_cpu(tmv):
    from multiverso_tpu_torch.parallel.sharding import batch_placer
    from multiverso_tpu_torch.util import prefetch_to_device

    batches = [{"x": np.full((4, 2), i, np.float32), "i": i,
                "pair": (np.arange(3), "tag")} for i in range(5)]
    got = list(prefetch_to_device(iter(batches), size=2, sharding="cpu"))
    assert [b["i"] for b in got] == list(range(5))
    for i, b in enumerate(got):
        assert isinstance(b["x"], torch.Tensor) and b["x"].device.type == "cpu"
        np.testing.assert_allclose(b["x"].numpy(), i)
        assert b["pair"][1] == "tag" and isinstance(b["pair"], tuple)
    _, place = batch_placer("cpu", dtype=torch.int64)
    (b,) = prefetch_to_device(iter(batches[:1]), sharding=place)
    assert b["x"].dtype == torch.int64 and b["i"] == 0
    with pytest.raises(ValueError, match=">= 1"):
        prefetch_to_device(iter(batches), size=0)
    assert [b["i"] for b in prefetch_to_device(iter(batches), size=10,
                                               sharding="cpu")] == list(
        range(5))


def test_prefetch_defaults_to_the_card(tmv, monkeypatch):
    from multiverso_tpu_torch.util import prefetch_to_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        next(prefetch_to_device(iter([np.zeros(2)])))
