"""The port's copy of the native runtime (``multiverso_tpu_torch/native``):
its library, built from the port's own C++ sources, and the ctypes
binding, in one process on the CPU.

One runtime serves the module (``-updater_type=assign``, the offload
store's updater: an add overwrites).  The checks follow the JAX
package's host-bridge tests: the arena (alignment, recycling, release
errors, stats), borrowed and async array and matrix round trips,
``get_rows``, KV, ``store_table``/``load_table``, and the native
monitors and spans folded into the port's metrics and traces.  The
binding's errors are the port's own classes.  The library builds once
under a lock: two processes that call ``ensure_built`` at once run one
build and load one intact library; built by a compiler that links
libstdc++ statically, it exports none of that copy's symbols.  The C++
unit suite of the copy (``test/test_main.cc``) passes, the repaired
io_uring probe included.
"""

import ctypes
import os
import shutil
import stat
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from multiverso_tpu_torch import metrics, native as nat, tracing

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_NATIVE = os.path.join(REPO, "multiverso_tpu_torch", "native")


@pytest.fixture(scope="module")
def rt():
    r = nat.NativeRuntime(args=["-updater_type=assign", "-log_level=error"])
    yield r
    r.shutdown()


@pytest.fixture()
def arena(rt):
    return rt.arena()


def test_library_is_the_ports_own_build(rt):
    assert nat.lib_path() == os.path.join(PORT_NATIVE, "build",
                                          "libmvtpu.so")
    with open("/proc/self/maps") as f:
        maps = f.read()
    assert nat.lib_path() in maps
    assert rt.net_engine() == "local"
    assert (rt.workers_num(), rt.worker_id(), rt.server_id()) == (1, 0, 0)


def test_errors_are_the_ports_own_classes():
    """``serve.client`` and ``fault.RetryPolicy``'s users catch these by
    identity: they must be the port's classes, raised by ``_check``."""
    from multiverso_tpu_torch.serve import client

    assert client.BusyError is nat.BusyError
    for cls in (nat.BusyError, nat.ArenaError):
        assert cls.__module__ == "multiverso_tpu_torch.native"
        assert issubclass(cls, RuntimeError)
    with pytest.raises(nat.BusyError):
        nat.NativeRuntime._check(-6, "x")
    with pytest.raises(nat.ArenaError):
        nat.NativeRuntime._check(-7, "x")
    with pytest.raises(RuntimeError, match="rc=-3"):
        nat.NativeRuntime._check(-3, "x")
    nat.NativeRuntime._check(0, "x")


def test_arena_alignment_recycling_and_stats(rt, arena):
    a = arena.alloc(1000)
    assert a.dtype == np.float32 and a.shape == (1000,)
    assert a.ctypes.data % 64 == 0 and a.flags["C_CONTIGUOUS"]
    addr = a.ctypes.data
    assert arena.owns(a)
    arena.release(a)
    assert not arena.owns(a)
    b = arena.alloc(1000)                   # same capacity: recycled
    assert b.ctypes.data == addr
    arena.release(b)
    st = arena.stats()
    assert set(st) == {"buffers", "free_buffers", "bytes", "in_flight",
                       "deferred", "recycled", "pinned"}
    assert all(v >= 0 for v in st.values()) and st["recycled"] >= 1


def test_arena_release_errors(rt, arena):
    a = arena.alloc(64)
    arena.release(a)
    with pytest.raises(nat.ArenaError):
        arena.release(a)                    # double release
    with pytest.raises(nat.ArenaError):
        arena.release(np.zeros(64, np.float32))


def test_borrowed_array_round_trip_and_out(rt, arena):
    h = rt.new_array_table(512)
    buf = arena.alloc(512)
    buf[:] = np.arange(512, dtype=np.float32)
    rt.array_add(h, buf, sync=True, borrowed=True)
    out = arena.alloc(512)
    got = rt.array_get(h, 512, out=out)
    assert got is out and np.array_equal(got, buf)
    buf[:] = -3.25                          # assign: overwrite, not add
    rt.array_add(h, buf, sync=True, borrowed=True)
    assert np.all(rt.array_get(h, 512) == np.float32(-3.25))
    with pytest.raises(nat.ArenaError):
        rt.array_add(h, np.ones(512, np.float32), borrowed=True)
    with pytest.raises(ValueError):         # never converts
        rt.array_add(h, buf.astype(np.float64), borrowed=True)
    with pytest.raises(ValueError):         # never copies a strided view
        rt.array_add(h, buf[::2], borrowed=True)
    with pytest.raises(ValueError):
        rt.array_get(h, 512, out=np.zeros(512, np.float64))
    arena.release(buf)
    arena.release(out)


def test_async_get_borrowed_defers_release_and_plain(rt, arena):
    h = rt.new_array_table(4096)
    buf = arena.alloc(4096)
    buf[:] = 7.0
    rt.array_add(h, buf, sync=True, borrowed=True)
    out = arena.alloc(4096)
    before = arena.stats()["deferred"]
    ag = rt.array_get_async(h, 4096, out=out, arena=arena)
    arena.release(out)                      # mid-flight: must defer
    assert np.all(ag.wait() == 7.0)
    assert arena.stats()["deferred"] - before >= 1
    assert np.all(rt.array_get_async(h, 4096).wait() == 7.0)
    with pytest.raises(nat.ArenaError):
        rt.array_get_async(h, 4096, out=np.zeros(4096, np.float32),
                           arena=arena)
    arena.release(buf)


def test_matrix_round_trips_and_get_rows(rt, arena):
    h = rt.new_matrix_table(16, 8)
    md = arena.alloc((16, 8))
    md[:] = np.arange(128, dtype=np.float32).reshape(16, 8)
    rt.matrix_add_all(h, md, borrowed=True)
    assert np.array_equal(rt.matrix_get_all(h, 16, 8), md)
    rows = arena.alloc((3, 8))
    rows[:] = 9.0
    rt.matrix_add_rows(h, [2, 5, 11], rows, borrowed=True)
    out = arena.alloc((3, 8))
    got = rt.matrix_get_rows_async(h, [2, 5, 11], 8, out=out,
                                   arena=arena).wait()
    assert np.all(got == 9.0)
    plain = rt.matrix_get_rows(h, [0, 1], 8)
    assert np.array_equal(plain, md[:2])
    rt.matrix_add_rows(h, np.array([3]), np.full((1, 8), 2.5, np.float32),
                       sync=False)
    assert np.all(rt.matrix_get_rows_async(h, [3], 8).wait() == 2.5)
    filled = np.zeros(16, np.float32)
    assert rt.matrix_get_rows(h, [5, 11], 8, out=filled).shape == (2, 8)
    assert np.all(filled == 9.0)
    with pytest.raises(ValueError, match="shape mismatch"):
        rt.matrix_add_rows(h, [1, 2], np.ones((3, 8), np.float32))
    for b in (md, rows, out):
        arena.release(b)


def test_kv_single_and_batch(rt):
    h = rt.new_kv_table()
    rt.kv_add(h, "alpha", 1.5)
    assert rt.kv_get(h, "alpha") == 1.5
    rt.kv_add(h, ["b", "c"], np.array([2.0, -4.0], np.float32))
    np.testing.assert_array_equal(rt.kv_get(h, ["c", "b", "absent"]),
                                  [-4.0, 2.0, 0.0])
    with pytest.raises(ValueError, match="length mismatch"):
        rt.kv_add(h, ["x", "y"], np.ones(3, np.float32))


def test_store_and_load_table(rt, tmp_path):
    h = rt.new_array_table(100)
    v = np.random.RandomState(3).randn(100).astype(np.float32)
    rt.array_add(h, v)
    path = str(tmp_path / "arr.bin")
    rt.store_table(h, path)
    rt.array_add(h, np.zeros(100, np.float32))
    assert np.all(rt.array_get(h, 100) == 0)
    rt.load_table(h, path)
    assert rt.array_get(h, 100).tobytes() == v.tobytes()
    with pytest.raises(RuntimeError, match="MV_LoadTable"):
        rt.load_table(h, str(tmp_path / "missing.bin"))


def test_monitors_and_spans_reach_the_ports_planes(rt):
    """``metrics.bridge_native`` imports every native monitor, and
    ``tracing.add_native_spans`` folds the native spans into the port's
    trace buffer."""
    h = rt.new_array_table(32)
    rt.set_trace_enabled(True)
    try:
        rt.array_add(h, np.ones(32, np.float32))
        rt.array_get(h, 32)
    finally:
        rt.set_trace_enabled(False)
    assert rt.query_monitor("ArrayWorker::Get") >= 1
    n = metrics.bridge_native(rt)
    assert n == len(rt.dump_monitors()) and n > 0
    snap = metrics.snapshot()
    assert snap["native.ArrayWorker::Get"]["count"] >= 1
    tracing.clear()
    try:
        spans = tracing.add_native_spans(rt)
        assert spans > 0
        assert all(e.args == {"plane": "native"} for e in tracing.events())
    finally:
        tracing.clear()
        rt.clear_spans()
    parsed = tracing.parse_native_spans("get\t7\t100\t5\t0\t65537\n")
    assert (parsed[0].name, parsed[0].trace_id, parsed[0].tid) == (
        "get", 7, 1)


def test_uring_probe_runs(rt):
    """``MV_UringSupported`` walks the repaired ``KernelSupportsOp``
    (the probe's aligned buffer): it answers either way, without
    faulting."""
    assert rt.uring_supported() in (True, False)


def test_cpp_unit_suite_of_the_copy(tmp_path):
    """The copy's own C++ unit suite, built from the port's sources
    into a directory of its own (the library's ``build/`` untouched)."""
    out_dir = str(tmp_path / "b")
    subprocess.run(["make", "-C", PORT_NATIVE, "-j",
                    str(os.cpu_count() or 2), f"BUILD={out_dir}",
                    os.path.join(out_dir, "mvtpu_test")],
                   check=True, capture_output=True, timeout=900)
    run = subprocess.run([os.path.join(out_dir, "mvtpu_test")],
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stdout[-3000:] + run.stderr[-2000:]
    assert "ALL NATIVE TESTS PASSED" in run.stdout


def test_concurrent_builds_take_turns(tmp_path):
    """Two processes call ``ensure_built`` on a fresh copy at once: they
    take turns on the lock, so ``make`` runs once, and both load the one
    library, renamed into place whole (no temporary left behind).  The
    ``make`` on ``PATH`` is a stand-in that logs its call and writes the
    real library slowly into the target it is given."""
    copy = tmp_path / "native"
    copy.mkdir()
    shutil.copy(os.path.join(PORT_NATIVE, "__init__.py"), copy)
    bindir = tmp_path / "bin"
    bindir.mkdir()
    log = tmp_path / "make.log"
    fake = bindir / "make"
    fake.write_text(textwrap.dedent(f"""\
        #!{sys.executable}
        import sys, time
        with open({str(log)!r}, "a") as f:
            f.write(" ".join(sys.argv[1:]) + "\\n")
        data = open({nat.ensure_built()!r}, "rb").read()
        with open(sys.argv[-1], "wb") as f:
            f.write(data[:len(data) // 2])
            f.flush()
            time.sleep(1.0)
            f.write(data[len(data) // 2:])
    """))
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    code = textwrap.dedent(f"""
        import ctypes, importlib.util
        spec = importlib.util.spec_from_file_location(
            "natcopy", {str(copy / "__init__.py")!r})
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        path = mod.ensure_built()
        ctypes.CDLL(path).MV_NumWorkers
        print(path)
    """)
    env = dict(os.environ, PATH=f"{bindir}{os.pathsep}{os.environ['PATH']}")
    procs = [subprocess.Popen([sys.executable, "-c", code], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-2000:]
    lib = copy / "build" / "libmvtpu.so"
    assert {o.strip() for o, _ in outs} == {str(lib)}
    assert len(log.read_text().splitlines()) == 1
    with open(nat.lib_path(), "rb") as f:
        assert lib.read_bytes() == f.read()
    assert os.listdir(copy / "build") == ["libmvtpu.so"]
    assert (copy / "build.lock").exists()
    ctypes.CDLL(str(lib))


def test_static_runtime_symbols_stay_local(tmp_path):
    """Built by a compiler that links libstdc++ statically (``CXX`` set
    to ``g++ -static-libstdc++``), the library exports none of that
    copy's symbols, so the process's own libstdc++ cannot interpose
    them; it still loads and serves a table through shutdown in a
    process that has loaded torch."""
    copy = tmp_path / "native"
    shutil.copytree(PORT_NATIVE, copy,
                    ignore=shutil.ignore_patterns("build", "build.lock",
                                                  "__pycache__"))
    code = textwrap.dedent(f"""
        import importlib.util, numpy as np, torch
        spec = importlib.util.spec_from_file_location(
            "natcopy", {str(copy / "__init__.py")!r})
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        rt = mod.NativeRuntime(["-updater_type=assign", "-log_level=error"])
        h = rt.new_array_table(8)
        rt.array_add(h, np.ones(8, np.float32))
        assert "Dashboard" in rt.dashboard_report()
        rt.shutdown()
        print(mod.lib_path())
    """)
    env = dict(os.environ, CXX="g++ -static-libstdc++")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    lib = out.stdout.strip().splitlines()[-1]
    syms = subprocess.run(["nm", "-D", "--defined-only", lib],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout
    assert "MV_ShutDown" in syms
    exported_std = [ln for ln in syms.splitlines()
                    if "_ZNSo" in ln or "_ZNSt6locale" in ln]
    assert not exported_std, exported_std[:5]
