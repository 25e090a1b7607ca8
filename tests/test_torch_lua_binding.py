"""The port's Lua binding (``multiverso_tpu_torch/binding/lua/
multiverso.lua``, the LuaJIT FFI module over the C API) against the
port's own library.

The module's ``ffi.cdef`` block must declare its functions as the
port's ``native/include/mvtpu/c_api.h`` does, every ``int MV_*`` of the
header among them, and the wrapper must call each one; its default library
path must be the port's build (``native.lib_path()``).  The exact cdef
block is fed through ``cffi`` (LuaJIT's FFI's twin: both parse C
declarations and bind them to a dlopened library) against
``native.ensure_built()``'s library and replays the Lua smoke's round
trips.  The Lua smoke itself (``chip_smoke.lua_smoke``) runs only where
a ``luajit`` is on PATH.
"""

import importlib.util
import os
import re
import shutil
import subprocess
import sys

import pytest

from multiverso_tpu_torch import native as nat

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_PKG = os.path.join(_ROOT, "multiverso_tpu_torch")
_LUA_DIR = os.path.join(_PKG, "binding", "lua")
_LUA = os.path.join(_LUA_DIR, "multiverso.lua")
_HDR = os.path.join(_PKG, "native", "include", "mvtpu", "c_api.h")


def _read(path):
    with open(path) as f:
        return f.read()


def _cdef():
    m = re.search(r"ffi\.cdef\[\[(.*?)\]\]", _read(_LUA), re.DOTALL)
    assert m, "no ffi.cdef block in multiverso.lua"
    return m.group(1)


def _decls(text):
    """{name: normalized declaration} of every ``<type> MV_*(...);``."""
    out = {}
    for m in re.finditer(r"\b((?:const )?\w+\s*\**)\s*(MV_\w+)\s*\(([^;]*?)"
                         r"\)\s*;", text, re.DOTALL):
        decl = f"{m.group(1)} {m.group(2)}({m.group(3)})"
        out[m.group(2)] = re.sub(r"\s+", " ",
                                 decl.replace("*", " * ")).strip()
    return out


def test_cdef_matches_the_ports_c_api_header():
    """Every cdef'd function is the header's, declared identically, and
    every ``int MV_*`` of the header is cdef'd (the three string dumps
    the module does not wrap are left out)."""
    lua, hdr = _decls(_cdef()), _decls(_read(_HDR))
    assert len(lua) >= 90
    assert set(lua) <= set(hdr), sorted(set(lua) - set(hdr))
    missing = sorted(n for n in set(hdr) - set(lua)
                     if hdr[n].startswith("int "))
    assert not missing, missing
    assert sorted(set(hdr) - set(lua)) == [
        "MV_DashboardReport", "MV_DumpMonitors", "MV_DumpSpans"]
    drift = {n: (lua[n], hdr[n]) for n in lua if lua[n] != hdr[n]}
    assert not drift, drift


def test_wrapper_calls_every_cdef_function():
    cdef = _cdef()
    body = _read(_LUA).replace(cdef, "")
    unused = [n for n in _decls(cdef) if f"C.{n}" not in body]
    assert not unused, unused
    for api in ("mv.init", "mv.shutdown", "mv.barrier",
                "mv.ArrayTableHandler", "mv.MatrixTableHandler",
                "mv.KVTableHandler"):
        assert api in body, api


def test_module_loads_the_ports_build():
    """``lib_path()`` in the module is ``here/../../native/build/
    libmvtpu.so``: from the port's binding directory, the port's build."""
    lua = _read(_LUA)
    rel = re.search(r'return here \.\. "([^"]+)"', lua).group(1)
    assert os.path.realpath(_LUA_DIR + rel) == os.path.realpath(
        nat.lib_path())
    assert 'os.getenv("MVTPU_NATIVE_LIB")' in lua


CFFI_REPLAY = """
import sys

import cffi

ffi = cffi.FFI()
ffi.cdef(open(sys.argv[1]).read())       # the verbatim Lua cdef block
C = ffi.dlopen(sys.argv[2])

argv = [ffi.new("char[]", s) for s in (b"-updater_type=default",
                                       b"-log_level=error")]
assert C.MV_Init(len(argv), ffi.new("const char*[]", argv)) == 0

h = ffi.new("int32_t[1]")
assert C.MV_NewArrayTable(8, h) == 0
assert C.MV_AddArrayTable(h[0], ffi.new("float[]", [1.0] * 8), 8) == 0
out = ffi.new("float[8]")
assert C.MV_GetArrayTable(h[0], out, 8) == 0
assert list(out) == [1.0] * 8

m = ffi.new("int32_t[1]")
assert C.MV_NewMatrixTable(6, 3, m) == 0
ids = ffi.new("int32_t[]", [1, 4])
assert C.MV_AddMatrixTableByRows(
    m[0], ffi.new("float[]", [1, 2, 3, 4, 5, 6]), ids, 2, 3) == 0
rows = ffi.new("float[6]")
assert C.MV_GetMatrixTableByRows(m[0], rows, ffi.new("int32_t[]", [4, 1]),
                                 2, 3) == 0
assert list(rows) == [4.0, 5.0, 6.0, 1.0, 2.0, 3.0]
one = ffi.new("int32_t[]", [1])
assert C.MV_AddAsyncMatrixTableByRows(
    m[0], ffi.new("float[]", [10.0] * 3), one, 1, 3) == 0
assert C.MV_Barrier() == 0
assert C.MV_GetMatrixTableByRows(m[0], rows, one, 1, 3) == 0
assert rows[0] == 11.0

# Async gets: a waited ticket is consumed (a second wait is -2), and a
# cancelled one cannot be waited.
w = ffi.new("int32_t[1]")
arows = ffi.new("float[3]")
assert C.MV_GetAsyncMatrixTableByRows(m[0], arows, one, 1, 3, w) == 0
assert C.MV_WaitGet(w[0]) == 0 and arows[0] == 11.0
assert C.MV_WaitGet(w[0]) == -2
aout = ffi.new("float[8]")
assert C.MV_GetAsyncArrayTable(h[0], aout, 8, w) == 0
assert C.MV_WaitGet(w[0]) == 0 and aout[0] == 1.0
assert C.MV_GetAsyncArrayTable(h[0], aout, 8, w) == 0
assert C.MV_CancelGet(w[0]) == 0
assert C.MV_WaitGet(w[0]) == -2

kv = ffi.new("int32_t[1]")
assert C.MV_NewKVTable(kv) == 0
assert C.MV_AddKV(kv[0], b"alpha", 2.5) == 0
v = ffi.new("float[1]")
assert C.MV_GetKV(kv[0], b"alpha", v) == 0 and v[0] == 2.5
assert C.MV_AddKVBatch(kv[0], b"bcc", ffi.new("int32_t[]", [1, 2]), 2,
                       ffi.new("float[]", [1.0, 2.0])) == 0
vals = ffi.new("float[3]")
assert C.MV_GetKVBatch(kv[0], b"ccbabsent", ffi.new("int32_t[]", [2, 1, 6]),
                       3, vals) == 0
assert list(vals) == [2.0, 1.0, 0.0]

assert C.MV_Barrier() == 0
assert C.MV_ShutDown() == 0
print("CFFI_REPLAY_OK")
"""


def test_cdef_replayed_through_cffi_on_the_ports_library(tmp_path):
    pytest.importorskip("cffi")
    lib = nat.ensure_built()
    assert os.path.realpath(lib).startswith(os.path.realpath(_PKG) + os.sep)
    (tmp_path / "cdef.h").write_text(_cdef())
    (tmp_path / "replay.py").write_text(CFFI_REPLAY)
    out = subprocess.run(
        [sys.executable, str(tmp_path / "replay.py"),
         str(tmp_path / "cdef.h"), lib],
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "CFFI_REPLAY_OK" in out.stdout


@pytest.mark.skipif(shutil.which("luajit") is None,
                    reason="no luajit on PATH")
def test_lua_smoke_on_the_ports_library():
    _spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(_ROOT, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(_spec)
    _spec.loader.exec_module(chip_smoke)
    nat.ensure_built()
    out = chip_smoke.lua_smoke(shutil.which("luajit"))
    assert out.returncode == 0, out.stdout + out.stderr
    assert "LUA_SMOKE_OK" in out.stdout
