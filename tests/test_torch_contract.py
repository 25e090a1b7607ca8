"""The port's cross-language contract under the repo's ``mvcontract``
(``tools/mvcontract.py``, static: it imports nothing of the JAX package).

Every surface points at the port (``multiverso_tpu_torch/``): the C++
``message.h``, ``c_api.h``, ``configure.cc`` and ``ops.cc``, the wire
mirror ``serve/wire.py``, the ctypes binding ``native/__init__.py``, the
Lua cdef and ``config.py``; the docs stay the repo's.  The port must diff
clean, and a seeded drift in a doctored copy of one of its surfaces (the
binding above all, which performance work will edit) must be found,
naming the surface pair.
"""

import importlib.util
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "multiverso_tpu_torch")

_spec = importlib.util.spec_from_file_location(
    "repo_mvcontract", os.path.join(REPO, "tools", "mvcontract.py"))
mvcontract = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(mvcontract)

SURFACES = {
    "message_h": "native/include/mvtpu/message.h",
    "c_api_h": "native/include/mvtpu/c_api.h",
    "wire_py": "serve/wire.py",
    "binding_py": "native/__init__.py",
    "lua": "binding/lua/multiverso.lua",
    "configure_cc": "native/src/configure.cc",
    "config_py": "config.py",
    "ops_cc": "native/src/ops.cc",
}
PORT_PATHS = {k: os.path.join(PORT, v) for k, v in SURFACES.items()}


def _findings(**overrides):
    return mvcontract.diff_contract(mvcontract.build_contract(
        REPO, **dict(PORT_PATHS, **overrides)))


def test_every_surface_but_the_docs_is_the_ports():
    assert set(SURFACES) == set(mvcontract.DEFAULT_PATHS) - {"docs"}
    paths = mvcontract.build_contract(REPO, **PORT_PATHS)["paths"]
    assert all(paths[k].startswith(PORT + os.sep) for k in SURFACES)
    assert paths["docs"] == os.path.join(REPO, "docs")


def test_port_surfaces_diff_clean():
    findings = _findings()
    assert findings == [], "\n" + "\n".join(str(f) for f in findings)


def test_main_strict_is_clean_on_the_port(capsys):
    argv = ["--strict", "--root", REPO]
    for key, path in PORT_PATHS.items():
        argv += [f"--{key.replace('_', '-')}", path]
    assert mvcontract.main(argv) == 0
    assert "mvcontract: clean" in capsys.readouterr().out


@pytest.mark.parametrize("surface,old,new,pair,names", [
    ("binding_py", "lib.MV_WaitGet.argtypes = [ctypes.c_int32]",
     "lib.MV_WaitGet.argtypes = [ctypes.c_int32, ctypes.c_int32]",
     "c_api.h<->ctypes-binding", "MV_WaitGet"),
    ("binding_py", "lib.MV_FreeString.restype = None",
     "lib.MV_FreeString.restype = ctypes.c_int",
     "c_api.h<->ctypes-binding", "MV_FreeString"),
    ("binding_py", "rc == -6", "rc == -9",
     "c_api.h<->binding-rc-map", "-9"),
    ("wire_py", '"audit", "replication"', '"audit"',
     None, "replication"),
    ("message_h", "RequestCancel = 13", "RequestCancel = 14",
     "message.h<->serve/wire.py", "RequestCancel"),
], ids=["binding-arity", "binding-restype", "binding-rc", "wire-ops-kind",
        "msgtype-value"])
def test_seeded_drift_in_a_port_surface_is_found(tmp_path, surface, old,
                                                 new, pair, names):
    text = open(PORT_PATHS[surface], encoding="utf-8").read()
    assert text.count(old) == 1, (surface, old)
    doctored = tmp_path / os.path.basename(PORT_PATHS[surface])
    doctored.write_text(text.replace(old, new))
    found = _findings(**{surface: str(doctored)})
    hits = [f for f in found if names in f.msg
            and (pair is None or f.pair == pair)]
    assert hits, "\n".join(str(f) for f in found)
    argv = ["--strict", "--root", REPO]
    for key, path in dict(PORT_PATHS, **{surface: str(doctored)}).items():
        argv += [f"--{key}", path]
    assert mvcontract.main(argv) == 1
