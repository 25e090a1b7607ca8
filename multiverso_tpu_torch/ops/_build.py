"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface, loaded through ``ctypes``
(pointers from ``tensor.data_ptr()``, the stream from
``torch.cuda.current_stream().cuda_stream``).  No source includes
PyTorch's headers and no ``ninja`` is needed, so a build takes seconds.
No library links ``-lcuda`` either: the TMA descriptors' encoder
(``cuTensorMapEncodeTiled``) comes from the driver at run time through
``cudaGetDriverEntryPoint`` (``csrc/hopper.cuh``).

Libraries land in ``ops/_build/`` (listed in ``.gitignore``) under a name
that carries a hash of the sources and flags: an edited source rebuilds
on first use, an unchanged one loads.  :func:`build` starts one ``nvcc``
per missing library, all at once.  Everything here runs only when a
kernel is first launched on a CUDA tensor — never at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict, Iterable, List

from ..log import Log

__all__ = ["SOURCES", "BUILD_DIR", "build", "load", "nvcc_path"]

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
SOURCES = ("flash_fwd", "flash_dq", "flash_dkv")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
BUILD_TIMEOUT_S = 900


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    found = cand if os.path.exists(cand) else shutil.which("nvcc")
    if not found:
        raise RuntimeError(
            f"nvcc not found (looked in {cand} and on PATH): the CUDA "
            f"kernels cannot be built on this machine")
    return found


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for fname in [f"{name}.cu"] + headers:
        with open(os.path.join(CSRC, fname), "rb") as f:
            h.update(fname.encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


def lib_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}-{_digest(name)}.so")


def build(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile every named library that is not built yet, one ``nvcc``
    per source, all started together; returns ``{name: path}``.  The
    compiler's output (``-Xptxas -v``: registers, shared memory, spills)
    is kept beside each library as ``<name>.log``.  Raises on any
    failure, naming the source and the compiler's last lines."""
    names = list(names)
    os.makedirs(BUILD_DIR, exist_ok=True)
    paths = {n: lib_path(n) for n in names}
    todo = [n for n in names if not os.path.exists(paths[n])]
    if not todo:
        return paths
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    procs: List[tuple] = []
    for n in todo:
        tmp = f"{paths[n]}.tmp.{os.getpid()}"
        cmd = [nvcc, *NVCC_FLAGS, "-I", CSRC, "-o", tmp,
               os.path.join(CSRC, f"{n}.cu")]
        procs.append((n, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    failed = []
    for n, tmp, proc in procs:
        try:
            out, _ = proc.communicate(timeout=BUILD_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, _ = proc.communicate()
            failed.append(f"{n}: nvcc timed out after {BUILD_TIMEOUT_S}s")
            continue
        text = out.decode(errors="replace")
        with open(os.path.join(BUILD_DIR, f"{n}.log"), "w") as f:
            f.write(text)
        if proc.returncode != 0:
            tail = "\n".join(text.splitlines()[-30:])
            failed.append(f"{n}: nvcc exited {proc.returncode}\n{tail}")
            continue
        os.replace(tmp, paths[n])
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    Log.info("built %s in %.1fs", ", ".join(todo), time.perf_counter() - t0)
    return paths


def load(name: str) -> ctypes.CDLL:
    """The library for ``csrc/<name>.cu``.  Builds every missing library
    first, in parallel, so a first run pays one build, not three in turn
    (the caller keeps the handle: ``ops/flash_attention.py`` loads each
    once)."""
    lib = ctypes.CDLL(build()[name])
    lib.mvt_error_string.restype = ctypes.c_char_p
    lib.mvt_error_string.argtypes = [ctypes.c_int]
    return lib
