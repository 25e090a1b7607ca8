"""Rules of the PyTorch port as a package: it stands alone (no ``jax``,
nothing of ``multiverso_tpu``), it runs on the card unless told
otherwise, its copied host planes (log, metrics, tracing, dashboard)
work without the JAX package, and each module copied from the JAX
package still equals its original after the package-name rewrite."""

import ast
import os
import re
import subprocess
import sys
import textwrap

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "multiverso_tpu_torch")


def _py_files():
    for root, _, files in os.walk(PKG):
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")


def test_imports_every_module_with_jax_blocked():
    code = textwrap.dedent(f"""
        import importlib, pkgutil, sys
        sys.modules["jax"] = None
        sys.modules["multiverso_tpu"] = None
        sys.path.insert(0, {REPO!r})
        import multiverso_tpu_torch as pkg
        names = [m.name for m in pkgutil.walk_packages(pkg.__path__,
                                                       pkg.__name__ + ".")]
        for name in names:
            importlib.import_module(name)
        assert "jax" not in [m for m in sys.modules if sys.modules[m]]
        print(len(names))
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd="/")
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 49


def test_no_jax_or_reference_imports_in_source():
    bad = []
    for path in _py_files():
        with open(path) as f:
            tree = ast.parse(f.read(), filename=path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module or ""]
            else:
                continue
            for m in mods:
                top = m.split(".")[0]
                if top in ("jax", "jaxlib", "multiverso_tpu"):
                    bad.append(f"{os.path.relpath(path, REPO)}:"
                               f"{node.lineno} imports {m}")
    assert not bad, bad


def test_default_device_is_the_card_and_never_falls_back(monkeypatch):
    import multiverso_tpu_torch as mv
    from multiverso_tpu_torch import resolve_device
    from multiverso_tpu_torch.apps import DLRMRecommender, SkipGram
    from multiverso_tpu_torch.models import (TransformerConfig,
                                             TransformerTrainer)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = TransformerConfig(vocab_size=64, dim=64, n_layers=1, n_heads=2,
                            hidden=64, max_seq=16)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TransformerTrainer(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mv.init()
    # The apps' tables live where init() put the context, so without it
    # they refuse to start rather than land on the CPU.
    for make in (lambda: SkipGram(50, 4), lambda: DLRMRecommender(8, 8)):
        with pytest.raises(RuntimeError, match="not initialized"):
            make()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device() == torch.device("cuda", 0)
    try:
        assert mv.init().device == torch.device("cuda", 0)
        if not torch.backends.cuda.is_built():
            # This torch has no CUDA: placing a table on the card fails
            # instead of falling back to the CPU.
            for make in (lambda: SkipGram(50, 4, name="w2v_card"),
                         lambda: DLRMRecommender(8, 8, name="dlrm_card")):
                with pytest.raises((RuntimeError, AssertionError)):
                    make()
    finally:
        mv.shutdown()
        mv.config.reset()


def test_dashboard_monitor_feeds_metrics_and_spans(tmp_path):
    from multiverso_tpu_torch import dashboard, metrics, tracing

    dashboard.reset()
    tracing.clear()
    tracing.enable()
    try:
        with dashboard.monitor("Transformer::train_step"):
            pass
        with dashboard.monitor("Transformer::train_step"):
            pass
    finally:
        tracing.disable()
    mon = dashboard.get_monitor("Transformer::train_step")
    assert mon.count == 2
    snap = metrics.snapshot()["Transformer::train_step"]
    assert snap["type"] == "histogram" and snap["count"] == 2
    assert [e.name for e in tracing.events()] == ["Transformer::train_step"] * 2
    path = tmp_path / "trace_rank0.json"
    assert tracing.save(str(path)) == 2
    merged = tracing.merge_dir(str(tmp_path))
    assert os.path.exists(merged)
    assert "Transformer::train_step" in metrics.render_prometheus()
    dashboard.reset()
    tracing.clear()


def test_dashboard_trace_capture_uses_torch_profiler(tmp_path):
    from multiverso_tpu_torch import dashboard

    dashboard.start_trace(str(tmp_path))
    torch.ones(8).sum()
    dashboard.stop_trace()
    assert any(f.endswith(".json") for f in os.listdir(tmp_path))


def test_build_names_missing_nvcc(monkeypatch, tmp_path):
    """Without nvcc the first kernel launch fails loudly, naming it —
    it never falls back to the plain version."""
    from multiverso_tpu_torch.ops import _build

    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()


def test_build_rebuilds_when_a_source_changes(monkeypatch, tmp_path):
    import shutil

    from multiverso_tpu_torch.ops import _build

    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", str(csrc))
    before = {n: _build.lib_path(n) for n in _build.SOURCES}
    with open(csrc / "flash_common.cuh", "a") as f:
        f.write("\n// edited\n")
    after = {n: _build.lib_path(n) for n in _build.SOURCES}
    assert all(before[n] != after[n] for n in _build.SOURCES)
    with open(csrc / "flash_dq.cu", "a") as f:
        f.write("\n// edited\n")
    again = {n: _build.lib_path(n) for n in _build.SOURCES}
    assert again["flash_dq"] != after["flash_dq"]
    assert again["flash_fwd"] == after["flash_fwd"]


# Modules the port copies from the JAX package with only the package name
# rewritten.
COPIED = ["config.py", "fault.py", "capacity.py", "sketch.py",
          "ops/flight_recorder.py", "util/quantization.py",
          "util/async_buffer.py", "serve/cache.py", "serve/coalescer.py",
          "io/stream.py", "io/__init__.py", "tables/kv_table.py",
          "tables/sparse_matrix_table.py", "tables/factory.py",
          "util/timer.py", "util/net_util.py", "slo.py", "profiler.py",
          "health.py", "serve/wire.py", "latency.py", "serve/hedge.py",
          "ops/audit.py", "ops/introspect.py", "metrics.py",
          "tracing.py", "serve/client.py", "parallel/offload.py",
          "native/__init__.py", "apps/lr_native_worker.py",
          "apps/w2v_native_worker.py", "apps/serve_bench_worker.py",
          "apps/embedding_bench_worker.py"]


# Besides the name, a copy drops the JAX package's change-history notes
# and names the port's profiler (a pattern each, which must match once).
_HISTORY_NOTES = {
    "config.py": [(r"the PR \d+ (whole-id-set entries)", r"\1")],
    "serve/hedge.py": [(r"\nPR \d+ (audit plane's)", r"\n\1")],
    "tracing.py": [(r"``jax\.profiler`` capture", "``torch.profiler`` capture"),
                   (r"for XLA-level depth", "for kernel-level depth")],
}

# Where a copy is the original with a change of its own: each pattern
# must match once in the copy and once in the original, and the two
# texts must be equal outside the matches.  The binding builds under a
# lock, into a temporary name renamed into place (its imports and
# ``ensure_built``); ``uring_net.cc``'s io_uring probe uses one aligned
# buffer, because ``io_uring_probe`` ends in a flexible array member in
# newer kernel headers and cannot be nested in a struct.
_PORT_CHANGES = {
    "native/__init__.py": [r"\nimport ctypes\n.*?from typing",
                           r"\ndef ensure_built\(.*?\n    return _LIB\n"],
    "native/src/uring_net.cc": [
        r"\n  (?:struct \{|// io_uring_probe ends).*?"
        r"kProbeOpSupported\)\) \{\n"],
}


# Then every copy drops the number of the JAX package's change that a
# comment cites: the noun after the number stays ("the send contract").
_CHANGE_NUMBERS = [
    (r" ?\(PRs? \d+(?:/\d+)*\)", ""),
    (r", PR \d+\)", ")"),
    (r"\b([Aa]) PR \d+ ([aeiou])", r"\1n \2"),
    (r"\b(?:the )?PR \d+'s( |$)", r"the\1"),
    (r"\b([Tt]he|[Aa]) PR \d+ ", r"\1 "),
    (r"\bPR \d+ ", ""),
]


def _rewrite(text, rel=None):
    text = text.replace("multiverso_tpu", "multiverso_tpu_torch")
    for pattern, repl in _HISTORY_NOTES.get(rel, []):
        text, n = re.subn(pattern, repl, text)
        assert n == 1, (rel, pattern, n)
    for pattern, repl in _CHANGE_NUMBERS:
        text = re.sub(pattern, repl, text, flags=re.M)
    return text


def _read(*parts):
    with open(os.path.join(REPO, *parts)) as f:
        return f.read()


def _outside_changes(text, rel):
    for pattern in _PORT_CHANGES.get(rel, []):
        text, n = re.subn(pattern, "\n<port change>\n", text,
                          flags=re.DOTALL)
        assert n == 1, (rel, pattern, n)
    return text


@pytest.mark.parametrize("rel", COPIED)
def test_copied_module_matches_its_original(rel):
    port = _read("multiverso_tpu_torch", rel)
    want = _rewrite(_read("multiverso_tpu", rel), rel)
    assert _outside_changes(port, rel) == _outside_changes(want, rel)
    if rel not in _PORT_CHANGES:
        assert port == want


def _native_sources():
    root = os.path.join(REPO, "multiverso_tpu", "native")
    out = ["Makefile", "test/test_main.cc"]
    for sub in ("src", "include/mvtpu"):
        out += sorted(f"{sub}/{f}" for f in os.listdir(os.path.join(root,
                                                                    sub)))
    return out


@pytest.mark.parametrize("rel", _native_sources())
def test_native_source_matches_its_original(rel):
    """The port's copy of the native runtime's C++ sources and Makefile:
    the original with the package name rewritten, and in ``uring_net.cc``
    the one repair (the probe's aligned buffer) and nothing else."""
    rel = f"native/{rel}"
    port = _read("multiverso_tpu_torch", rel)
    want = _rewrite(_read("multiverso_tpu", rel), rel)
    assert _outside_changes(port, rel) == _outside_changes(want, rel)
    if rel in _PORT_CHANGES:
        assert port != want and "alignas(io_uring_probe)" in port
        assert "alignas(io_uring_probe)" not in want
    else:
        assert port == want


def test_copies_cite_no_change_numbers():
    """No copy cites a change of the JAX package by its number."""
    rels = COPIED + [f"native/{r}" for r in _native_sources()]
    cited = [rel for rel in rels
             if re.search(r"\bPRs? ?#?\d", _read("multiverso_tpu_torch",
                                                   rel))]
    assert not cited, cited


def test_native_copy_is_complete():
    """Every C++ source and header the port's library builds from has
    its original (nothing added past the copy)."""
    port = os.path.join(PKG, "native")
    have = ["Makefile", "test/test_main.cc"]
    for sub in ("src", "include/mvtpu"):
        have += sorted(f"{sub}/{f}"
                       for f in os.listdir(os.path.join(port, sub)))
    assert have == _native_sources()


def test_binding_differs_only_in_its_build():
    """The binding's two changes: the imports of the locked build, and
    ``ensure_built``, which takes the lock and renames into place."""
    port = _read("multiverso_tpu_torch", "native/__init__.py")
    want = _rewrite(_read("multiverso_tpu", "native/__init__.py"))
    assert port != want
    assert "fcntl.flock(lock, fcntl.LOCK_EX)" in port
    assert "os.replace(" in port and "os.replace(" not in want


def test_metrics_overflow_and_capacity_hooks(tmp_path):
    """The two hooks the port restored: a label-cardinality overflow lands
    in the flight recorder, and a flush exports the capacity gauges."""
    from multiverso_tpu_torch import capacity, metrics
    from multiverso_tpu_torch.ops.flight_recorder import recorder

    reg = metrics.Registry()
    for i in range(metrics.MAX_SERIES_PER_NAME + 1):
        reg.counter("drift.test", {"i": str(i)})
    assert any(e["kind"] == "metric_overflow" and e["detail"] == "drift.test"
               for e in recorder.events())
    capacity.register_gauge("drift.test", lambda: 1234)
    try:
        path = tmp_path / "m.prom"
        metrics.start_flush(10, path=str(path))
        metrics.stop_flush()
        assert "capacity_drift_test 1234.0" in path.read_text()
    finally:
        capacity.unregister_gauge("drift.test")
        metrics.REGISTRY.remove("capacity.drift.test")
