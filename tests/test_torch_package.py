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
# rewritten.  metrics.py is the original minus its native bridge, under a
# module docstring of its own.
COPIED = ["config.py", "fault.py", "capacity.py", "sketch.py",
          "ops/flight_recorder.py", "util/quantization.py",
          "util/async_buffer.py", "serve/cache.py", "serve/coalescer.py",
          "io/stream.py", "io/__init__.py", "tables/kv_table.py",
          "tables/sparse_matrix_table.py", "tables/factory.py",
          "util/timer.py", "util/net_util.py", "slo.py", "profiler.py",
          "health.py", "serve/wire.py", "latency.py", "serve/hedge.py",
          "ops/audit.py", "ops/introspect.py"]


# Besides the name, a copy drops the JAX package's change-history notes
# (a pattern each, which must match once).
_HISTORY_NOTES = {
    "config.py": [(r"the PR \d+ (whole-id-set entries)", r"\1")],
    "serve/hedge.py": [(r"\nPR \d+ (audit plane's)", r"\n\1")],
}


def _rewrite(text, rel=None):
    text = text.replace("multiverso_tpu", "multiverso_tpu_torch")
    for pattern, repl in _HISTORY_NOTES.get(rel, []):
        text, n = re.subn(pattern, repl, text)
        assert n == 1, (rel, pattern, n)
    return text


def _read(*parts):
    with open(os.path.join(REPO, *parts)) as f:
        return f.read()


def _without_docstring(text):
    first = ast.parse(text).body[0]
    assert isinstance(first, ast.Expr) and isinstance(first.value,
                                                      ast.Constant)
    return "".join(text.splitlines(keepends=True)[first.end_lineno:])


def _without_native_bridge(text):
    """The original metrics.py minus the section between its "Native
    bridge" and "Periodic flush thread" banners, and minus the bridge's
    name in ``__all__``."""
    lines = text.splitlines(keepends=True)
    start = next(i for i, ln in enumerate(lines)
                 if ln.startswith("# Native bridge:")) - 1
    end = next(i for i, ln in enumerate(lines)
               if ln.startswith("# Periodic flush thread")) - 1
    out = "".join(lines[:start] + lines[end:])
    assert '"bridge_native", ' in out
    return out.replace('"bridge_native", ', "")


@pytest.mark.parametrize("rel", COPIED)
def test_copied_module_matches_its_original(rel):
    assert _read("multiverso_tpu_torch", rel) == _rewrite(
        _read("multiverso_tpu", rel), rel)


def test_metrics_is_the_original_minus_the_native_bridge():
    port = _read("multiverso_tpu_torch", "metrics.py")
    orig = _without_native_bridge(_rewrite(_read("multiverso_tpu",
                                                 "metrics.py")))
    assert _without_docstring(port) == _without_docstring(orig)
    assert "bridge_native" not in _without_docstring(port)


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
