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
    # Nor a module of the repo's ``tools/``, which import the JAX package.
    tools = {f[:-3] for f in os.listdir(os.path.join(REPO, "tools"))
             if f.endswith(".py")}
    assert "mvplan" in tools
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
                if top in ("jax", "jaxlib", "multiverso_tpu") or m in tools:
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
          "apps/embedding_bench_worker.py", "apps/skew_bench_worker.py",
          "tools/mvplan.py", "apps/capacity_bench_worker.py",
          "apps/failover_bench_worker.py", "apps/fanin_bench_worker.py",
          "apps/audit_demo_worker.py", "apps/doctor_demo_worker.py",
          "apps/latency_demo_worker.py", "apps/ops_demo_worker.py",
          "binding/lua/multiverso.lua", "tools/latdoctor.py",
          "tools/mvaudit.py", "tools/mvdoctor.py", "tools/mvtop.py",
          "apps/failover_demo_worker.py"]

# Where an original lies outside the JAX package: the port's copies of
# the operator CLIs are the repo's ``tools/<name>.py``, and its
# interactive failover worker is the JAX tests' ``failover_worker.py``.
_CLIS = ("mvplan", "latdoctor", "mvaudit", "mvdoctor", "mvtop")
_ORIGINALS = {f"tools/{n}.py": ("tools", f"{n}.py") for n in _CLIS}
_ORIGINALS["apps/failover_demo_worker.py"] = ("tests", "failover_worker.py")


# Besides the name, a copy drops the JAX package's change-history notes
# and names the port's profiler (a pattern each, which must match once).
_HISTORY_NOTES = {
    "config.py": [(r"the PR \d+ (whole-id-set entries)", r"\1")],
    "serve/hedge.py": [(r"\nPR \d+ (audit plane's)", r"\n\1")],
    "tracing.py": [(r"``jax\.profiler`` capture", "``torch.profiler`` capture"),
                   (r"for XLA-level depth", "for kernel-level depth")],
}

# The CLIs print their tables, findings and verdicts: the repo's lint
# (tools/mvlint.py) reads every file under the port's path outside apps/
# as library code, so each print carries MV006's marker (a pattern, and
# how many times it must match).
_LINT_MARKERS = {
    f"tools/{n}.py": (r"^( *print\(.*)$",
                      r"\1  # mvlint: MV006-exempt(CLI output)", count)
    for n, count in (("mvplan", 4), ("latdoctor", 4), ("mvaudit", 7),
                     ("mvdoctor", 2), ("mvtop", 2))
}


# The path header of a copy one directory deeper than its original
# climbs one directory more: the CLIs' ``REPO`` and the failover
# worker's ``sys.path`` entry, each one statement of ``os.path.dirname``
# calls over ``__file__``.
_DEEPER = (r"\n(?:REPO = |sys\.path\.insert\(0, )(?:os\.path\.dirname\(\n?"
           r"(?:    )?)+os\.path\.abspath\(__file__\)\)+\n")

# The shutdown repair: the heartbeat's per-peer senders tie their
# connect retries to the lease loop's running flag, so a rank whose peer
# left first does not wait out the peer's reconnect budget in
# ``MV_ShutDown`` (``tests/test_torch_native_shutdown.py``).  Its regions:
# the guard in ``transport.h``, each engine's connect loop and send
# retry, and the sender that sets it.
_GIVE_UP = r"(?: \|\| transport::ConnectAbandoned\(\))?"
_ENGINE_REPAIR = [
    rf"\n    if \(!running_ \|\| stopping_{_GIVE_UP}\) break;\n",
    rf"\n      backoff_ms \*= 2;\n      if \(!running_{_GIVE_UP}\) "
    r"return false;\n"]

# Where a copy is the original with a change of its own: each pattern
# must match once in the copy and once in the original, and the two
# texts must be equal outside the matches.  The binding builds under a
# lock, into a temporary name renamed into place (its imports and
# ``ensure_built``); ``uring_net.cc``'s io_uring probe uses one aligned
# buffer, because ``io_uring_probe`` ends in a flexible array member in
# newer kernel headers and cannot be nested in a struct.
_PORT_CHANGES = {
    "native/include/mvtpu/transport.h": [
        r"\n#include <(?:atomic>\n#include <)?cstdint>\n",
        r"\ninline bool IsClientRank\(.*?\n\}  // namespace transport\n"],
    "native/src/net.cc": [
        r"\n      if \(!running_\) break;\n    \}\n"
        r"(?:    if \(transport::ConnectAbandoned\(\)\) break;\n)?",
        r"\n      backoff_ms \*= 2;\n"
        r"(?:      if \(transport::ConnectAbandoned\(\)\) return false;\n)?"],
    "native/src/epoll_net.cc": _ENGINE_REPAIR,
    "native/src/zoo.cc": [
        r"\n    senders\.emplace_back\(\[this, peer, interval\] \{\n"
        r"(?:      // Stop clears.*?SetConnectGuard\(&hb_running_\);\n)?"],
    "native/__init__.py": [r"\nimport ctypes\n.*?from typing",
                           r"\ndef ensure_built\(.*?\n    return _LIB\n"],
    "native/src/uring_net.cc": [
        r"\n  (?:struct \{|// io_uring_probe ends).*?"
        r"kProbeOpSupported\)\) \{\n", *_ENGINE_REPAIR],
    # The capacity worker imports the port's own copy of the placement
    # advisor, where the original puts the repo's ``tools/`` on the path.
    "apps/capacity_bench_worker.py": [
        r"\n(?:sys\.path\.insert\(0, os\.path\.join\([^\n]*\n[^\n]*"
        r"\"tools\"\)\)\nimport mvplan"
        r"|from multiverso_tpu_torch\.tools import mvplan)  # noqa: E402\n"],
    # The failover worker and the CLIs lie one directory deeper than
    # their originals (under the package, not the repo's tests/ and
    # tools/), so each path header climbs one more.
    "apps/failover_demo_worker.py": [_DEEPER],
    **{f"tools/{n}.py": [_DEEPER] for n in _CLIS[1:]},
    # The SLO's breach counter is made with its total counter, so its
    # history ring holds zeros before the first breach
    # (tests/test_torch_slo_burn.py).
    "latency.py": [r"\n        if slo_s > 0:\n.*?\n                [^\n]*"
                   r"\.inc\(\)\n"],
    # A span also opens ``torch.profiler.record_function`` while a
    # profiler capture runs, so it lands on the device trace's clock (the
    # docstring's "Two clocks"); ``trace_ids``, which nothing of the port
    # reads, is gone (tests/test_torch_phase_spans.py).
    "tracing.py": [r"\n  cheap always-on complement\.\n"
                   r"(?:\nTwo clocks\..*?enters nothing\.\n)?",
                   r"\nimport os\n(?:import sys\n)?import threading\n"
                   r"import time\nfrom contextlib import contextmanager"
                   r"(?:, nullcontext)?\n",
                   r"\"events\",\n(?:    \"trace_ids\",\n)?",
                   r"\n(?:def _profiling\(\).*?)?@contextmanager\n"
                   r"def span\(.*?\n# -+\n# Native span import"],
    # A counting series keeps the time it was made, and its first history
    # ring starts with a zero point stamped then, so increments before
    # its first flush are in every window
    # (tests/test_torch_metrics_window.py).
    "metrics.py": [r"\n                s = cls\(name, key, \*\*kwargs\)\n"
                   r"(?:                # Kept for record_history.*?"
                   r"s\.created = [^\n]*\n)?",
                   r"\n        points = \[\]\n.*?\n"
                   r"                ring\.append\(\(ts, v\)\)\n"],
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
    if rel in _LINT_MARKERS:
        pattern, repl, count = _LINT_MARKERS[rel]
        text, n = re.subn(pattern, repl, text, flags=re.M)
        assert n == count, (rel, pattern, n)
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


def _original(rel):
    return _read(*_ORIGINALS.get(rel, ("multiverso_tpu", rel)))


@pytest.mark.parametrize("rel", COPIED)
def test_copied_module_matches_its_original(rel):
    port = _read("multiverso_tpu_torch", rel)
    want = _rewrite(_original(rel), rel)
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


# What each repaired native file holds that its original does not.
_NATIVE_REPAIRS = {
    "native/include/mvtpu/transport.h": ["inline bool ConnectAbandoned()"],
    "native/src/net.cc": ["transport::ConnectAbandoned()"],
    "native/src/epoll_net.cc": ["transport::ConnectAbandoned()"],
    "native/src/uring_net.cc": ["alignas(io_uring_probe)",
                                "transport::ConnectAbandoned()"],
    "native/src/zoo.cc": ["transport::SetConnectGuard(&hb_running_)"],
}


@pytest.mark.parametrize("rel", _native_sources())
def test_native_source_matches_its_original(rel):
    """The port's copy of the native runtime's C++ sources and Makefile:
    the original with the package name rewritten, and in the repaired
    files (the io_uring probe's aligned buffer, the shutdown's connect
    guard) those repairs and nothing else."""
    rel = f"native/{rel}"
    port = _read("multiverso_tpu_torch", rel)
    want = _rewrite(_read("multiverso_tpu", rel), rel)
    assert _outside_changes(port, rel) == _outside_changes(want, rel)
    if rel in _PORT_CHANGES:
        assert port != want
        for mark in _NATIVE_REPAIRS[rel]:
            assert mark in port and mark not in want, (rel, mark)
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


# ---------------------------------------------- mvplan against the repo's

def _seeded_zipf_fleet(nshards=2, seed=7):
    """A fleet capacity document: uniform bucket bytes and zipf bucket
    load over ``nshards`` ranks (the JAX package's own mvplan test
    builds this one, ``tests/test_capacity.py``)."""
    import numpy as np

    rng = np.random.RandomState(seed)
    p = 1.0 / np.arange(1, 65)
    p /= p.sum()
    load = rng.multinomial(20000, p).astype(int)
    ranks = {}
    for sid in range(nshards):
        gets = [int(load[b]) if b % nshards == sid else 0
                for b in range(64)]
        bb = [512 if b % nshards == sid else 0 for b in range(64)]
        ranks[str(sid)] = {
            "rank": sid, "armed": True, "server_id": sid,
            "servers": nshards,
            "proc": {"rss_bytes": 1, "vm_hwm_bytes": 1, "open_fds": 1,
                     "uptime_s": 1.0},
            "arena": {}, "net": {}, "gauges": {},
            "tables": [{"id": 0,
                        "shard": {"resident_bytes": sum(bb),
                                  "rows": 64 // nshards,
                                  "gets": sum(gets), "adds": 0,
                                  "bucket_bytes": bb,
                                  "bucket_gets": gets,
                                  "bucket_adds": [0] * 64},
                        "history": {"windows": 0, "curve": []}}]}
    return {"kind": "capacity", "scope": "fleet", "ranks": ranks,
            "silent": []}


def _mvplans():
    """The repo's ``tools/mvplan.py`` and the port's copy, loaded without
    leaving the copy's directory on ``sys.path``."""
    import copy
    import importlib
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "repo_mvplan", os.path.join(REPO, "tools", "mvplan.py"))
    repo = importlib.util.module_from_spec(spec)
    path = copy.copy(sys.path)
    try:
        spec.loader.exec_module(repo)
        port = importlib.import_module("multiverso_tpu_torch.tools.mvplan")
    finally:
        sys.path[:] = path
    return repo, port


@pytest.mark.parametrize("history", [False, True],
                         ids=["zipf", "history_rate"])
def test_mvplan_proposes_what_the_repo_tool_proposes(history):
    """The port's mvplan and the repo's, on the seeded zipf fleet and on
    its variant with a recorded history rate: identical aggregates,
    weights and proposals, with bucket moves proposed."""
    import copy

    repo, port = _mvplans()
    doc = _seeded_zipf_fleet()
    if history:
        doc["ranks"]["0"]["tables"][0]["history"] = {
            "windows": 2, "span_ms": 1000,
            "bucket_rate": [100.0] + [0.0] * 63, "curve": []}
    want = repo.propose(copy.deepcopy(doc))
    assert port.propose(copy.deepcopy(doc)) == want
    agg = port.aggregate_fleet(copy.deepcopy(doc))
    assert agg == repo.aggregate_fleet(copy.deepcopy(doc))
    assert port.bucket_weights(agg[0]) == repo.bucket_weights(agg[0])
    assert (agg[0]["rate"] is not None) == history
    assert want["tables"]["0"]["moves"]
    assert port.max_observed_spread(want) == repo.max_observed_spread(want)


def test_mvplan_cli_runs_as_the_ports_module(tmp_path):
    """``python -m multiverso_tpu_torch.tools.mvplan --scrape`` with JAX
    and the JAX package blocked writes the repo tool's proposal."""
    import json

    repo, _ = _mvplans()
    doc = _seeded_zipf_fleet()
    scrape = tmp_path / "fleet.json"
    scrape.write_text(json.dumps(doc))
    out = tmp_path / "proposal.json"
    code = textwrap.dedent(f"""
        import runpy, sys
        sys.modules["jax"] = None
        sys.modules["multiverso_tpu"] = None
        sys.argv = ["mvplan", "--scrape", {str(scrape)!r},
                    "--out", {str(out)!r}, "--strict", "--max-spread",
                    "1.1"]
        runpy.run_module("multiverso_tpu_torch.tools.mvplan",
                         run_name="__main__")
    """)
    run = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=REPO)
    assert run.returncode == 1, run.stderr          # --strict alarms
    assert "mvplan: STRICT" in run.stderr
    assert json.loads(out.read_text()) == repo.propose(doc)
