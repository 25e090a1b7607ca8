"""The port's runtime context against the JAX package's.

Lifecycle, ids, flags and per-lifecycle kwargs as in ``test_core.py``,
run on both packages (the JAX package on its 8-device CPU mesh, the port
with ``device="cpu"``); the barrier timeout under an injected straggler;
and what only the port has to show: ``init()`` with no device needs a
card, and the host planes (sampling profiler, health evaluator) arm from
their flags and come down at shutdown in the JAX package's order.
"""

import json
import os
import time
from functools import partial
from types import SimpleNamespace

import pytest
import torch


@pytest.fixture()
def tmv():
    """Fresh multiverso_tpu_torch runtime per test (flags, injector,
    dashboard and tracing reset on both sides)."""
    import multiverso_tpu_torch as tmv

    def clean():
        if tmv.initialized():
            tmv.shutdown()
        tmv.config.reset()
        tmv.fault.reset()
        tmv.tracing.disable()
        tmv.tracing.clear()

    clean()
    yield tmv
    clean()


@pytest.fixture(params=["jax", "torch"])
def pkg(request, mv, tmv):
    """One package per case: ``.m`` the module, ``.init`` an init that
    runs on the CPU."""
    request.addfinalizer(mv.fault.reset)
    if request.param == "jax":
        return SimpleNamespace(name="jax", m=mv, init=mv.init)
    return SimpleNamespace(name="torch", m=tmv,
                           init=partial(tmv.init, device="cpu"))


def test_init_shutdown_lifecycle(pkg):
    m = pkg.m
    pkg.init()
    assert m.initialized()
    assert m.workers_num() == 1
    assert m.worker_id() == 0
    assert m.server_id() == 0
    assert m.is_master_worker()
    c0 = m.clock()
    m.barrier()
    assert m.clock() == c0 + 1
    m.shutdown()
    assert not m.initialized()
    m.shutdown()                      # a second shutdown is a no-op


def test_num_replicas_is_one_device_per_process(tmv):
    ctx = tmv.init(device="cpu")
    assert tmv.num_replicas() == 1
    assert ctx.device == torch.device("cpu")
    assert ctx.node.size == 1 and ctx.node.is_worker and ctx.node.is_server


def test_init_idempotent(pkg):
    assert pkg.init() is pkg.init()


def test_flag_parsing(pkg):
    c = pkg.m.config
    rest = c.parse_cmd_flags(
        ["-sync=true", "--updater_type=adagrad", "-port=1234", "positional"])
    assert rest == ["positional"]
    assert c.get("sync") is True
    assert c.get("updater_type") == "adagrad"
    assert c.get("port") == 1234


def test_flags_registry_matches_reference(mv, tmv):
    assert tmv.config.all_flags() == mv.config.all_flags()


def test_init_applies_flags(pkg):
    ctx = pkg.init(args=["-sync=true", "-updater_type=momentum"])
    assert ctx.sync is True
    assert ctx.updater_type == "momentum"


def test_init_kwargs_override_flags(pkg):
    ctx = pkg.init(args=["-sync=true"], sync=False, updater_type="sgd")
    assert ctx.sync is False
    assert ctx.updater_type == "sgd"


def test_unknown_flag_left_in_remainder(pkg):
    assert pkg.m.config.parse_cmd_flags(["-no_such_flag=1"]) == [
        "-no_such_flag=1"]


def test_table_registry(pkg):
    m = pkg.m
    pkg.init()
    t1 = m.ArrayTable(16)
    t2 = m.ArrayTable(32)
    ctx = m.get_context()
    assert t1.table_id != t2.table_id
    assert ctx.table(t1.table_id) is t1
    assert len(ctx.tables()) == 2


def test_init_kwargs_do_not_leak_across_lifecycles(pkg):
    ctx1 = pkg.init(sync=True, updater_type="momentum")
    assert ctx1.sync is True
    pkg.m.shutdown()
    ctx2 = pkg.init()
    assert ctx2.sync is False
    assert ctx2.updater_type == "default"


def test_table_ops_before_init_raise(pkg):
    with pytest.raises(RuntimeError, match="init()"):
        pkg.m.ArrayTable(4)
    with pytest.raises(RuntimeError, match="not initialized"):
        pkg.m.barrier()


def test_init_without_device_needs_a_card(tmv, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tmv.init()
    assert not tmv.initialized()
    ctx = tmv.init(device="cpu")
    assert ctx.device.type == "cpu"


def test_default_device_is_cuda0(tmv, monkeypatch):
    from multiverso_tpu_torch.parallel import sharding

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert sharding.table_mesh() == torch.device("cuda", 0)
    assert sharding.table_mesh("cpu") == torch.device("cpu")


@pytest.mark.parametrize("via", ["kwarg", "flag"])
def test_barrier_timeout_names_the_sync_point(pkg, via):
    """An injected straggler (the barrier seam sleeps past the deadline)
    turns into BarrierTimeout naming the rendezvous — never a hang."""
    m = pkg.m
    pkg.init()
    m.fault.configure(seed=1234,
                      sites={"barrier": {"delay_s": 1.0, "times": 1}})
    kw = {"timeout_s": 0.1}
    if via == "flag":
        m.config.set_flag("barrier_timeout_ms", 100)
        kw = {}
    c0 = m.clock()
    with pytest.raises(m.BarrierTimeout, match="mvtpu_barrier"):
        m.barrier(**kw)
    assert m.clock() == c0           # the clock did not tick
    m.fault.reset()
    m.barrier(timeout_s=5.0)         # a healthy rendezvous still works
    assert m.clock() == c0 + 1


def test_barrier_timeout_dumps_the_black_box(tmv, tmp_path):
    tmv.init(device="cpu", args=[f"-trace_dir={tmp_path}"])
    tmv.fault.configure(sites={"barrier": {"delay_s": 1.0, "times": 1}})
    with pytest.raises(tmv.BarrierTimeout):
        tmv.barrier(timeout_s=0.1)
    with open(tmp_path / "blackbox_rank0.json") as f:
        doc = json.load(f)
    assert doc["reason"].startswith("barrier_timeout")
    assert any(e["kind"] == "lifecycle" for e in doc["events"])


@pytest.mark.parametrize("flags", [["-profile_hz=97"],
                                   ["-metrics_flush_ms=50"],
                                   ["-metrics_flush_ms=50",
                                    "-health_rules=true"]])
def test_unported_planes_raise(tmv, flags, tmp_path):
    """The flag sets that raised before the host planes were ported now
    arm them: ``-profile_hz`` the sampler, ``-metrics_flush_ms`` with
    ``-health_rules`` (on by default) the health evaluator; shutdown
    disarms both and writes the profile into the trace."""
    from multiverso_tpu_torch import health, profiler

    tmv.init(device="cpu", args=flags + [f"-trace_dir={tmp_path}"])
    prof = profiler.active()
    assert (prof is not None) == ("-profile_hz=97" in flags)
    assert (health.evaluator() is not None) == ("-metrics_flush_ms=50"
                                               in flags)
    if prof is not None:
        assert prof.hz == 97
        deadline = time.time() + 5
        while prof.samples == 0 and time.time() < deadline:
            sum(i * i for i in range(10000))
    else:
        ev = health.evaluator()
        assert {r.name for r in ev._rules} == {
            r.name for r in health.default_rules()}
        deadline = time.time() + 5
        while (not any(x.name == "health.alerts.firing"
                       for x in tmv.metrics.REGISTRY.series())
               and time.time() < deadline):
            time.sleep(0.01)
    tmv.shutdown()
    assert profiler.active() is None and health.evaluator() is None
    with open(tmp_path / "trace_rank0.json") as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    assert any(n.startswith("profile:") for n in names) == (prof is not None)
    if prof is None:
        with open(tmp_path / "metrics_rank0.prom") as f:
            assert "health_alerts_firing" in f.read()


def test_shutdown_disarms_the_planes_in_the_jax_order(tmv, tmp_path,
                                                      monkeypatch):
    from multiverso_tpu_torch import health, metrics, profiler, tracing

    tmv.init(device="cpu", args=["-profile_hz=97", "-metrics_flush_ms=50",
                                 "-health_rules=true",
                                 f"-trace_dir={tmp_path}"])
    assert profiler.active() is not None and health.evaluator() is not None
    calls = []
    for mod, name in ((health, "disarm"), (metrics, "stop_flush"),
                      (profiler, "stop"), (tracing, "save")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _r=real, _n=name, **k: (
            calls.append(_n), _r(*a, **k))[1])
    tmv.shutdown()
    assert calls == ["disarm", "stop_flush", "stop", "save"]


def test_metrics_flush_without_health_rules(tmv, tmp_path):
    """The flusher alone is ported: it writes the Prometheus file, with
    the capacity gauges and the table monitors in it."""
    tmv.init(device="cpu", args=["-metrics_flush_ms=20",
                                 "-health_rules=false",
                                 "-serve_cache_entries=4",
                                 f"-trace_dir={tmp_path}"])
    t = tmv.ArrayTable(8, name="flushed")
    t.add([1.0] * 8)
    t.get()
    tmv.shutdown()
    with open(tmp_path / "metrics_rank0.prom") as f:
        text = f.read()
    assert "ArrayTable::Add" in text
    assert "# TYPE capacity_" in text
    assert os.path.exists(tmp_path / "trace_rank0.json")
