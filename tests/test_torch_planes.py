"""The jax-free host planes, run against both packages.

The port's ``slo``, ``health``, ``profiler``, ``latency``,
``serve/wire``, ``ops/audit`` and ``ops/introspect`` are copies of the
JAX package's (held byte for byte by ``test_torch_package.py``).  Here
the pure-Python cases of ``test_health.py``, ``test_latency.py`` and
``test_audit.py`` run once per package, each against that package's own
metrics registry, profiler and flush loop, so a copy that drifted in
behaviour, or a port dependency (``metrics``, ``tracing``, the flight
recorder) that answers differently, fails its own case.
"""

import importlib
import time
from types import SimpleNamespace

import pytest

_MODULES = ("slo", "health", "metrics", "profiler", "latency", "tracing",
            "serve.wire", "ops.audit", "ops.introspect",
            "ops.flight_recorder")


@pytest.fixture(params=["multiverso_tpu", "multiverso_tpu_torch"])
def p(request):
    """One package's plane modules (``p.health``, ``p.wire``, ...), with
    its health plane disarmed and its registry reset around the case."""
    mods = {name.rsplit(".", 1)[-1]: importlib.import_module(
        f"{request.param}.{name}") for name in _MODULES}
    ns = SimpleNamespace(name=request.param, **mods)
    ns.health.disarm()
    ns.metrics.reset()
    yield ns
    ns.health.disarm()
    ns.metrics.stop_flush(final_flush=False)
    ns.profiler.stop(to_trace=False)
    ns.metrics.reset()


# ---------------------------------------------------------------- slo math

def test_budget_and_validation(p):
    assert p.slo.budget(0.999) == pytest.approx(0.001)
    assert p.slo.budget(0.99) == pytest.approx(0.01)
    for bad in (0.0, 1.0, 1.5, -0.1):
        with pytest.raises(ValueError):
            p.slo.budget(bad)


def test_window_delta_and_rate_hand_computed(p):
    pts = [(0.0, 5.0), (5.0, 9.0), (20.0, 10.0)]
    assert p.slo.window_delta(pts, 60.0) == pytest.approx(5.0)
    assert p.slo.window_delta(pts, 10.0) is None
    assert p.slo.window_delta([], 60.0) is None
    assert p.slo.window_delta([(0.0, 10.0), (5.0, 2.0)], 60.0) == 0.0
    assert p.slo.window_rate([(0.0, 0.0), (10.0, 30.0)],
                             60.0) == pytest.approx(3.0)
    assert p.slo.window_rate([(3.0, 1.0)], 60.0) is None
    assert p.slo.window_rate([(5.0, 1.0), (5.0, 9.0)], 60.0) is None


def test_error_fraction_and_burn_rate_hand_computed(p):
    bad = [(0.0, 0.0), (10.0, 10.0)]
    total = [(0.0, 0.0), (10.0, 1000.0)]
    assert p.slo.error_fraction(bad, total, 60.0) == pytest.approx(0.01)
    assert p.slo.burn_rate(bad, total, 0.999, 60.0) == pytest.approx(10.0)
    flat = [(0.0, 7.0), (10.0, 7.0)]
    assert p.slo.error_fraction(bad, flat, 60.0) is None
    assert p.slo.burn_rate(bad, flat, 0.999, 60.0) is None
    worse = [(0.0, 0.0), (10.0, 5000.0)]
    assert p.slo.error_fraction(worse, total, 60.0) == pytest.approx(1.0)


def test_multiwindow_burn_requires_both_windows(p):
    bad = [(0.0, 0.0), (10.0, 10.0)]
    total = [(0.0, 0.0), (10.0, 1000.0)]
    long_b, short_b, firing = p.slo.multiwindow_burn(
        bad, total, 0.999, 5.0, long_s=60.0, short_s=5.0)
    assert long_b == pytest.approx(10.0)
    assert short_b is None and not firing
    bad += [(12.0, 12.0)]
    total += [(12.0, 1200.0)]
    long_b, short_b, firing = p.slo.multiwindow_burn(
        bad, total, 0.999, 5.0, long_s=60.0, short_s=5.0)
    assert short_b == pytest.approx(10.0) and firing
    long_b, short_b, firing = p.slo.multiwindow_burn(
        bad[:2], total[:2], 0.999, 5.0, long_s=60.0, short_s=0.0)
    assert firing and short_b == long_b


# ---------------------------------------------------------------- rules

def test_rule_validation_and_the_default_pack(p):
    with pytest.raises(ValueError):
        p.health.Rule(name="r", metric="m", op="gt")
    with pytest.raises(ValueError):
        p.health.Rule(name="r", metric="m", op="rate_gt", severity="fatal")
    with pytest.raises(ValueError):
        p.health.Rule(name="r", metric="m", op="burn_rate_gt")
    rules = p.health.default_rules()
    assert {"lat-p99", "lat-slo-burn", "audit-gap", "rss-growth",
            "hb-missed"} <= {r.name for r in rules}
    for r in rules:
        assert r.op in p.health.RULE_OPS
        assert r.severity in p.health.SEVERITIES


def _feed_counter(reg, counter, samples):
    prev = counter._value
    for ts, v in samples:
        counter.inc(v - prev)
        prev = v
        reg.record_history(now=ts)


def test_counter_delta_rule_fires_and_resolves(p):
    reg = p.metrics.Registry()
    c = reg.counter("t.err")
    rule = p.health.Rule(name="r", metric="t.err", op="counter_delta_gt",
                         threshold=5.0, window_s=60.0)
    ev = p.health.HealthEvaluator([rule], registry=reg)
    _feed_counter(reg, c, [(0.0, 0.0), (10.0, 20.0)])
    assert ev.evaluate(now=10.0) == [{"rule": "r", "to": "firing",
                                      "severity": "warning", "value": 20.0}]
    assert p.metrics.gauge("health.alerts.firing",
                           {"severity": "warning"}).value == 1.0
    _feed_counter(reg, c, [(70.0, 20.0), (80.0, 20.0)])
    assert ev.evaluate(now=80.0) == [{"rule": "r", "to": "resolved",
                                      "severity": "warning", "value": 0.0}]
    (a,) = ev.snapshot()
    assert a["state"] == "ok" and a["resolved"] == 1


def test_for_s_hysteresis_shows_pending_churn_only(p):
    reg = p.metrics.Registry()
    ev = p.health.HealthEvaluator(
        [p.health.Rule(name="up", metric="t.up", op="absent", for_s=30.0)],
        registry=reg)
    ev.evaluate(now=0.0)
    assert ev.snapshot()[0]["state"] == "pending"
    reg.gauge("t.up").set(1.0)
    ev.evaluate(now=10.0)
    assert ev.snapshot()[0]["state"] == "ok"
    reg.remove("t.up")
    ev.evaluate(now=20.0)
    ev.evaluate(now=45.0)
    assert ev.snapshot()[0]["state"] == "pending"
    ev.evaluate(now=51.0)
    a = ev.snapshot()[0]
    assert a["state"] == "firing" and a["fired"] == 1


def test_no_data_keeps_firing_but_resets_pending(p):
    reg = p.metrics.Registry()
    c = reg.counter("t.err")
    ev = p.health.HealthEvaluator([
        p.health.Rule(name="f", metric="t.err", op="counter_delta_gt",
                      threshold=5.0, window_s=60.0),
        p.health.Rule(name="p", metric="t.err", op="counter_delta_gt",
                      threshold=5.0, for_s=100.0, window_s=60.0)],
        registry=reg)
    _feed_counter(reg, c, [(0.0, 0.0), (10.0, 20.0)])
    ev.evaluate(now=10.0)
    reg.reset()
    assert ev.evaluate(now=20.0) == []
    by = {a["rule"]: a for a in ev.snapshot()}
    assert by["f"]["state"] == "firing" and by["f"]["value"] is None
    assert by["p"]["state"] == "ok"


def test_burn_rate_rule_matches_hand_computed_math(p):
    reg = p.metrics.Registry()
    bad, total = reg.counter("t.breach"), reg.counter("t.total")
    for ts, b, t in [(0.0, 0.0, 0.0), (10.0, 10.0, 1000.0),
                     (12.0, 12.0, 1200.0)]:
        bad.inc(b - bad._value)
        total.inc(t - total._value)
        reg.record_history(now=ts)
    ev = p.health.HealthEvaluator([p.health.Rule(
        name="burn", metric="t.breach", op="burn_rate_gt",
        total_metric="t.total", objective=0.999, threshold=5.0,
        window_s=60.0, short_window_s=5.0)], registry=reg)
    assert [t["to"] for t in ev.evaluate(now=12.0)] == ["firing"]
    want = p.slo.burn_rate(reg.history("t.breach"), reg.history("t.total"),
                           0.999, 60.0)
    assert ev.snapshot()[0]["value"] == pytest.approx(want) == 10.0


def test_critical_alert_boosts_profiler_and_restores(p):
    reg = p.metrics.Registry()
    ev = p.health.HealthEvaluator([p.health.Rule(
        name="crit", metric="t.up", op="absent", severity="critical")],
        registry=reg)
    ev.evaluate(now=0.0)
    prof = p.profiler.active()
    assert prof is not None and prof.hz == p.health.BOOST_HZ
    assert any(e["kind"] == "alert_fired" and e["detail"] == "crit"
               for e in p.flight_recorder.recorder.events())
    reg.gauge("t.up").set(1.0)
    ev.evaluate(now=1.0)
    assert ev.snapshot()[0]["state"] == "ok"
    assert p.profiler.active() is None


def test_arm_wires_the_flush_loop_and_disarm_unwires(p):
    assert p.health.alerts_doc()["armed"] is False
    p.health.arm(rules=[p.health.Rule(name="up", metric="t.up",
                                      op="absent")])
    ev2 = p.health.arm(rules=[p.health.Rule(name="up", metric="t.up",
                                            op="absent")])
    assert p.health.evaluator() is ev2
    with p.metrics._HOOK_LOCK:
        assert len(p.metrics._FLUSH_HOOKS) == 1
    p.metrics.start_flush(20)
    deadline = time.time() + 5
    doc = p.health.alerts_doc()
    while time.time() < deadline and not doc["firing"]:
        time.sleep(0.02)
        doc = p.health.alerts_doc()
    assert doc["armed"] and doc["rules"] == 1 and doc["firing"] == 1
    p.health.disarm()
    assert p.health.alerts_doc() == {"armed": False, "rules": 0,
                                     "firing": 0, "alerts": []}
    with p.metrics._HOOK_LOCK:
        assert len(p.metrics._FLUSH_HOOKS) == 0


def test_history_ring_capped_and_recapped(p):
    c = p.metrics.counter("t.n")
    p.metrics.set_history_depth(4)
    for i in range(10):
        c.inc()
        p.metrics.record_history(now=float(i))
    assert p.metrics.history("t.n") == [(6.0, 7.0), (7.0, 8.0), (8.0, 9.0),
                                        (9.0, 10.0)]
    p.metrics.set_history_depth(2)
    assert p.metrics.history("t.n") == [(8.0, 9.0), (9.0, 10.0)]
    p.metrics.set_history_depth(1)
    assert p.metrics.REGISTRY.history_depth == 2


# ------------------------------------------------------------ the profiler

def test_profiler_folds_stacks_into_the_trace(p):
    p.tracing.enable(rank=0)
    try:
        prof = p.profiler.start(997)
        deadline = time.time() + 5
        while time.time() < deadline and prof.samples < 5:
            sum(i * i for i in range(20000))
        assert p.profiler.stop(to_trace=True) is prof
        spans = [e for e in p.tracing.events()
                 if e.name.startswith("profile:")]
        assert spans and all(e.args["plane"] == "profiler/python"
                             for e in spans)
        folded = "\n".join(f"{k} {v}" for k, v in prof.folded().items())
        assert p.profiler.parse_folded(folded) == prof.folded()
    finally:
        p.tracing.disable()
        p.tracing.clear()


# ----------------------------------------------------- the latency plane

def test_record_stages_and_dominant_stage(p):
    p.latency.record_stages({"queue": 1e-4, "apply": 5e-3, "total": 6e-3})
    snap = p.metrics.snapshot()
    assert snap["lat.stage.apply"]["count"] == 1
    assert snap["lat.total"]["count"] == 1
    report = {"stages": {"apply": {"p99_ms": 25.0, "p50_ms": 20.0},
                         "wire_out": {"p99_ms": 1.0, "p50_ms": 0.5}},
              "total": {"p99_ms": 26.5, "p50_ms": 21.0, "p95_ms": 25.0,
                        "count": 9}}
    assert p.latency.dominant_stage(report) == "apply"
    assert p.latency.dominant_stage(report, "p50_ms") == "apply"
    assert p.latency.dominant_stage({"stages": {}}) is None
    assert set(p.latency.stage_summary(report)) == {"apply", "wire_out",
                                                    "total"}


# -------------------------------------------------------------- the wire

@pytest.mark.parametrize("timing,audit", [(False, None), (True, (3, 9))])
def test_frame_pack_decode_round_trip(p, timing, audit):
    w = p.wire
    frame = w.pack_frame(w.MSG["RequestGet"], 4, 7, blobs=[b"payload8"],
                         timing=timing, audit=audit)
    dec = w.FrameDecoder()
    for i in range(0, len(frame), 5):          # dribbled in pieces
        assert dec.next_frame() is None
        dec.feed(frame[i:i + 5])
    msg = w.unpack_frame(dec.next_frame())
    assert dec.next_frame() is None
    assert (msg["type"], msg["table_id"], msg["msg_id"]) == (
        w.MSG["RequestGet"], 4, 7)
    assert msg["blobs"] == [b"payload8"] and msg["audit"] == audit
    assert (msg["timing"] is not None) == timing
    dec.feed(b"\xff" * 8)                     # a negative length
    with pytest.raises(ConnectionError):
        dec.next_frame()


def test_stage_math_and_offsets(p):
    w, ms = p.wire, 1_000_000
    trail = (10 * ms, 11 * ms, 18 * ms, 19 * ms, 22 * ms, 23 * ms)
    stages = w.stage_durations(trail, 20 * ms, offset_ns=5 * ms)
    assert stages["apply"] == pytest.approx(3e-3)
    assert stages["total"] == pytest.approx(10e-3)
    off, rtt = w.ntp_sample((0, 10 * ms, 18 * ms, 0, 0, 20 * ms), 14 * ms)
    assert (off, rtt) == (7 * ms, 2 * ms)
    est = w.OffsetEstimator(window=4)
    for o, r in ((100, 50), (999, 400), (105, 60)):
        est.update(o, r)
    assert (est.offset_ns, est.rtt_ns, est.samples) == (100, 50, 3)


# ------------------------------------------------------------- the audit

def _origin(origin, watermark, **kw):
    base = {"origin": origin, "watermark": watermark, "applied": 0,
            "covered": 0, "dups": 0, "reorders": 0,
            "pending_dropped": 0, "pending": [], "gap_fired": False}
    base.update(kw)
    return base


def _table(origins=(), shards=None, anomalies=()):
    t = {"id": 0, "server": {"origins": list(origins),
                             "anomalies": list(anomalies),
                             "anomaly_total": len(anomalies)}}
    if shards is not None:
        t["worker"] = {"shards": [{"shard": 0, "sent": s, "acked": a}
                                  for s, a in shards]}
    return t


def _fleet(ranks, silent=()):
    return {"ranks": {str(r): {"rank": r, "armed": True, "tables": [t]}
                      for r, t in ranks.items()}, "silent": list(silent)}


def test_diff_fleet_findings(p):
    a = p.audit
    clean = _fleet({0: _table([_origin(1, 7), _origin(0, 5)], [(5, 5)]),
                    1: _table([], [(7, 7)])})
    assert a.diff_fleet(clean) == []
    lost = a.diff_fleet(_fleet({0: _table([_origin(1, 4)]),
                                1: _table([], [(9, 9)])}))
    assert lost[0]["kind"] == "lost"
    assert (lost[0]["seq_lo"], lost[0]["seq_hi"]) == (5, 9)
    tail = a.diff_fleet(_fleet({0: _table([_origin(1, 3)]),
                                1: _table([], [(8, 3)])}))
    assert [f["kind"] for f in tail] == ["unacked"]
    dup = [{"kind": "dup", "origin": 1, "seq_lo": 4, "seq_hi": 4,
            "ts_ms": 1}]
    kinds = {f["kind"] for f in a.diff_fleet(_fleet(
        {0: _table([_origin(1, 3, dups=1, pending=[[6, 7]],
                            gap_fired=True)], anomalies=dup)},
        silent=[2]))}
    assert {"dup", "gap", "silent"} <= kinds


def test_audit_rows_and_checksum_divergence(p):
    a = p.audit
    rows = {r["origin"]: r for r in a.audit_rows(_fleet(
        {0: _table([_origin(1, 4), _origin(9, 2)]),
         1: _table([], [(6, 6)])}))}
    assert rows[1]["acked"] == 6 and rows[1]["lag"] == 2
    assert rows[9]["acked"] is None and rows[9]["lag"] is None
    assert a.checksum_divergence([1, 2, 3], [1, 9, 3]) == [1]
    assert a.checksum_divergence([1], [1, 2]) == [0, 1]


# ---------------------------------------------------------- introspection

def test_parse_prometheus_reads_the_packages_own_rendering(p):
    hostile = 'a"b\\c\nd}e'
    p.metrics.gauge("t.esc", {"path": hostile}).set(7.0)
    p.metrics.counter("t.hits").inc(3)
    h = p.metrics.histogram("t.lat")
    for v in (1e-3, 2e-3, 4e-3):
        h.observe(v)
    values, _ = p.introspect.parse_prometheus(
        p.metrics.REGISTRY.render_prometheus())
    (key,) = [k for k in values if k.startswith("t_esc{")]
    assert 'd}e"' in key and values[key] == 7.0
    assert any(k.startswith("t_hits") and v == 3.0
               for k, v in values.items())
    assert any(k.startswith("t_lat_count") and v == 3.0
               for k, v in values.items())
