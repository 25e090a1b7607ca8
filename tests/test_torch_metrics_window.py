"""A counting series' first increments are in every history window.

The metrics registry records one ``(ts, value)`` point a series each
flush, and every windowed reader (``delta``, ``rate``, the health
plane's ``counter_delta_gt``, ``rate_gt`` and ``burn_rate_gt``) needs
two points in its window.  A counter made lazily, by its first
increment, got its first point at the next flush, so the whole burst
that made it fell in no window.  The port's registry starts such a
series' first ring with a zero point stamped at the series' creation;
the JAX package's does not.

The flushes here take the registry's own clock, ``time.monotonic()``,
the one it stamps a series' creation with.  A caller that passes its
own ``now`` gets the zero point at that first point's time.
"""

import time

import pytest

from multiverso_tpu_torch import health, metrics


def _flush(reg, ev=None):
    """One flush: a history point for every series, then the rules."""
    reg.record_history()
    return ev.evaluate() if ev is not None else None


@pytest.fixture
def reg():
    r = metrics.Registry()
    r.counter("t.other").inc()      # a series that exists from the start
    _flush(r)
    return r


def test_counter_made_between_flushes_shows_in_delta_and_rate(reg):
    made = time.monotonic()
    reg.counter("t.burst").inc(5)
    _flush(reg)
    (t0, v0), (t1, v1) = reg.history("t.burst")
    assert (v0, v1) == (0.0, 5.0) and made <= t0 < t1
    assert reg.delta("t.burst") == 5.0
    assert reg.rate("t.burst") == pytest.approx(5.0 / (t1 - t0))


def test_histogram_count_made_between_flushes_shows_in_rate(reg):
    h = reg.histogram("t.lat")
    for v in (0.001, 0.002, 0.004):
        h.observe(v)
    _flush(reg)
    assert reg.delta("t.lat_count") == 3.0
    assert reg.delta("t.lat_sum") == pytest.approx(0.007)
    assert reg.rate("t.lat_count") > 0.0


@pytest.mark.parametrize("op", ["counter_delta_gt", "rate_gt"])
def test_rule_fires_on_a_lazy_counters_first_burst(reg, op):
    rule = health.Rule(name="r", metric="t.err", op=op, threshold=0.5,
                       window_s=3600.0)
    ev = health.HealthEvaluator([rule], registry=reg)
    assert _flush(reg, ev) == []            # t.err does not exist yet
    reg.counter("t.err").inc(20)
    (fired,) = _flush(reg, ev)
    assert fired["rule"] == "r" and fired["to"] == "firing"
    assert fired["value"] > 0.5


def test_burn_rule_fires_on_a_lazy_breach_counters_first_burst(reg):
    total = reg.counter("t.total")
    total.inc(100)
    rule = health.Rule(name="burn", metric="t.breach", op="burn_rate_gt",
                       total_metric="t.total", objective=0.99,
                       threshold=2.0, window_s=3600.0, short_window_s=1800.0)
    ev = health.HealthEvaluator([rule], registry=reg)
    assert _flush(reg, ev) == []            # healthy: no breach counter
    total.inc(10)
    reg.counter("t.breach").inc(10)         # made by the first breach
    (fired,) = _flush(reg, ev)
    assert fired["to"] == "firing"
    # The breach counter's 10 over the total's 110 since it was made.
    assert fired["value"] == pytest.approx(10 / 110 / 0.01)


def test_untouched_counter_still_reads_no_data(reg):
    reg.counter("t.idle")
    rule = health.Rule(name="idle", metric="t.idle", op="counter_delta_gt",
                       threshold=0.0, window_s=3600.0)
    ev = health.HealthEvaluator([rule], registry=reg)
    _flush(reg, ev)
    assert len(reg.history("t.idle")) == 1
    assert reg.delta("t.idle") == 0.0 and reg.rate("t.idle") is None
    assert ev.snapshot()[0]["value"] is None


def test_gauges_get_no_zero_point(reg):
    reg.gauge("t.depth").set(7.0)
    _flush(reg)
    assert [v for _, v in reg.history("t.depth")] == [7.0]
    assert reg.rate("t.depth") is None


def test_zero_point_on_a_callers_clock_ahead_of_monotonic(reg):
    """A caller's clock (wall time, far ahead of the monotonic one) puts
    the zero point at its own first point, not at the series' monotonic
    creation, so a rate over the whole ring is not diluted toward 0."""
    t0 = time.time() + 1e6
    c = reg.counter("t.wall")
    c.inc(4)
    reg.record_history(now=t0)
    c.inc(4)
    reg.record_history(now=t0 + 2.0)
    assert reg.history("t.wall") == [(t0, 0.0), (t0, 4.0), (t0 + 2.0, 8.0)]
    assert reg.delta("t.wall", n=2) == 8.0
    assert reg.rate("t.wall") == pytest.approx(4.0)
