"""The latency SLO's burn-rate rule sees a burst of breaches that lands
between two metric flushes.

The health plane reads the ``lat.slo.breach`` / ``lat.slo.total``
counters through their history rings, one point a flush, and a window's
delta needs two in-window points.  A breach counter made by the first
breach has no point before it, so a first faulted burst whose requests
all land between two flushes would read as no breach at all (the doctor
demo's alert then stayed quiet after its faulted burst in some runs).
The port makes the breach counter with the total counter, at the first
scored round trip; the JAX package keeps making it at the first breach.
"""

import pytest

from multiverso_tpu_torch import config, latency, metrics, slo
from multiverso_tpu_torch.apps.doctor_demo_worker import (SLO_MS,
                                                          demo_rules)


@pytest.fixture
def slo_armed():
    metrics.reset()
    config.set_flag("health_latency_slo_ms", SLO_MS)
    try:
        yield
    finally:
        config.reset()
        metrics.reset()


@pytest.mark.parametrize("healthy", [1, 10])
def test_a_breach_burst_between_two_flushes_burns(slo_armed, healthy):
    """Healthy round trips, flushes, then a burst of breaches between
    two flushes: the doctor demo's rule fires at the next flush."""
    rule = demo_rules()[0]
    fast, slow = SLO_MS / 2e3, SLO_MS * 2.5 / 1e3
    for _ in range(healthy):
        latency.record_stages({"total": fast})
    t = 0.0
    for t in (0.25, 0.5, 0.75):
        metrics.record_history(now=t)
    for _ in range(10):
        latency.record_stages({"total": slow})
    metrics.record_history(now=t + 0.25)
    long_burn, short_burn, firing = slo.multiwindow_burn(
        metrics.history(rule.metric), metrics.history(rule.total_metric),
        rule.objective, rule.threshold, rule.window_s, rule.short_window_s)
    assert firing, (long_burn, short_burn)
    # The windows hold every round trip scored since the counters were
    # made: the total counter's ring starts from a zero point, so the
    # healthy round trips before the first flush count beside the burst.
    assert long_burn == pytest.approx(10 / (10 + healthy)
                                      / (1 - rule.objective))
    assert metrics.history(rule.metric)[0] == (0.25, 0.0)


def test_healthy_traffic_alone_never_burns(slo_armed):
    rule = demo_rules()[0]
    for t in (0.25, 0.5):
        latency.record_stages({"total": SLO_MS / 2e3})
        metrics.record_history(now=t)
    long_burn, _, firing = slo.multiwindow_burn(
        metrics.history(rule.metric), metrics.history(rule.total_metric),
        rule.objective, rule.threshold, rule.window_s, rule.short_window_s)
    assert not firing and long_burn == 0.0
