"""The port's demo workers on the CPU, each a fleet of processes over
loopback on the port's own library build, read by the port's own CLIs.

The runs and their checks are ``chip_smoke.py``'s ``serve`` phase's: the
audit demo's three modes (``tools/audit_demo.py``) with ``mvaudit`` over
the chaos and loss fleets' books, and the doctor, latency and ops demos
driven over stdin as ``tools/doctor_demo.py``, ``tools/latency_demo.py``
and ``tools/ops_demo.py`` drive them, with the port's ``ops.introspect``,
``ops.audit``, ``latency`` and ``tracing`` in place of the JAX package's
and the port's ``mvdoctor``, ``latdoctor`` and ``mvtop`` (each run as a
script with ``jax`` blocked) in place of the repo's.  The doctor fleet's
shutdown is held to its bound.  Each launch has its own deadline and is
retried on fresh ports when a rank lost its port to another process.

The failover workers run in the serve phase on the card's host only:
their 400 ms leases do not hold on a loaded CPU (beside six busy
processes on an 8-core host the bench worker's warm-up add timed out or
the promotion was never seen, in every run, and the interactive demo
worker's warm-up add failed with the lease expired).  Their judges,
``mvaudit --settle`` and ``mvtop --replication`` included, are held on
planted inputs in ``tests/test_torch_chip_smoke.py``.
"""

import importlib.util
import os

import pytest

from multiverso_tpu_torch import native as nat

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(_ROOT, "chip_smoke.py"))
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

DEADLINE_S = 180


@pytest.fixture(scope="module", autouse=True)
def _built():
    nat.ensure_built()


@pytest.mark.parametrize("mode,extra", [
    ("chaos", ("-net_engine=epoll",)), ("chaos", ("-net_engine=tcp",)),
    ("loss", ()), ("plain", ("-audit=false",))],
    ids=["chaos-epoll", "chaos-tcp", "loss", "plain"])
def test_audit_demo_worker(mode, extra):
    """chaos: exactly the two injected duplicates named, no loss, gap or
    unacked stream; loss: the silent discard's gap named, its black box
    fired, the async tail unacked, nothing lost; plain: the adds converge
    on pre-audit frames with the plane reported disarmed."""
    if mode == "plain":
        findings, outs, box = chip_smoke.serve_audit(mode, extra,
                                                     timeout=DEADLINE_S)
    else:
        findings, outs, box, run = chip_smoke.serve_audit_cli(
            mode, extra, timeout=DEADLINE_S)
    checks, ok = chip_smoke.judge_audit(mode, findings, outs, box)
    assert ok, (checks, findings, box)
    if mode == "plain":
        assert findings == []
    else:
        # mvaudit over the fleet's books: the duplicates named exactly
        # (exit 0), or the gap named (exit 1).
        checks, ok = chip_smoke.judge_mvaudit(mode, run, findings)
        assert ok, (checks, run)


def test_doctor_demo_alert_fires_and_resolves():
    """The alert fires and resolves; ``mvdoctor --fleet --strict`` exits
    0 on the quiet fleet, 1 while the page is live and 0 after it
    resolves, its top finding names rank 1's latency SLO burn, and the
    fleet's shutdown ends inside its bound."""
    facts = chip_smoke.serve_doctor_demo(timeout=DEADLINE_S)
    checks, ok = chip_smoke.judge_doctor_demo(facts)
    assert ok, (checks, facts)
    checks, ok = chip_smoke.judge_doctor_cli(facts)
    assert ok, (checks, facts["cli"], facts["shutdown_s"])


def test_latency_demo_names_the_apply_stage():
    facts = chip_smoke.serve_latency_demo(timeout=DEADLINE_S)
    checks, ok = chip_smoke.judge_latency_demo(facts)
    assert ok, (checks, facts)
    assert facts["probes"] == 20
    # latdoctor --fleet: exit 0, every stage on both ranks, the
    # dominant p99 line on each.
    checks, ok = chip_smoke.judge_latdoctor(facts["cli"]["latdoctor"])
    assert ok, (checks, facts["cli"]["latdoctor"])


def test_ops_demo_scrape_blackbox_and_trace():
    facts = chip_smoke.serve_ops_demo(timeout=DEADLINE_S)
    checks, ok = chip_smoke.judge_ops_demo(facts)
    assert ok, (checks, facts)
    assert facts["blackbox_dumped"]
    # mvtop --fleet in each view: exit 0, a row for every rank.
    checks, ok = chip_smoke.judge_mvtop_views(facts["cli"]["mvtop"])
    assert ok, (checks, facts["cli"]["mvtop"])

