"""The port's serve-tier fleet workers on the CPU: fan-in with its plane
modes and both reactors, skew and capacity (with the port's own
``mvplan``), each a fleet of processes over loopback on the port's own
library build.

The runs and their checks are ``chip_smoke.py``'s ``serve`` phase's
(``serve_fanin``, ``serve_skew``, ``serve_capacity`` and their judges),
at small herds: what the JAX package's demo drivers assert
(``tools/fanin_demo.py``, ``skew_demo.py``, ``capacity_demo.py``) and
bench.py's gated keys, never an overhead or a latency.  Each launch has
its own deadline and is retried on fresh ports when a rank lost its port
to another process.
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
CLIENTS = 64
# tools/fanin_demo.py's gate: at inflight 1 the simultaneous Get burst
# sheds at any herd size (at 64 clients under inflight 8 it may not).
DEMO_INFLIGHT = 1
PLANE_CLIENTS = {"ops": 512, "latency": 64, "audit": 64, "health": 32,
                 "tail": 128}
SIZE = (64, 256, 128)          # clients x rows x requests


@pytest.fixture(scope="module", autouse=True)
def _built():
    nat.ensure_built()


@pytest.mark.parametrize("engine", ["epoll", "uring"])
def test_fanin_accepts_sheds_and_lands_every_faulted_add(engine):
    """Every anonymous connection accepted and served, the overload
    burst shed, and every blocking add under an injected send fault
    landed exactly once (the worker holds the table's final value)."""
    if engine == "uring" and not nat.load().MV_UringSupported():
        pytest.skip("MV_UringSupported() is 0 on this kernel")
    keys, outs = chip_smoke.serve_fanin(CLIENTS, DEMO_INFLIGHT, 1, "",
                                        engine, timeout=DEADLINE_S)
    assert all(f"FANIN_BENCH_OK rank={r}" in o for r, o in enumerate(outs))
    checks, ok = chip_smoke.judge_fanin(keys, CLIENTS, demo=True)
    assert ok, (checks, keys)
    assert keys["busy"] >= 1


@pytest.mark.parametrize("mode", sorted(PLANE_CLIENTS))
def test_fanin_plane_modes(mode):
    """The audit plane names its injected duplicate, the health plane's
    burn-rate alert fires under the seeded apply delay, the latency
    plane's stages add up to >= 0.85 of the end to end, the ops scrape
    runs under the herd, and the tail herd (QoS classes, the gold child,
    hedge and deadline phases) runs to its end."""
    inflight = 0 if mode == "tail" else chip_smoke.SERVE_INFLIGHT
    keys, _ = chip_smoke.serve_fanin(PLANE_CLIENTS[mode], inflight, 0, mode,
                                     "epoll", timeout=DEADLINE_S)
    checks, ok = chip_smoke.judge_serve_plane(mode, keys)
    assert ok, (checks, keys)
    if mode == "tail":
        assert keys["clients"] == PLANE_CLIENTS["tail"]
        assert keys["gold_clients"] == 64


def test_skew_worker_surfaces_hot_keys_and_the_nan_add():
    """zipf(1.0) against uniform row gets: the planted hot keys in the
    top-K, the zipf skew ratio over 3x the control's, and the NaN add's
    ``nan_update`` black box naming its table."""
    keys, box = chip_smoke.serve_skew(*SIZE, nan=1, timeout=DEADLINE_S)
    checks, ok = chip_smoke.judge_skew(keys, box, nan=True)
    assert ok, (checks, keys, box)
    assert keys["hot_hits"] == 5


@pytest.mark.parametrize("ranks,demo", [(2, 0), (3, 1)])
def test_capacity_worker_books_and_mvplan(ranks, demo):
    """The byte books within 10% of the ground truth and the port's
    ``mvplan`` packing the scraped fleet to <= 2x; in the demo mode (3
    ranks, tools/capacity_demo.py) the skewed bucket bytes and load and
    the big table's RSS and arena movement."""
    keys = chip_smoke.serve_capacity(ranks, *SIZE, demo=demo,
                                     timeout=DEADLINE_S)
    checks, ok = chip_smoke.judge_capacity(keys, demo=bool(demo))
    assert ok, (checks, keys)
    assert keys["mvplan_moves"] >= 0
