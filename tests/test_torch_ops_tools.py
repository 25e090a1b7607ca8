"""The port's operator CLIs (``multiverso_tpu_torch/tools/{latdoctor,
mvaudit,mvdoctor,mvtop}.py``) against the repo's ``tools/`` originals.

The JAX package's canned-scrape cases (``tests/test_capacity.py``,
``test_failover.py``, ``test_health.py``, ``test_audit.py``) go through
both packages' CLIs and must give the same rows, text, findings and
exit codes.  Whole CLI runs read canned fleet scrapes through
``chip_smoke.ScrapeReplay``, a loopback endpoint speaking the anonymous
ops wire, so each CLI's argument parsing, wire client, rendering and
exit code run as an operator's would.  Each port CLI also runs as
``python -m multiverso_tpu_torch.tools.<name>`` and as a script by its
path from another directory, with ``jax`` and the JAX package blocked.
"""

import contextlib
import copy
import importlib
import importlib.util
import io
import json
import os
import re
import subprocess
import sys
import textwrap

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLIS = ("latdoctor", "mvaudit", "mvdoctor", "mvtop")

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)


def _pair(name):
    """The repo's ``tools/<name>.py`` (it imports the JAX package) and
    the port's copy, loaded without leaving a path entry behind."""
    spec = importlib.util.spec_from_file_location(
        f"repo_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    repo = importlib.util.module_from_spec(spec)
    path = copy.copy(sys.path)
    try:
        spec.loader.exec_module(repo)
        port = importlib.import_module(f"multiverso_tpu_torch.tools.{name}")
    finally:
        sys.path[:] = path
    return repo, port


def _both(name):
    return dict(zip(("repo", "port"), _pair(name)))


def _unstamped(text):
    return re.sub(r"@ \d\d:\d\d:\d\d", "@ T", text)


def _main(mod, argv):
    """``mod.main(argv)``'s exit code and standard output."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = mod.main(argv)
    return rc, _unstamped(out.getvalue())


# ------------------------------------------------- canned scrapes

# tests/test_capacity.py's canned rank.
_CANNED_RANK = {
    "rank": 0, "armed": True, "server_id": 0, "servers": 2,
    "proc": {"rss_bytes": 50_000_000, "vm_hwm_bytes": 60_000_000,
             "open_fds": 33, "uptime_s": 4.2},
    "arena": {"buffers": 2, "free_buffers": 1, "bytes": 1 << 20,
              "in_flight": 0, "deferred": 3},
    "net": {"engine": "epoll", "writeq_bytes": 4096},
    "gauges": {"host_arena.bytes": 1 << 20},
    "tables": [{"id": 0,
                "shard": {"resident_bytes": 8192, "rows": 64,
                          "gets": 100, "adds": 50,
                          "bucket_bytes": [128] * 64,
                          "bucket_gets": [1] * 64,
                          "bucket_adds": [1] * 64},
                "history": {"windows": 0, "curve": []},
                "worker": {"agg_bytes": 256, "replica_rows": 5,
                           "replica_bytes": 1000}}]}

# tests/test_failover.py's replication scrape: rank 1 dead, shard 1
# promoted on rank 2.
_REPL = {"ranks": {
    "0": {"rank": 0, "armed": True, "sync": True, "epoch": 1026,
          "backup_shard": 2, "owners": [0, 2, 2], "backups": [-1, -1, 0],
          "promoted": [], "outstanding": 1,
          "stats": {"forwards": 9, "acks": 8, "applied": 4,
                    "promotions": 0, "epoch_flips": 1,
                    "dup_skips": 0, "catchups": 0}},
    "2": {"rank": 2, "armed": True, "sync": True, "epoch": 1026,
          "backup_shard": 1, "owners": [0, 2, 2], "backups": [-1, -1, 0],
          "promoted": [1], "outstanding": 0,
          "stats": {"forwards": 3, "acks": 3, "applied": 9,
                    "promotions": 1, "epoch_flips": 0,
                    "dup_skips": 2, "catchups": 0}},
}, "silent": [1]}

# tests/test_health.py's alert scrape and doctor planes.
_ALERTS = {"silent": [1], "ranks": {"0": {
    "rank": 0,
    "host": {"alerts": [
        {"rule": "b", "severity": "warning", "state": "ok",
         "value": None, "age_s": 4.0},
        {"rule": "a", "severity": "critical", "state": "firing",
         "value": 12.25, "age_s": 2.0}]},
    "watchdog": []}}}

_PLANES = {
    "alerts": {"ranks": {"1": {"rank": 1, "host": {"alerts": [
        {"rule": "lat-slo-burn", "severity": "critical",
         "state": "firing", "value": 40.0, "age_s": 3.0}]},
        "watchdog": []}}},
    "latency": {"ranks": {"1": {"rank": 1, "stages": {
        "apply": {"p99_ms": 25.0}, "net": {"p99_ms": 0.2}},
        "total": {"p99_ms": 25.4}}}},
    "hotkeys": {"ranks": {"1": [
        {"id": 0, "gets": 1000, "skew_ratio": 9.0,
         "hotkeys": {"topk": [{"key": 3, "count": 100}]}}]}},
    "audit": {}, "capacity": {},
}


def _origin(origin, watermark, **kw):
    """tests/test_audit.py's server-side origin book."""
    base = {"origin": origin, "watermark": watermark, "applied": 0,
            "covered": 0, "dups": 0, "reorders": 0,
            "pending_dropped": 0, "pending": [], "gap_fired": False}
    base.update(kw)
    return base


def _audit_fleet(case):
    """A two-rank fleet audit scrape: origin 1 acked 6 adds into shard 0
    whose book shows ``case``."""
    server = {"clean": _origin(1, 6),
              "dup": _origin(1, 6, dups=2),
              "gap": _origin(1, 6, reorders=2, gap_fired=True,
                             pending=[[8, 9]]),
              "lost": _origin(1, 4)}[case]
    anomalies = ([{"kind": "dup", "origin": 1, "seq_lo": 4, "seq_hi": 4},
                  {"kind": "dup", "origin": 1, "seq_lo": 5, "seq_hi": 5}]
                 if case == "dup" else [])
    return {"ranks": {
        "0": {"rank": 0, "armed": True, "tables": [
            {"id": 0, "server": {"origins": [server],
                                 "anomalies": anomalies,
                                 "anomaly_total": len(anomalies)},
             "checksums": [0xdeadbeef, 7]}]},
        "1": {"rank": 1, "armed": True, "tables": [
            {"id": 0, "worker": {"shards": [{"shard": 0, "sent": 6,
                                             "acked": 6}]},
             "server": {"origins": [_origin(0, 0)], "anomalies": [],
                        "anomaly_total": 0}}]}},
        "silent": []}


def _stages(apply_p99, count):
    return {s: {"p50_ms": 0.01 * (i + 1), "p95_ms": 0.02 * (i + 1),
                "p99_ms": apply_p99 if s == "apply" else 0.05 * (i + 1),
                "count": count, "exemplar_p99": "0x2000000003c"}
            for i, s in enumerate(chip_smoke.LATENCY_STAGES)}


_LATENCY = {"ranks": {
    "0": {"rank": 0, "armed": True, "stages": _stages(0.02, 40),
          "total": {"p50_ms": 0.07, "p95_ms": 0.17, "p99_ms": 0.24,
                    "count": 40},
          "offsets": [{"rank": 1, "offset_ns": -9200, "rtt_ns": 63800,
                       "samples": 20}],
          "profiler": {"running": True, "hz": 97, "samples": 1},
          "qos": {"classes": [
              {"name": "gold", "weight": 8, "budget": 4, "inflight": 0,
               "admits": 120, "sheds": 0, "deadline_sheds": 0},
              {"name": "bulk", "weight": 1, "budget": 0, "inflight": 2,
               "admits": 40, "sheds": 9, "deadline_sheds": 9}],
              "cancelled": 3}},
    "1": {"rank": 1, "armed": True, "stages": _stages(25.57, 123),
          "total": {"p50_ms": 0.29, "p95_ms": 29.25, "p99_ms": 32.61,
                    "count": 123},
          "offsets": [], "profiler": {"running": False},
          "qos": {"classes": [
              {"name": "gold", "weight": 8, "budget": 4, "inflight": 1,
               "admits": 80, "sheds": 0, "deadline_sheds": 0}],
              "cancelled": 0}}},
    "silent": []}

_HEALTH = {"ranks": {
    "0": {"rank": 0, "healthy": True, "engine": "epoll",
          "serve_queue_depth": 2, "server_inflight_max": 64, "clients": 3,
          "client_shed": 1, "dead_peers": [], "blackbox_triggers": 0},
    "1": {"rank": 1, "healthy": False, "engine_requested": "uring",
          "engine": "epoll", "engine_fallback": True,
          "serve_queue_depth": 0, "server_inflight_max": 64,
          "clients": 0, "client_shed": 0, "dead_peers": [0],
          "blackbox_triggers": 2}},
    "silent": [], "dead": ["1"]}

_TABLES = {"ranks": {
    "0": [{"id": 0, "version": 7, "gets": 10, "adds": 4, "agg_pending": 1}],
    "1": [{"id": 0, "version": 9, "gets": 2, "adds": 1}]}}

_HOTKEYS = {"ranks": {
    "0": [{"id": 0, "gets": 1000, "adds": 10, "skew_ratio": 9.0,
           "staleness_mean": 1.5, "nan_count": 0, "inf_count": 1,
           "hotkeys": {"topk": [{"key": 3, "count": 100},
                                {"key": 5, "count": 40}]}},
          {"id": 1}],
    "1": [{"id": 0, "gets": 20, "adds": 0, "skew_ratio": 1.1,
           "hotkeys": {"topk": []}}]}}

_METRICS = ('mv_ops_rank_up{rank="0"} 1\nmv_ops_rank_up{rank="1"} 1\n'
            'native_net_bytes_recv_count{rank="0"} 12\n')

# A fleet's scrape by report kind, as the replay serves it.
FLEET = {"health": _HEALTH, "tables": _TABLES, "hotkeys": _HOTKEYS,
         "latency": _LATENCY, "audit": _audit_fleet("dup"),
         "replication": _REPL,
         "capacity": {"ranks": {"0": _CANNED_RANK}, "silent": [1]},
         "alerts": _ALERTS}


def _replay(reports):
    return chip_smoke.ScrapeReplay(
        {k: v if isinstance(v, str) else json.dumps(v)
         for k, v in reports.items()})


# ---------------------------------------- the JAX tests' canned cases

def test_capacity_rows_and_rates_match():
    """tests/test_capacity.py's mvtop case: capacity rows with a dead
    rank's placeholders, the rendered table, and the two-scrape growth
    columns ('-' before the first baseline)."""
    m = _both("mvtop")
    got = {}
    for side, mod in m.items():
        rows = mod.capacity_rows({"0": _CANNED_RANK, "1": None})
        tracker = mod.RateTracker()
        first = mod.capacity_rows({"0": _CANNED_RANK}, tracker=tracker,
                                  now=100.0)
        grown = json.loads(json.dumps(_CANNED_RANK))
        grown["tables"][0]["shard"]["resident_bytes"] = 8192 + 2000
        grown["proc"]["rss_bytes"] = 50_000_000 + 10_000_000
        second = mod.capacity_rows({"0": grown}, tracker=tracker,
                                   now=102.0)
        got[side] = (rows, mod.render(rows, mod._CAP_COLS), first, second,
                     mod.render(second, mod._CAP_COLS + mod._CAP_RATE_COLS))
    assert got["port"] == got["repo"]
    rows, _, first, second, _ = got["port"]
    assert rows[0]["res_bytes"] == 8192 and rows[1]["res_bytes"] == "-"
    assert first[0]["b/s"] == "-" and second[0]["b/s"] == "1000.0"
    assert second[0]["rss/s"] == "5000000.0"


def test_replication_rows_match():
    """tests/test_failover.py's replication scrape: the epoch, the
    promoted shard on rank 2 and the silent rank."""
    m = _both("mvtop")
    got = {s: (mod.repl_rows(_REPL), mod.render(mod.repl_rows(_REPL),
                                                mod._REPL_COLS))
           for s, mod in m.items()}
    assert got["port"] == got["repo"]
    by_rank = {r["rank"]: r for r in got["port"][0]}
    assert by_rank["2"]["promoted"] == "1" and by_rank[1]["armed"] == "SILENT"


def test_alert_rows_and_stale_rendering_match():
    """tests/test_health.py's alert view: firing above unknown above ok,
    the firing counts, and the stale watch rendering."""
    m = _both("mvtop")
    got = {s: (mod.alert_view_rows(_ALERTS), mod.firing_counts(_ALERTS),
               _unstamped(mod.render_stale("r1\nr2", OSError("down"))))
           for s, mod in m.items()}
    assert got["port"] == got["repo"]
    rows, counts, stale = got["port"]
    assert [(r["rank"], r["rule"], r["state"]) for r in rows] == [
        ("0", "a", "firing"), ("1", "-", "unknown"), ("0", "b", "ok")]
    assert counts == {"0": 1, "1": "?"} and stale.count("stale") == 2


def test_mvdoctor_diagnose_and_render_match():
    """tests/test_health.py's doctor planes: the top finding blames rank
    1's latency SLO burn on the apply stage, with the hot table."""
    m = _both("mvdoctor")
    got = {s: mod.diagnose(copy.deepcopy(_PLANES)) for s, mod in m.items()}
    assert got["port"] == got["repo"]
    top = got["port"][0]
    assert (top["severity"], top["rank"]) == ("critical", "1")
    assert "'apply'" in top["title"]
    text = m["port"].render(got["port"])
    assert text == m["repo"].render(got["repo"])
    assert "[critical] rank 1" in text


def test_rate_tracker_dash_then_rate_match():
    """tests/test_audit.py's rate discipline: '-' until two scrapes."""
    m = _both("mvtop")
    got = {}
    for s, mod in m.items():
        tracker = mod.RateTracker()
        got[s] = (tracker.update("0/0/1", {"dups": 10}, now=100.0),
                  tracker.update("0/0/1", {"dups": 30}, now=110.0))
    assert got["port"] == got["repo"]
    assert got["port"][0].get("dup/s", "-") == "-"
    assert got["port"][1]["dup/s"] == "2.0"


def test_latdoctor_render_and_deadline_note_match():
    m = _both("latdoctor")
    for rank, rep in _LATENCY["ranks"].items():
        want = m["repo"].render_rank(rank, rep)
        assert m["port"].render_rank(rank, rep) == want
        assert (m["port"].deadline_note(rep)
                == m["repo"].deadline_note(rep))
    assert "dominant p99 stage = apply" in want
    assert "deadline sheds dominate class 'bulk'" in (
        m["port"].deadline_note(_LATENCY["ranks"]["0"]))


def test_kind_views_cover_the_ports_ops_kinds():
    """Every report kind of the port's ops wire has an mvtop view, and
    the smoke's view flags are mvtop's."""
    from multiverso_tpu_torch.serve import wire

    _, port = _pair("mvtop")
    assert set(port.KIND_VIEWS) == set(wire.OPS_KINDS)
    assert set(chip_smoke.MVTOP_VIEWS) == set(wire.OPS_KINDS)
    for kind, flags in chip_smoke.MVTOP_VIEWS.items():
        assert port.KIND_VIEWS[kind] == (flags[0] if flags else "(default)")


# ------------------------------------- whole runs over a replayed fleet

@pytest.mark.parametrize("case,extra,rc", [
    ("clean", (), 0), ("dup", (), 0), ("dup", ("--strict",), 1),
    ("gap", (), 1), ("lost", ("--settle", "0"), 1),
    ("clean", ("--json", "--checksums"), 0)],
    ids=["clean", "dup", "dup-strict", "gap", "lost", "clean-json"])
def test_mvaudit_runs_match(case, extra, rc):
    m = _both("mvaudit")
    with _replay({"audit": _audit_fleet(case)}) as replay:
        got = {s: _main(mod, [replay.endpoint, *extra])
               for s, mod in m.items()}
    assert got["port"] == got["repo"]
    assert got["port"][0] == rc
    named = {n[0] for n in chip_smoke.audit_named(got["port"][1])}
    if "--json" not in extra:
        assert named == {"clean": set(), "dup": {"dup"}, "gap": {"gap",
                         "reorder"}, "lost": {"lost"}}[case]


@pytest.mark.parametrize("extra", [(), ("--json",)], ids=["text", "json"])
def test_latdoctor_runs_match(extra):
    m = _both("latdoctor")
    with _replay({"latency": _LATENCY}) as replay:
        got = {s: _main(mod, [replay.endpoint, "--fleet", *extra])
               for s, mod in m.items()}
    assert got["port"] == got["repo"]
    assert got["port"][0] == 0
    if not extra:
        ranks = chip_smoke.latdoctor_ranks(got["port"][1])
        assert ranks["1"]["dominant_p99"] == "apply"
        checks, ok = chip_smoke.judge_latdoctor(
            {"rc": 0, "out": got["port"][1]})
        assert ok, checks


@pytest.mark.parametrize("planes,strict,rc", [
    (_PLANES, True, 1), (_PLANES, False, 0),
    ({"alerts": {"ranks": {"0": {"rank": 0, "host": {"alerts": []}}}}},
     True, 0)], ids=["burn-strict", "burn", "quiet-strict"])
def test_mvdoctor_runs_match(planes, strict, rc):
    m = _both("mvdoctor")
    with _replay(planes) as replay:
        argv = [replay.endpoint, "--fleet"] + (["--strict"] if strict
                                               else [])
        got = {s: _main(mod, argv) for s, mod in m.items()}
    assert got["port"] == got["repo"]
    assert got["port"][0] == rc


@pytest.mark.parametrize("kind", list(chip_smoke.MVTOP_VIEWS))
def test_mvtop_views_match(kind):
    """Each view over the replayed fleet: the same exit code and text,
    and every answering rank's row (the smoke's judge)."""
    m = _both("mvtop")
    flags = list(chip_smoke.MVTOP_VIEWS[kind])
    reports = dict(FLEET, metrics=_METRICS)
    with _replay(reports) as replay:
        got = {s: _main(mod, [replay.endpoint, "--fleet", *flags])
               for s, mod in m.items()}
    assert got["port"] == got["repo"]
    rc, out = got["port"]
    want = {"capacity": ("0",), "replication": ("0", "2"),
            "alerts": ("0",)}.get(kind, ("0", "1"))
    checks, ok = chip_smoke.judge_mvtop_views(
        {kind: {"rc": rc, "out": out}}, ranks=want)
    assert ok, (checks, out)


# ------------------------------------------------- no JAX, both forms

_MODULE_CHILD = textwrap.dedent("""
    import runpy, sys
    sys.modules["jax"] = None
    sys.modules["multiverso_tpu"] = None
    sys.argv = [sys.argv[1]] + sys.argv[2:]
    runpy.run_module("multiverso_tpu_torch.tools." + sys.argv[0],
                     run_name="__main__")
""")

_ARGS = {"latdoctor": ("--fleet",), "mvaudit": (),
         "mvdoctor": ("--fleet", "--strict"), "mvtop": ("--fleet",)}


@pytest.mark.parametrize("name", CLIS)
def test_cli_runs_without_jax_as_module_and_script(name, tmp_path):
    """``python -m multiverso_tpu_torch.tools.<name>`` from the repo
    root and the script by its path from another directory (the smoke's
    ``Tool``), both with ``jax`` blocked, print what the repo's CLI
    prints over the same replayed fleet and exit as it does."""
    repo, _ = _pair(name)
    with _replay(dict(FLEET, audit=_audit_fleet("gap"))) as replay:
        want = _main(repo, [replay.endpoint, *_ARGS[name]])
        env = {k: v for k, v in os.environ.items()
               if k not in ("JAX_PLATFORMS", "PYTHONPATH")}
        mod = subprocess.run(
            [sys.executable, "-c", _MODULE_CHILD, name, replay.endpoint,
             *_ARGS[name]], capture_output=True, text=True, timeout=120,
            cwd=REPO, env=env)
        script = chip_smoke.Tool(name, replay.endpoint,
                                 *_ARGS[name]).finish()
    for rc, out, err in ((mod.returncode, mod.stdout, mod.stderr),
                         (script["rc"], script["out"], script["err"])):
        assert "Traceback" not in err, err
        assert (rc, _unstamped(out)) == want
    assert want[0] == {"mvaudit": 1, "mvdoctor": 1}.get(name, 0)
