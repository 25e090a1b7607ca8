"""Configuration / flag system.

TPU-native re-design of the reference's GFlags-like macro system
(reference: include/multiverso/util/configure.h, src/util/configure.cpp —
``MV_DEFINE_bool/int/string/double`` + ``ParseCMDFlags``; see SURVEY.md §2.20).

Flags keep the reference's names (``sync``, ``updater_type``, ``machine_file``,
``port``, ``backup_worker_ratio``) so launch scripts port unchanged, and the
same ``-name=value`` argv syntax is accepted (plus ``--name=value``).

Instead of C macros registering globals, flags live in a single registry that
both the Python runtime and the native C layer read.  ``machine_file`` is
accepted for CLI compatibility but is a no-op under single-controller SPMD
(documented in SURVEY.md §2.9-bis).  ``backup_worker_ratio`` is likewise a
no-op on the SPMD plane (collectives are lockstep — there is no straggler to
slack), but on the NATIVE wire plane it is real: the sync server releases
clock t once ceil((1-ratio)·workers) ticks arrive (``native/src/zoo.cc``
``HeldBySspLocked``; late adds fold into the open clock).
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

__all__ = [
    "define_bool",
    "define_int",
    "define_double",
    "define_string",
    "get",
    "set_flag",
    "parse_cmd_flags",
    "reset",
    "all_flags",
]


@dataclass
class _Flag:
    name: str
    default: Any
    parser: Callable[[str], Any]
    help: str
    value: Any = None

    def __post_init__(self) -> None:
        self.value = self.default


_LOCK = threading.RLock()
_REGISTRY: Dict[str, _Flag] = {}


def _parse_bool(s: str) -> bool:
    return s.strip().lower() in ("1", "true", "yes", "on")


def _define(name: str, default: Any, parser: Callable[[str], Any], help: str) -> None:
    with _LOCK:
        if name in _REGISTRY:
            # Re-definition keeps the first registration (matches the
            # reference's CHECK on duplicate flags but tolerates re-import).
            return
        _REGISTRY[name] = _Flag(name, default, parser, help)


def define_bool(name: str, default: bool, help: str = "") -> None:
    _define(name, default, _parse_bool, help)


def define_int(name: str, default: int, help: str = "") -> None:
    _define(name, default, int, help)


def define_double(name: str, default: float, help: str = "") -> None:
    _define(name, default, float, help)


def define_string(name: str, default: str, help: str = "") -> None:
    _define(name, default, str, help)


def get(name: str) -> Any:
    with _LOCK:
        if name not in _REGISTRY:
            raise KeyError(f"unknown flag: {name}")
        return _REGISTRY[name].value


def set_flag(name: str, value: Any) -> None:
    with _LOCK:
        if name not in _REGISTRY:
            raise KeyError(f"unknown flag: {name}")
        flag = _REGISTRY[name]
        if isinstance(value, str):
            flag.value = flag.parser(value)
        else:
            flag.value = value


def parse_cmd_flags(argv: Optional[List[str]] = None) -> List[str]:
    """Parse ``-name=value`` / ``--name=value`` args; return the leftovers.

    Unknown flags are left in the returned remainder rather than raising,
    mirroring the reference parser which skips unknown argv entries.
    """
    if argv is None:
        argv = []
    rest: List[str] = []
    for arg in argv:
        body = None
        if arg.startswith("--"):
            body = arg[2:]
        elif arg.startswith("-"):
            body = arg[1:]
        if body and "=" in body:
            name, _, val = body.partition("=")
            with _LOCK:
                if name in _REGISTRY:
                    flag = _REGISTRY[name]
                    flag.value = flag.parser(val)
                    continue
        rest.append(arg)
    return rest


def reset() -> None:
    """Reset every flag to its default (test isolation helper)."""
    with _LOCK:
        for flag in _REGISTRY.values():
            flag.value = flag.default


def all_flags() -> Dict[str, Any]:
    with _LOCK:
        return {name: f.value for name, f in _REGISTRY.items()}


# ---------------------------------------------------------------------------
# Core flags — names match the reference CLI (SURVEY.md §2.20).
# Contract-checked: tools/mvcontract.py (`make contract`) diffs these
# registrations against configure.cc and the docs/*.md flag tables —
# a flag shared with the native plane must keep the same default.
# ---------------------------------------------------------------------------

define_bool("sync", False, "BSP (True) vs ASP (False) training semantics")
define_string("updater_type", "default",
              "server-side updater: default|sgd|adagrad|momentum|smooth_gradient")
define_string("machine_file", "", "accepted for CLI parity; unused on TPU mesh")
define_int("port", 55555, "accepted for CLI parity; unused on TPU mesh")
define_double("backup_worker_ratio", 0.0,
              "straggler slack; N/A under SPMD lockstep — real on the "
              "native wire plane (quorum clock release, zoo.cc)")
define_string("log_level", os.environ.get("MVTPU_LOG_LEVEL", "info"),
              "debug|info|error|fatal")
define_string("log_file", "", "optional log file sink")
define_string("checkpoint_dir", "", "directory for table checkpoints")
define_int("checkpoint_interval", 0,
           "clocks between automatic checkpoints (0 = disabled)")
define_int("barrier_timeout_ms", 0,
           "host_sync/barrier deadline: an unresponsive peer raises "
           "BarrierTimeout instead of hanging; <=0 (default) waits "
           "forever (native-flag parity)")
define_int("ckpt_keep", 3,
           "snapshots CheckpointManager retains behind its MANIFEST")
define_int("metrics_flush_ms", 0,
           "periodic metrics export interval: every interval the registry "
           "renders to <trace_dir>/metrics_rank<r>.prom (Prometheus text; "
           "debug log when no trace_dir); 0 (default) disables "
           "(docs/observability.md)")
define_string("trace_dir", "",
              "arm span tracing and write trace_rank<r>.json (Chrome "
              "trace-event JSON, Perfetto-loadable) here at shutdown; "
              "merge ranks with tracing.merge_dir (docs/observability.md)")

# --- latency attribution (docs/observability.md "latency plane") -----------
define_bool("wire_timing", True,
            "stamp a timing trail into request/reply wire headers and "
            "fold replies into lat.stage.* histograms + per-peer clock "
            "offsets (native-flag parity; the Python serve clients "
            "stamp their own trails)")
define_int("profile_hz", 0,
           "arm the always-on sampling profiler at this rate: the "
           "native SIGPROF sampler (native-flag parity) plus the "
           "Python sampler thread (multiverso_tpu_torch/profiler.py), whose "
           "folded stacks land in trace_rank<r>.json beside spans at "
           "shutdown.  0 (default) disarms; 97 is the house rate")

# --- health plane (docs/observability.md "health plane") -------------------
define_int("metrics_history", 64,
           "time-series ring depth: how many flush snapshots each "
           "series keeps for rate()/delta()/alert-window queries.  The "
           "ring spans ~metrics_flush_ms x metrics_history of wall "
           "time; health-rule window_s / for_s beyond that can never "
           "fire (docs/observability.md)")
define_bool("health_rules", True,
            "arm the built-in SLO/alert rule pack (health.py) when the "
            "metrics flusher runs: rules evaluate each flush, firing "
            "alerts land in health.alerts.firing{severity=}, emit "
            "flight-recorder events, and criticals boost the profiler "
            "+ trigger a blackbox dump; the 'alerts' OpsQuery kind "
            "serves the state fleet-wide (tools/mvtop.py --alerts)")
define_double("health_latency_slo_ms", 250.0,
              "end-to-end latency SLO threshold: serve round-trips "
              "slower than this count against the lat.slo.breach "
              "error budget the burn-rate rule watches; <=0 disables "
              "the breach counters")
define_int("watchdog_stall_ms", 0,
           "native stall watchdog: flag a critical loop (epoll "
           "reactor shards, actors, heartbeat/lease scan, Python "
           "metrics flusher) that makes zero progress for this long "
           "while work is queued — dumps profiler folded stacks + a "
           "'stall:' blackbox and bumps watchdog.stalls.  0 (default) "
           "disarms; must exceed the slowest legitimate loop period "
           "(native-flag parity)")

# --- delivery audit (docs/observability.md "audit plane") ------------------
define_bool("audit", True,
            "delivery-audit plane: stamp every native-plane Add with a "
            "per-(worker, table, shard) seq range, keep acked-add "
            "ledgers + applied watermarks, and serve the 'audit' "
            "OpsQuery kind (native-flag parity; tools/mvaudit.py diffs "
            "the books fleet-wide)")
define_int("audit_grace_ms", 2000,
           "delivery-audit gap grace window before the audit_gap "
           "flight-recorder trigger fires (native-flag parity)")
define_int("audit_ring", 64,
           "delivery-audit anomaly ring capacity per server table "
           "(native-flag parity)")

# --- shard replication + failover (docs/replication.md) --------------------
define_int("replication_factor", 0,
           "shard replication: 0 = off (a dead server rank is fatal "
           "for its shard); 1 = every shard gets a backup rank "
           "(chained: shard i's backup is server i+1 mod n) fed by a "
           "primary->backup delta stream, with lease-triggered "
           "promotion and routing-epoch re-pointing "
           "(native-flag parity)")
define_bool("repl_sync", True,
            "sync replication: park the client's add ack until the "
            "backup confirmed the forwarded apply — 'acked' means "
            "applied on BOTH replicas, zero lost acked adds across a "
            "failover by construction (native-flag parity)")
define_int("repl_lag_max", 64,
           "async replication lag bound (-repl_sync=false): stall the "
           "apply path while this many forwards are unacked by the "
           "backup; measured by the repl.lag histogram "
           "(native-flag parity)")
define_bool("promote_auto", True,
            "lease-triggered promotion: a backup whose primary's "
            "heartbeat lease expires promotes automatically; false = "
            "operator-driven only (native-flag parity)")
define_int("blackbox_keep", 4,
           "flight-recorder dump rotation: timestamped "
           "blackbox_rank<r>.<ts>.<n>.json archives retained per rank "
           "beside the canonical latest dump, listed in "
           "blackbox_rank<r>.manifest.json (a second trigger no "
           "longer overwrites the first dump's evidence)")

# --- wire data plane (docs/wire_compression.md) ----------------------------
define_string("wire_codec", "raw",
              "payload codec for table wire traffic: raw|1bit|sparse. "
              "On the JAX plane, 1bit makes sign-bit+scales compression "
              "(error feedback) the default for host dense adds on "
              "float ASP tables (the explicit compress= kwarg still "
              "wins); on the native plane every new table negotiates "
              "this codec at creation (MV_SetTableCodec retargets one)")
define_int("add_agg_ms", 0,
           "native-plane add aggregation window (ms): async dense adds "
           "within the window sum worker-side and ship as ONE "
           "codec-encoded wire message; flushed by Get/Clock/Barrier/"
           "shutdown so BSP/SSP semantics hold (native-flag parity; the "
           "lockstep JAX plane has no per-add wire messages to collapse)")
define_int("add_agg_bytes", 0,
           "native-plane add aggregation size bound: flush once absorbed "
           "payload bytes reach this (native-flag parity)")

# --- serve layer (docs/serving.md) -----------------------------------------
define_int("serve_cache_entries", 0,
           "versioned client cache size (entries) for table reads; 0 "
           "(default) disables the serve cache — tables and ServeClient "
           "read this at construction")
define_int("max_staleness", 0,
           "serve-cache staleness bound in VERSIONS (server-side "
           "applies a served read may be behind); 0 = cached reads are "
           "never stale.  Distinct from the SSP -staleness clock bound "
           "(docs/serving.md maps the two)")
define_double("coalesce_window_us", 200.0,
              "request-coalescing window: concurrent/adjacent reads on "
              "one table arriving within this window merge into one "
              "wire round trip (0 = only truly concurrent calls merge)")
define_int("serve_max_batch", 64,
           "size cap per coalescing window — a full batch seals (and "
           "executes) early")
define_bool("serve_row_cache", True,
            "row-granular serve cache (docs/embedding.md): with the "
            "serve cache armed, Matrix/KV per-id reads cache INDIVIDUAL "
            "rows/keys gated by their bucket versions, so a hot row "
            "keeps hitting across different id sets and adds elsewhere. "
            "False falls back to whole-id-set entries.  "
            "Single-controller only either way — multi-host id reads "
            "bypass the cache (the fetch is a lockstep collective)")
# --- workload observability (docs/observability.md) ------------------------
define_bool("hotkey_enabled", True,
            "per-table workload accounting: hot-key sketches "
            "(space-saving top-K + count-min), per-bucket get/add load "
            "counters and the skew ratio they expose.  Native-flag "
            "parity: the server hot path carries the same switch; False "
            "reduces every hook to one boolean check")
define_int("hotkey_topk", 16,
           "capacity of the space-saving top-K hot-key sketch per table "
           "(memory bound; every key with frequency > total/K is "
           "guaranteed monitored)")
define_bool("hotkey_replica", False,
            "hot-key read replica (docs/embedding.md, native-flag "
            "parity): matrix worker stubs keep a side table of the "
            "servers' pushed SpaceSaving top-K rows and serve row gets "
            "from it before the wire; invalidation rides the "
            "version-stamp protocol")
define_double("replica_lease_ms", 50.0,
              "hot-key replica snapshot lease (native-flag parity): the "
              "pushed row set re-pulls once the snapshot ages past this")
define_int("replica_max_staleness", 0,
           "version distance a replica-served row may be behind the "
           "last observed apply (native-flag parity); 0 = a row older "
           "than any later observed add misses")

# --- capacity plane (docs/observability.md "capacity plane") ---------------
define_bool("capacity_enabled", True,
            "fleet capacity accounting (native-flag parity): per-table "
            "resident bytes per bucket/shard, arena + write-queue + "
            "registered byte gauges, and the bounded load-history ring "
            "behind the 'capacity' OpsQuery kind.  False reduces every "
            "hot-path growth hook to one relaxed atomic check "
            "(MV_SetCapacityTracking toggles live; re-arming resyncs)")
define_int("capacity_history_ms", 250,
           "minimum interval between capacity load-history windows "
           "(native-flag parity): each 'capacity' scrape at least this "
           "far from the last appends one (ts, gets, adds, bytes, "
           "per-bucket load) window to the bounded 64-window ring — "
           "one scrape then yields per-bucket load RATES, the "
           "placement advisor's input.  <= 0 records every scrape")

# --- tail-at-scale serve tier (docs/serving.md "tail") ---------------------
define_int("serve_timeout_ms", 30000,
           "AnonServeClient's default connect/read timeout — ONE source "
           "of truth for the serve deadline: the same budget is stamped "
           "into every request's QoS wire header (deadline propagation), "
           "so a server drops a read whose caller already gave up "
           "(serve.deadline.shed) instead of burning an apply slot")
define_string("qos_classes", "bulk:1,gold:8",
              "tenant classes + weights ('name:weight,...'; wire class "
              "ids are POSITIONAL indices into this list — native-flag "
              "parity).  Weights split -qos_inflight_max into per-class "
              "guaranteed read budgets at the reactor")
define_int("qos_inflight_max", 0,
           "per-class weighted admission over anonymous serve reads at "
           "the reactor (native-flag parity): a class at its share "
           "answers ReplyBusy while others keep flowing; adds are never "
           "shed.  0 (default) disables the gate")
define_string("qos_class", "bulk",
              "the tenant class this process's requests declare "
              "(native-flag parity; a name from -qos_classes)")
define_bool("wire_deadline", True,
            "deadline propagation (native-flag parity): stamp requests "
            "with their remaining timeout budget; receivers drop a read "
            "already past its deadline at dequeue.  Adds never shed")
define_double("hedge_min_us", 1000.0,
              "hedged-read delay floor: HedgedReader re-issues a read "
              "after max(observed p95, this) — hedging earlier than the "
              "tail re-issues healthy traffic for nothing "
              "(docs/serving.md \"tail\")")

define_double("version_lease_ms", 50.0,
              "how long a learned server version stays trusted before "
              "a cached read pays a header-only version probe; 0 = "
              "probe every cached read (never stale even at "
              "max_staleness=0, at one tiny round trip per read)")
