"""Anonymous serve-tier wire client (docs/transport.md).

Speaks the native frame protocol directly over a TCP socket — no rank,
no machine file, no native library.  The epoll engine (`-net_engine=
epoll`, the default) accepts such connections on any server rank's
listen port: fleet peers open with a ``Hello`` identify frame, so any
connection whose first frame is an ordinary request (``src = -1``, as
packed here) is treated as anonymous — the reactor assigns it a
pseudo-rank, and replies route back over the same socket.  The blocking ``tcp`` engine does NOT serve
anonymous clients (its readers deliver inbound frames, but replies to a
non-rank ``src`` have no route back).

Frame layout (one ``Message``, little-endian, matching
``mvtpu/message.h``)::

    int64  frame_len                  # bytes after this field
    WireHeader {                      # 56 bytes
        int32 src, dst, type, table_id
        int64 msg_id, trace_id, version
        int32 codec, flags, num_blobs, shard_hint
    }
    num_blobs x { int64 len; bytes payload }

Supported requests are the serve protocol: ``RequestVersion`` (header
only, ``version=-1`` for the whole table), ``RequestGet`` (the server
replies with ITS SHARD of the table — an anonymous client reading a
sharded table contacts each server rank it cares about), the
server-side shed path answers either with ``ReplyBusy`` — plus the
introspection scrape ``OpsQuery``/``OpsReply``
(docs/observability.md): :meth:`AnonServeClient.ops_report` fetches
Prometheus metrics / health / table stats / hot-key workload reports,
local- or fleet-scope.

This module is pure stdlib + numpy so external tooling can vendor it.

Contract-checked: tools/mvcontract.py (``make contract``) statically
diffs the struct formats, ``FLAG_*`` constants, and ``MSG`` numbers
below against ``mvtpu/message.h`` — change them together or tier-1
fails.
"""

from __future__ import annotations

import socket
import struct
import time
from typing import Optional

import numpy as np

__all__ = ["AnonServeClient", "MSG", "pack_frame", "unpack_frame",
           "HEADER", "TIMING", "FLAG_TIMING", "AUDIT", "FLAG_AUDIT",
           "QOS", "FLAG_QOS", "QOS_CLASSES", "qos_id",
           "STAGES", "default_timeout_ms",
           "stage_durations", "ntp_sample", "OffsetEstimator",
           "OPS_SCOPE_LOCAL", "OPS_SCOPE_FLEET", "OPS_KINDS"]

# WireHeader (mvtpu/message.h): 4 x int32, 3 x int64, 4 x int32.
HEADER = struct.Struct("<4i3q4i")
# TimingTrail (mvtpu/message.h): six int64 monotonic-ns stage stamps
# following the header when FLAG_TIMING is set — enqueue, send, recv,
# dequeue, apply_done, reply_send (docs/observability.md).
TIMING = struct.Struct("<6q")
FLAG_TIMING = 1 << 3  # msgflag::kHasTiming
# AuditStamp (mvtpu/message.h): the inclusive per-(worker, table,
# shard) Add seq range this message covers, following the header (after
# the timing trail when both flags are set) when FLAG_AUDIT is set —
# the delivery-audit identity (docs/observability.md "audit plane").
AUDIT = struct.Struct("<2q")
FLAG_AUDIT = 1 << 4  # msgflag::kHasAudit
# QosStamp (mvtpu/message.h): tenant class (a POSITIONAL index into the
# server's -qos_classes list) + remaining deadline budget in ns,
# following the header (after the audit stamp when both flags are set)
# when FLAG_QOS is set — the tail-at-scale stamp (docs/serving.md
# "tail").  The reactor budgets inflight reads per class and drops a
# read already past its deadline at dequeue.
QOS = struct.Struct("<2iq")
FLAG_QOS = 1 << 5  # msgflag::kHasQos
_LEN = struct.Struct("<q")

# The default -qos_classes list (positional ids — both sides must agree
# on the list, the same contract as codec negotiation).
QOS_CLASSES = ("bulk", "gold")

# AnonServeClient's default connect/read timeout when the caller passes
# none.  Mirrors the -serve_timeout_ms flag (multiverso_tpu_torch/config.py);
# kept as a module constant so this file stays vendorable stdlib.
DEFAULT_TIMEOUT_MS = 30000


def default_timeout_ms() -> float:
    """The -serve_timeout_ms flag when multiverso_tpu_torch.config is
    importable, else :data:`DEFAULT_TIMEOUT_MS` — one source of truth
    for the serve tier's deadline budget (docs/serving.md "tail")."""
    try:  # pragma: no cover - import guard keeps the module vendorable
        from multiverso_tpu_torch import config
        return float(config.get("serve_timeout_ms"))
    except Exception:
        return float(DEFAULT_TIMEOUT_MS)


def qos_id(klass, classes=QOS_CLASSES) -> int:
    """Class name (or already-an-id) -> positional wire id."""
    if isinstance(klass, int):
        return klass
    try:
        return classes.index(klass)
    except ValueError:
        raise ValueError(f"unknown QoS class {klass!r} "
                         f"(declared classes: {classes})") from None

# MsgType values used by the serve protocol (mvtpu/message.h).
MSG = {
    "RequestGet": 1,
    "ReplyGet": 3,
    "ReplyError": 5,
    "RequestVersion": 8,
    "ReplyVersion": 9,
    "ReplyBusy": 10,
    # Hot-key replica pull (docs/embedding.md): the server pushes its
    # SpaceSaving top-K rows + bucket versions; anonymous clients keep
    # them as a local hot-row side table consulted before RequestGet.
    "RequestReplica": 11,
    "ReplyReplica": 12,
    # Hedge-cancel token (docs/serving.md "tail"): fire-and-forget
    # notice that the sender no longer wants (this connection, msg_id)'s
    # answer — the LOSER of a hedged read.  Consumed at the reactor (it
    # overtakes the mailbox FIFO); the actor drops the cancelled read at
    # dequeue.  No reply.
    "RequestCancel": 13,
    # Introspection plane (docs/observability.md): in-band scrape.  The
    # request's first blob names the report kind; `version` carries the
    # scope (OPS_SCOPE_LOCAL / OPS_SCOPE_FLEET).  Local-scope queries
    # are answered AT THE REACTOR, never through the actor mailbox.
    "OpsQuery": 23,
    "OpsReply": 24,
}

OPS_SCOPE_LOCAL = 0
OPS_SCOPE_FLEET = 1
# Every report kind the native ops plane dispatches (ops.cc LocalReport)
# — the wire-level catalogue.  tools/mvcontract.py diffs this tuple
# against the C++ dispatch strings, and tests assert every kind has an
# mvtop view and a docs/observability.md section, so adding a kind in
# only one place fails fast.
OPS_KINDS = ("metrics", "health", "tables", "hotkeys", "latency",
             "audit", "replication", "capacity", "alerts")
_TYPE_NAME = {v: k for k, v in MSG.items()}

_ACCEPT_RAW = 1  # msgflag::kAcceptRaw


def pack_frame(msg_type: int, table_id: int, msg_id: int, *,
               version: int = -1, blobs=(), timing: bool = False,
               audit=None, qos=None, shard: int = -1) -> bytes:
    """One wire frame.  ``src=-1`` is what makes the connection
    anonymous: the reactor sees no valid rank in the first frame and
    assigns a pseudo-rank instead.  ``timing=True`` stamps a latency
    trail (enqueue+send = now, monotonic ns) after the header — the
    server echoes and extends it, and the reply's trail attributes the
    round trip per stage (docs/observability.md "latency plane").
    ``audit=(seq_lo, seq_hi)`` stamps a delivery-audit seq range after
    the trail (docs/observability.md "audit plane").
    ``qos=(class_id, budget_ns)`` stamps the tenant class + remaining
    deadline budget after the audit stamp (docs/serving.md "tail") —
    the reactor budgets reads per class and drops a read already past
    its deadline at dequeue instead of burning an apply slot.
    ``shard`` stamps the target shard index (docs/replication.md): a
    post-failover rank serves TWO shards of a table, so the shard hint
    — not the connected rank — names which one this read wants; it
    rides the old header pad slot biased by one (-1 = no hint, the
    pre-replication wire, byte-identical)."""
    flags = (_ACCEPT_RAW | (FLAG_TIMING if timing else 0)
             | (FLAG_AUDIT if audit is not None else 0)
             | (FLAG_QOS if qos is not None else 0))
    body = HEADER.pack(-1, -1, msg_type, table_id, msg_id, 0, version,
                       0, flags, len(blobs), int(shard) + 1)
    if timing:
        now = time.monotonic_ns()
        body += TIMING.pack(now, now, 0, 0, 0, 0)
    if audit is not None:
        body += AUDIT.pack(int(audit[0]), int(audit[1]))
    if qos is not None:
        body += QOS.pack(int(qos[0]), 0, int(qos[1]))
    for b in blobs:
        body += _LEN.pack(len(b)) + bytes(b)
    return _LEN.pack(len(body)) + body


def unpack_frame(body: bytes) -> dict:
    """Decode one frame body (the bytes after the length prefix)."""
    (src, dst, mtype, table_id, msg_id, trace_id, version, codec, flags,
     num_blobs, shard_hint) = HEADER.unpack_from(body, 0)
    blobs = []
    pos = HEADER.size
    timing = None
    if flags & FLAG_TIMING:
        timing = TIMING.unpack_from(body, pos)
        pos += TIMING.size
    audit = None
    if flags & FLAG_AUDIT:
        audit = AUDIT.unpack_from(body, pos)
        pos += AUDIT.size
    qos = None
    if flags & FLAG_QOS:
        klass, _pad2, budget_ns = QOS.unpack_from(body, pos)
        qos = (klass, budget_ns)
        pos += QOS.size
    for _ in range(num_blobs):
        (blen,) = _LEN.unpack_from(body, pos)
        pos += _LEN.size
        blobs.append(body[pos:pos + blen])
        pos += blen
    return {"src": src, "dst": dst, "type": mtype,
            "type_name": _TYPE_NAME.get(mtype, str(mtype)),
            "table_id": table_id, "msg_id": msg_id, "trace_id": trace_id,
            "version": version, "codec": codec, "flags": flags,
            "shard": shard_hint - 1,
            "timing": timing, "audit": audit, "qos": qos, "blobs": blobs}


# Stage names, in trail order (docs/observability.md "latency plane").
STAGES = ("queue", "wire_out", "mailbox", "apply", "reactor", "wire_back")


def ntp_sample(trail, now_ns: int):
    """One NTP offset sample from a reply's timing trail: ``(offset_ns,
    rtt_ns)`` where offset is how far the SERVER's monotonic clock runs
    ahead of ours, rtt the round trip minus the server hold time.
    ``None`` when the trail never crossed the wire (local serve)."""
    t_send, t_recv, t_reply = trail[1], trail[2], trail[5]
    if not (t_send and t_recv and t_reply):
        return None
    offset = ((t_recv - t_send) + (t_reply - now_ns)) // 2
    rtt = (now_ns - t_send) - (t_reply - t_recv)
    return (offset, rtt) if rtt >= 0 else None


def stage_durations(trail, now_ns: int, offset_ns: int = 0) -> dict:
    """Per-stage durations (SECONDS, clamped at 0) from a reply's
    timing trail — the Python mirror of the native latency plane's
    attribution math.  Cross-clock stages (wire_out / wire_back) are
    corrected by ``offset_ns``; with a good estimate the stage sum
    telescopes back to ``total`` exactly."""
    t_enq, t_send, t_recv, t_deq, t_apply, t_reply = trail
    out = {}

    def put(name, ns):
        out[name] = max(ns, 0) * 1e-9

    if t_enq and t_send:
        put("queue", t_send - t_enq)
    remote = t_send and t_recv and t_reply
    if remote:
        put("wire_out", (t_recv - offset_ns) - t_send)
        if t_deq:
            put("mailbox", t_deq - t_recv)
    elif t_send and t_deq:
        put("mailbox", t_deq - t_send)
    if t_deq and t_apply:
        put("apply", t_apply - t_deq)
    if t_apply and t_reply:
        put("reactor", t_reply - t_apply)
    if t_reply:
        put("wire_back",
            now_ns - (t_reply - offset_ns) if remote else now_ns - t_reply)
    if t_enq:
        put("total", now_ns - t_enq)
    return out


class OffsetEstimator:
    """Bounded-window NTP clock filter (the native latency.cc mirror):
    feed every ``(offset, rtt)`` sample; the minimum-RTT sample of the
    last ``window`` wins — queueing delay inflates RTT and,
    asymmetrically, offset error."""

    def __init__(self, window: int = 8):
        self._ring = []          # [(rtt, offset)]
        self._window = max(1, int(window))
        self.samples = 0

    def update(self, offset_ns: int, rtt_ns: int) -> None:
        self._ring.append((int(rtt_ns), int(offset_ns)))
        del self._ring[:-self._window]
        self.samples += 1

    @property
    def offset_ns(self) -> int:
        return min(self._ring)[1] if self._ring else 0

    @property
    def rtt_ns(self) -> Optional[int]:
        return min(self._ring)[0] if self._ring else None


class AnonServeClient:
    """One anonymous connection to a server rank's listen endpoint.

    Blocking convenience wrapper; the fan-in bench/demo drive hundreds
    of these sockets through ``selectors`` instead (send ``request()``
    bytes, feed received bytes to a :class:`FrameDecoder`).

    With ``timing=True`` (the default) every request carries a latency
    trail; each reply then refreshes :attr:`offset` (the NTP-style
    server clock-offset estimate) and :attr:`last_stages` — the
    per-stage breakdown of that round trip, in seconds
    (docs/observability.md "latency plane").  A pre-trail server (or
    ``timing=False``) simply leaves both untouched: the old header
    round-trips exactly as before.

    ``timeout=None`` (the new default) reads ``-serve_timeout_ms`` —
    one source of truth for the serve deadline, because the SAME budget
    is propagated on the wire (docs/serving.md "tail"): every request
    carries a QoS stamp with this client's tenant class (``qos_class``,
    a name from the default class list or a raw positional id) and its
    remaining deadline budget, so a server drops a read whose caller
    already gave up instead of burning an apply slot.  ``qos_class=
    None`` stamps nothing — the pre-13 frame, byte-identical.
    """

    def __init__(self, endpoint: str, timeout: Optional[float] = None,
                 timing: bool = True, qos_class=None,
                 qos_classes=QOS_CLASSES):
        # Satellite discipline (docs/serving.md "tail"): the old
        # hard-coded 30 s default is now the -serve_timeout_ms flag.
        if timeout is None:
            timeout = default_timeout_ms() * 1e-3
        host, port = endpoint.rsplit(":", 1)
        self.sock = socket.create_connection((host, int(port)),
                                             timeout=timeout)
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._decoder = FrameDecoder()
        self._msg_id = 0
        self.timing = timing
        self.timeout = timeout
        self.qos_class = (None if qos_class is None
                          else qos_id(qos_class, qos_classes))
        self.offset = OffsetEstimator()
        self.last_stages: Optional[dict] = None
        # Optional observer fn(stages_dict) — multiverso_tpu_torch.latency
        # wires this to the metrics registry (lat.stage.* histograms);
        # kept as a plain callable so this module stays stdlib-only.
        self.stage_hook = None

    def _qos(self):
        """Per-request QoS stamp: (class id, remaining budget ns) from
        this client's declared class + socket timeout; None when no
        class was declared (the pre-13 frame)."""
        if self.qos_class is None:
            return None
        budget = self.timeout if self.timeout else 0.0
        return (self.qos_class, int(budget * 1e9))

    # ------------------------------------------------------------- low level
    def send_raw(self, data: bytes) -> None:
        self.sock.sendall(data)

    def recv_reply(self) -> dict:
        """Block until one full reply frame arrives."""
        while True:
            frame = self._decoder.next_frame()
            if frame is not None:
                reply = unpack_frame(frame)
                if reply["timing"]:
                    self._attribute(reply["timing"])
                return reply
            chunk = self.sock.recv(65536)
            if not chunk:
                raise ConnectionError("server closed the connection")
            self._decoder.feed(chunk)

    def _attribute(self, trail) -> None:
        now = time.monotonic_ns()
        sample = ntp_sample(trail, now)
        if sample is not None:
            self.offset.update(*sample)
        self.last_stages = stage_durations(trail, now,
                                           self.offset.offset_ns)
        hook = self.stage_hook
        if hook is not None:
            hook(self.last_stages)

    # ------------------------------------------------------------ serve ops
    def table_version(self, table_id: int) -> int:
        """Header-only version probe (RequestVersion): returns the
        contacted shard's current table version; a shed raises
        :class:`ServeBusy`."""
        mid = self._next_id()
        self.send_raw(pack_frame(MSG["RequestVersion"], table_id, mid,
                                 timing=self.timing, qos=self._qos()))
        reply = self.recv_reply()
        _check(reply, mid, "ReplyVersion")
        return reply["version"]

    def ops_report(self, kind: str = "health", scope: int = 0) -> str:
        """In-band introspection scrape (OpsQuery): returns the report
        text — Prometheus exposition for ``kind="metrics"`` (exemplar
        trace ids included), JSON for ``health``/``tables``.  With
        ``scope=OPS_SCOPE_FLEET`` the contacted rank fans out to every
        peer under a bounded deadline and merges, labeling series per
        rank and explicitly marking silent ranks."""
        mid = self._next_id()
        self.send_raw(pack_frame(MSG["OpsQuery"], -1, mid, version=scope,
                                 blobs=[kind.encode()],
                                 timing=self.timing, qos=self._qos()))
        reply = self.recv_reply()
        _check(reply, mid, "OpsReply")
        return reply["blobs"][0].decode() if reply["blobs"] else ""

    def get_shard(self, table_id: int) -> np.ndarray:
        """Fetch the contacted rank's shard of an array table as
        float32 (RequestGet; the payload is the shard, not the whole
        table — shards partition contiguously across server ranks).

        Returns a READ-ONLY zero-copy view over the reply bytes
        (``frombuffer`` of immutable ``bytes`` is non-writeable by
        construction) — the old trailing ``.copy()`` paid a full
        payload copy per fetch that cache layers then re-copied
        (docs/host_bridge.md).  Callers that need to mutate copy at
        their own boundary."""
        mid = self._next_id()
        self.send_raw(pack_frame(MSG["RequestGet"], table_id, mid,
                                 timing=self.timing, qos=self._qos()))
        reply = self.recv_reply()
        _check(reply, mid, "ReplyGet")
        return np.frombuffer(reply["blobs"][0], dtype=np.float32)

    def get_rows(self, table_id: int, row_ids, cols: int,
                 shard: int = -1) -> np.ndarray:
        """Row-subset read of a matrix table (RequestGet with an int32
        GLOBAL-row-id blob, the same request shape rank workers send):
        the contacted shard answers its rows in request order —
        mis-routed/out-of-range ids read as zeros, so callers aim at
        the shard that owns their rows.  ``shard`` stamps the shard
        hint (docs/replication.md): required when reading a BACKUP or
        promoted shard, whose host rank serves two shards of the
        table.  Returns a read-only ``(k, cols)`` float32 view over
        the reply bytes."""
        ids = np.ascontiguousarray(row_ids, dtype=np.int32)
        mid = self._next_id()
        self.send_raw(pack_frame(MSG["RequestGet"], table_id, mid,
                                 blobs=[ids.tobytes()],
                                 timing=self.timing, qos=self._qos(),
                                 shard=shard))
        reply = self.recv_reply()
        _check(reply, mid, "ReplyGet")
        out = np.frombuffer(reply["blobs"][0], dtype=np.float32)
        return out.reshape(ids.size, cols) if ids.size else out

    def cancel(self, table_id: int, msg_id: int) -> None:
        """Fire-and-forget hedge-cancel token (docs/serving.md "tail"):
        tell the server this connection no longer wants ``msg_id``'s
        answer.  Consumed at the reactor — if the read is still parked
        in the actor mailbox it is dropped at dequeue
        (serve.hedge.cancelled) instead of burning an apply slot.  No
        reply ever comes back (the caller must NOT wait for one)."""
        self.send_raw(pack_frame(MSG["RequestCancel"], table_id, msg_id))

    def get_replica(self, table_id: int) -> dict:
        """Hot-key replica pull (RequestReplica, docs/embedding.md):
        the contacted shard pushes its current SpaceSaving top-K rows.
        Returns ``{row_id: (version, row)}`` with read-only float32
        rows plus the shard version under key ``"_version"`` — the
        client-side hot-row side table to consult before paying a
        ``RequestGet``.  Empty when the shard's tracker is cold or
        ``-hotkey_enabled=false``."""
        mid = self._next_id()
        self.send_raw(pack_frame(MSG["RequestReplica"], table_id, mid,
                                 timing=self.timing, qos=self._qos()))
        reply = self.recv_reply()
        _check(reply, mid, "ReplyReplica")
        out: dict = {"_version": reply["version"]}
        if len(reply["blobs"]) < 3:
            return out
        ids = np.frombuffer(reply["blobs"][0], dtype=np.int32)
        vers = np.frombuffer(reply["blobs"][1], dtype=np.int64)
        rows = np.frombuffer(reply["blobs"][2], dtype=np.float32)
        if ids.size == 0 or rows.size % ids.size != 0:
            return out
        cols = rows.size // ids.size
        rows = rows.reshape(ids.size, cols)
        for i, rid in enumerate(ids.tolist()):
            out[rid] = (int(vers[i]), rows[i])
        return out

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _next_id(self) -> int:
        self._msg_id += 1
        return self._msg_id


class ServeBusy(RuntimeError):
    """The server (or the reactor's per-client admission gate) shed the
    request with ReplyBusy — retryable after backoff."""


def _check(reply: dict, msg_id: int, want: str) -> None:
    if reply["type"] == MSG["ReplyBusy"]:
        raise ServeBusy(f"request {msg_id} shed (ReplyBusy)")
    if reply["type_name"] != want or reply["msg_id"] != msg_id:
        raise ConnectionError(
            f"unexpected reply {reply['type_name']} (msg_id "
            f"{reply['msg_id']}, wanted {want}/{msg_id})")


# A length prefix outside (0, _MAX_FRAME_BYTES] is stream desync or
# corruption, never a legitimate reply — the bound mirrors the server's
# own rank frame cap (mvtpu's bad-frame-length close), far above any
# reply a serve client can receive.
_MAX_FRAME_BYTES = 1 << 40


class FrameDecoder:
    """Incremental frame reassembly for nonblocking herds: ``feed()``
    received bytes, ``next_frame()`` yields complete frame bodies.

    A corrupt length prefix raises :class:`ConnectionError` — treating
    it as "need more bytes" would buffer a desynced stream forever and
    hang the caller silently."""

    def __init__(self):
        self._buf = bytearray()

    def feed(self, data: bytes) -> None:
        self._buf += data

    def next_frame(self) -> Optional[bytes]:
        if len(self._buf) < _LEN.size:
            return None
        (flen,) = _LEN.unpack_from(self._buf, 0)
        if flen <= 0 or flen > _MAX_FRAME_BYTES:
            raise ConnectionError(
                f"bad frame length {flen}: stream desynced or corrupt")
        end = _LEN.size + flen
        if len(self._buf) < end:
            return None
        frame = bytes(self._buf[_LEN.size:end])
        del self._buf[:end]
        return frame
