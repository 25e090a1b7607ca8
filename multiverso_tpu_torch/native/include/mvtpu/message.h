// Message — the wire/mailbox unit: routing header + blob payload.
// Capability parity with include/multiverso/message.h (SURVEY.md §2.4).
// Contract-checked: tools/mvcontract.py (`make contract`) statically
// diffs the MsgType/msgflag values and the stamp struct layouts below
// against serve/wire.py — change them together or tier-1 fails.
#pragma once

#include <cstdint>
#include <memory>
#include <vector>

#include "mvtpu/blob.h"

namespace mvtpu {

enum class MsgType : int32_t {
  RequestGet = 1,
  RequestAdd = 2,
  ReplyGet = 3,
  ReplyAdd = 4,
  // Synthesized locally when the transport cannot deliver a request —
  // unblocks the pending RoundTrip with an error instead of a hang.
  ReplyError = 5,
  // Pipeline flush marker: rides each worker→server connection BEHIND
  // any earlier async adds (per-connection FIFO), acked after the
  // server processed everything before it.  Barrier() drains one per
  // remote server shard before announcing arrival — the mechanism that
  // makes "async adds apply before the barrier completes" true for
  // n >= 3 (two connections to different peers have no mutual order).
  RequestFlush = 6,
  ReplyFlush = 7,
  ControlRegister = 16,
  ControlReply = 17,
  ControlBarrier = 18,
  ControlBarrierReply = 19,
  // Serve layer (docs/serving.md): version probe.  A read-optimized
  // client that holds a cached copy asks for the table's CURRENT
  // version instead of paying a full fetch — the request's `version`
  // field carries a bucket index (>= 0) for bucket-granular tables
  // (KV/matrix) or -1 for the whole table; the reply's `version` field
  // carries the answer.
  RequestVersion = 8,
  ReplyVersion = 9,
  // Serve backpressure shed (docs/serving.md): the server actor's
  // mailbox exceeded `-server_inflight_max`, so this Get/probe was
  // answered WITHOUT processing.  Retryable — and unlike a deadline -3
  // it is not indeterminate: the server did no work.
  ReplyBusy = 10,
  // Hot-key replica pull (docs/embedding.md): the requester asks a
  // server shard to PUSH its current SpaceSaving top-K rows.  The
  // reply carries three blobs — [int32 global row ids][int64 per-row
  // bucket versions][float row data, k*cols] — snapshotted atomically
  // against concurrent adds, plus the shard's table version in the
  // header.  Workers (and anonymous serve clients) install the rows in
  // a read-replica side table consulted BEFORE the wire; invalidation
  // rides the existing version-stamp protocol (an entry older than the
  // staleness bound misses).  Sheddable like a Get — never blocks adds.
  RequestReplica = 11,
  ReplyReplica = 12,
  // Hedge-cancel token (docs/serving.md "tail"): fire-and-forget notice
  // that the sender no longer wants the answer to (src, msg_id) — the
  // LOSER of a hedged read race.  Consumed AT THE REACTOR (never the
  // actor mailbox, so it overtakes the FIFO the loser is parked in);
  // the server actor drops a cancelled Get at dequeue instead of
  // burning an apply slot on an answer nobody is waiting for.  Only
  // reads are ever cancelled; there is no reply.
  RequestCancel = 13,
  // SSP clock announcement (msg_id = the worker's new clock).  Rides
  // each worker->server connection BEHIND that clock's adds (FIFO), so
  // "min worker clock >= c" implies every rank's adds through clock c
  // landed — the bounded-staleness guarantee MV_Clock documents.
  ClockTick = 20,
  // Liveness lease (docs/fault_tolerance.md): every non-zero rank
  // announces itself to rank 0 every `-heartbeat_ms`; rank 0's lease
  // loop reports peers whose announcements stop (Dashboard hb.missed)
  // instead of letting the next barrier discover the corpse by hanging.
  Heartbeat = 21,
  // Connection-identify frame (docs/transport.md): the FIRST frame a
  // rank peer sends on a fresh outbound connection, carrying its rank
  // in `src` and nothing else.  The epoll reactor caps UNIDENTIFIED
  // accepted connections at the small anonymous-client frame bound, so
  // a rank peer must announce itself with this tiny frame before its
  // first (possibly shard-sized) payload frame; the reactor consumes it
  // during identification — it is never forwarded upstream.
  Hello = 22,
  // Live introspection plane (docs/observability.md): an in-band scrape
  // over the SAME wire the serve tier speaks.  The request's first blob
  // names the report kind ("metrics" | "health" | "tables"); `version`
  // carries the scope (0 = this rank, 1 = fleet: the receiving rank
  // fans out to every peer with a bounded deadline and merges, marking
  // silent ranks).  Local-scope queries are answered AT THE REACTOR
  // (like ReplyBusy — never through the actor mailbox), so a wedged
  // server still answers its health scrape.  The reply's single blob is
  // the report text (Prometheus exposition for "metrics", JSON
  // otherwise).
  OpsQuery = 23,
  OpsReply = 24,
  // ---- shard replication + failover (docs/replication.md) ------------
  // Primary→backup delta stream: after a primary shard applies a
  // RequestAdd it re-ships the DECODED payload to its backup rank as a
  // ReplForward.  `version` carries the ORIGIN worker rank (the backup
  // books the same per-origin audit watermark the primary did), `shard`
  // names the shard stream, and the AuditStamp rides along when the
  // original add carried one.  `msg_id` is the forward's ack token:
  // the backup answers every forward with a ReplAck echoing it, which
  // is how the primary bounds replication lag (`-repl_lag_max`) and,
  // in sync mode, when it releases the client's parked ReplyAdd.
  ReplForward = 25,
  ReplAck = 26,
  // Whole-shard catch-up (the replica machinery generalized from
  // top-K rows to the full shard): a (re)joining backup asks the
  // primary for a snapshot of one table's shard — request has no data
  // blobs; the reply carries [serialized shard state][exported audit
  // watermarks] with the snapshot's table version in `version`.
  // Served by the primary's server actor, so it serializes against
  // ProcessAdd: every delta after the snapshot reaches the backup as a
  // ReplForward BEHIND the reply on the same connection (FIFO).
  ShardSnapshot = 27,
  // Versioned routing-epoch broadcast: blobs = [int32 owner ranks per
  // shard][int32 backup ranks per shard], msg_id = the epoch.  Receivers
  // adopt iff newer (max-merge), re-pointing Zoo::server_rank() so every
  // in-flight retry re-routes to the promoted/new primary without a
  // fleet restart.
  RoutingEpoch = 28,
  // Operator/controller-initiated promotion nudge: asks the receiving
  // rank to promote its backup shard(s) for the rank in `version` (the
  // same path lease expiry triggers automatically).
  Promote = 29,
  Exit = 64,
};

// Payload codec (docs/wire_compression.md): how the LAST blob of a
// message's data (the float delta/value payload) is encoded on the
// wire.  Negotiated per table at creation (`-wire_codec` /
// MV_SetTableCodec) and stamped per MESSAGE in the wire header — a
// sparse-codec table falls back to kRaw on payloads where the sparse
// form would be larger, so the receiver must trust the stamp, not the
// table setting.
enum class Codec : int32_t {
  kRaw = 0,     // float32, one element per 4 bytes (the reference wire)
  kOneBit = 1,  // sign bits + two scales, worker-side error feedback
  kSparse = 2,  // (index, value) pairs of nonzeros — lossless
};

// Header flag bits: the codecs the SENDER of a request accepts in the
// reply.  Every request carries kAcceptRaw; tables with a non-raw codec
// additionally advertise the lossless sparse codec so large mostly-zero
// Get replies can shrink.  (Replies are never 1-bit encoded: error
// feedback needs a per-receiver residual the server does not hold.)
namespace msgflag {
inline constexpr int32_t kAcceptRaw = 1 << 0;
inline constexpr int32_t kAccept1Bit = 1 << 1;
inline constexpr int32_t kAcceptSparse = 1 << 2;
// Latency-attribution trail (docs/observability.md "latency plane"): a
// TimingTrail follows the WireHeader on the wire.  VERSION-TOLERANT by
// construction: a peer that never sets the bit ships the header
// unchanged and is parsed exactly as before; a receiver that does not
// understand the bit would still frame correctly (the trail is inside
// the length-prefixed frame) — replies only carry a trail when the
// REQUEST did, so an old client is never handed bytes it cannot parse.
inline constexpr int32_t kHasTiming = 1 << 3;
// Delivery-audit stamp (docs/observability.md "audit plane"): an
// AuditStamp follows the WireHeader (after the TimingTrail when both
// bits are set).  Version-tolerant exactly like kHasTiming: peers that
// never stamp ship/parse the old layout, and replies carry a stamp
// only when the request did.
inline constexpr int32_t kHasAudit = 1 << 4;
// Tenant QoS + deadline stamp (docs/serving.md "tail"): a QosStamp
// follows the WireHeader (after the AuditStamp when both bits are
// set).  Version-tolerant exactly like kHasTiming/kHasAudit: peers
// that never stamp ship/parse the old layout byte-identically, and a
// flagged-but-short frame is malformed, never a misparse.
inline constexpr int32_t kHasQos = 1 << 5;
}  // namespace msgflag

// Wire-stamped request-lifecycle timing trail (docs/observability.md):
// six monotonic-clock nanosecond stamps, each taken on whichever rank
// owns the stage boundary.  Client-side stamps (enqueue/send) and
// server-side stamps (recv/dequeue/apply_done/reply_send) live on
// DIFFERENT clocks — cross-clock stage deltas are only meaningful after
// the per-peer NTP-style offset correction (mvtpu/latency.h).  0 = the
// stage boundary was never crossed (local delivery has no recv stamp;
// an old peer stamps nothing).
struct TimingTrail {
  enum Stamp {
    kEnqueue = 0,    // client: request minted (MakeReq)
    kSend = 1,       // client: handed to the transport (Zoo::Deliver)
    kRecv = 2,       // server: frame complete at the reactor/reader
    kDequeue = 3,    // server: actor dequeued it (handler entry)
    kApplyDone = 4,  // server: table work done, reply built
    kReplySend = 5,  // server: reply handed to the transport
    kStamps = 6,
  };
  int64_t t[kStamps] = {0, 0, 0, 0, 0, 0};
};

// Delivery-audit identity (docs/observability.md "audit plane"): the
// inclusive range of per-(worker, table, server-shard) Add sequence
// numbers this message covers.  A plain add covers one seq (lo == hi);
// an aggregation flush covers the whole collapsed window, so the
// auditor can account every absorbed logical add through the single
// wire message that carried it.  The origin rank rides in the header's
// `src`; seqs start at 1 and are dense PER SHARD STREAM — each server
// shard observes 1,2,3,... from each origin, which is what makes the
// applied watermark (mvtpu/audit.h) a loss/dup/reorder detector rather
// than a heuristic.  Retries re-send the identical stamp: a duplicated
// delivery is counted as a dup, never double-advanced.
struct AuditStamp {
  int64_t seq_lo = 0;
  int64_t seq_hi = 0;
};

// Tenant QoS + deadline-propagation stamp (docs/serving.md "tail").
// `klass` is the sender's tenant class — a POSITIONAL index into the
// server's `-qos_classes` list (both sides must agree on the list, the
// same contract as codec negotiation); the reactor's weighted admission
// gate budgets inflight reads per class.  `budget_ns` is the REMAINING
// deadline budget at client send time (0 = no deadline): the receiver
// converts it to a local-clock deadline at frame receipt — correcting
// for wire time via the clock-offset estimate when one exists —
// and drops a read that is already past it at dequeue instead of
// burning an apply slot on an answer nobody is waiting for.  Adds are
// never deadline-shed.
struct QosStamp {
  int32_t klass = 0;
  int32_t pad = 0;
  int64_t budget_ns = 0;
};

// Fixed-size wire header — ONE definition shared by Message::Serialize
// (contiguous form: tests, MpiNet) and TcpNet's scatter-gather send
// (header + blob iovecs, no payload copy).  Layout changes here change
// the wire format; both sides memcpy this struct.
struct WireHeader {
  int32_t src, dst, type, table_id;
  int64_t msg_id;
  int64_t trace_id;
  int64_t version;
  int32_t codec;      // Codec of data.back() (kRaw when data is empty)
  int32_t flags;      // msgflag:: accept bits for the reply
  int32_t num_blobs;
  // Shard routing hint (docs/replication.md), BIASED BY ONE so the
  // pre-replication wire value 0 still means "no hint": requests stamp
  // the target shard index + 1 and replies echo it.  After a failover
  // one rank can serve TWO shards of a table, so neither the dst rank
  // (on requests) nor the src rank (on replies) names the shard any
  // more — the hint does.  Was the `pad` byte-alignment field; old
  // peers ship 0 here and parse as hint -1, the pre-epoch routing.
  int32_t shard_hint = 0;
};

struct Message {
  int32_t src = -1;
  int32_t dst = -1;
  MsgType type = MsgType::RequestGet;
  int32_t table_id = -1;
  int64_t msg_id = -1;
  // Observability span id (0 = none): stamped by the worker-side op that
  // originated the request, adopted by the server actor before
  // ProcessGet/ProcessAdd, and echoed on replies — the cross-rank
  // correlation key for merged traces (docs/observability.md).
  int64_t trace_id = 0;
  // Serve-layer version stamp (docs/serving.md): every server-side
  // apply bumps a per-table (and per-row-bucket) monotonic counter;
  // replies carry the version covering the data they serve so clients
  // can bound cache staleness.  On a RequestVersion it instead carries
  // the REQUESTED bucket (-1 = whole table).  0 = unversioned.
  int64_t version = 0;
  // Wire codec of data.back() (docs/wire_compression.md).  kRaw unless a
  // worker-side encode stamped it; the server decodes before ProcessAdd
  // and the worker actor decodes replies before Notify, so the table
  // layer itself only ever sees raw float payloads.
  Codec codec = Codec::kRaw;
  // msgflag:: accept bits: the reply codecs this request's sender can
  // decode (stamped by Get/version requests; replies echo kAcceptRaw).
  int32_t flags = msgflag::kAcceptRaw;
  // Latency trail — on the wire ONLY when flags carries kHasTiming
  // (docs/observability.md): requests stamp the client-side slots,
  // the server copies the trail into the reply and adds its own, and
  // the client attributes the round trip per stage on reply receipt.
  TimingTrail timing;
  // Delivery-audit stamp — on the wire ONLY when flags carries
  // kHasAudit (docs/observability.md "audit plane"): Add requests
  // carry the covered seq range, the server's ReplyAdd ack echoes it
  // so the client ledger can advance its acked watermark.
  AuditStamp audit;
  // Tenant QoS + deadline stamp — on the wire ONLY when flags carries
  // kHasQos (docs/serving.md "tail"): read requests carry their class
  // and remaining deadline budget; replies never carry one.
  QosStamp qos;
  // Shard routing hint (docs/replication.md): the target shard index a
  // request addresses / the shard a reply answers for, or -1 (no hint —
  // the pre-replication wire, where dst/src ranks named shards
  // uniquely).  Rides the header's shard_hint slot biased by one, so
  // old frames stay byte-identical.
  int32_t shard = -1;
  // NOT serialized: the local-monotonic-clock deadline adopted from
  // `qos.budget_ns` at frame receipt (qos::AdoptDeadline).  0 = none.
  int64_t qos_deadline_ns = 0;
  std::vector<Blob> data;

  bool has_timing() const { return (flags & msgflag::kHasTiming) != 0; }
  bool has_audit() const { return (flags & msgflag::kHasAudit) != 0; }
  bool has_qos() const { return (flags & msgflag::kHasQos) != 0; }

  // Header <-> message field marshalling (shared by Serialize and the
  // transport's scatter-gather framing).
  void FillWireHeader(WireHeader* h) const;
  void AdoptWireHeader(const WireHeader& h);
  // Total framed byte count (header + per-blob length prefixes + blob
  // payloads) — what one wire frame of this message occupies.
  int64_t WireBytes() const;

  // Serialize to one contiguous buffer (header + per-blob length prefix):
  // the MpiNet wire shape and the test-suite round-trip form.  TcpNet
  // ships the identical layout via scatter-gather iovecs instead
  // (net.cc SendFramed) — no full-payload copy on the hot path.
  Blob Serialize() const;
  static Message Deserialize(const Blob& buf);
  // Zero-copy deserialize (the epoll receive path, docs/transport.md):
  // the frame at [off, off+len) of `slab` is parsed in place, each data
  // blob becoming a Blob::View sharing the slab's ownership — no payload
  // copy.  `off` must be 8-aligned (the reactor's arena packs frames
  // that way); blobs landing at unaligned offsets inside the frame are
  // flattened to owning copies instead of views, so consumers may
  // always As<T>() the payload.  False on a malformed frame (blob
  // lengths overrunning `len`); the caller drops the connection.
  static bool DeserializeView(std::shared_ptr<std::vector<char>> slab,
                              size_t off, size_t len, Message* out);
  // Zero-copy deserialize over BORROWED memory (the io_uring registered-
  // buffer receive path, docs/transport.md): same parse and same
  // malformed-frame contract as DeserializeView, but the frame lives in
  // raw caller-owned bytes (a HostArena slab registered with the
  // kernel), so aligned blobs become Blob::Borrow windows sharing
  // `keepalive` — the slab recycles only once every borrow (and the
  // caller's own hold) is gone, the two-hold discipline.  `align`
  // is the frame's byte offset inside its slab, used only for the
  // 8-alignment view-vs-copy split (the slab base itself must be
  // 8-aligned, as HostArena buffers are).
  static bool DeserializeBorrow(const char* frame, size_t align, size_t len,
                                const std::shared_ptr<void>& keepalive,
                                Message* out);
};

using MessagePtr = std::unique_ptr<Message>;

}  // namespace mvtpu
