#include "mvtpu/message.h"

#include <cstring>

namespace mvtpu {

void Message::FillWireHeader(WireHeader* h) const {
  *h = WireHeader{src,
                  dst,
                  static_cast<int32_t>(type),
                  table_id,
                  msg_id,
                  trace_id,
                  version,
                  static_cast<int32_t>(codec),
                  flags,
                  static_cast<int32_t>(data.size()),
                  shard + 1};  // biased: wire 0 = no hint (old peers)
}

void Message::AdoptWireHeader(const WireHeader& h) {
  src = h.src;
  dst = h.dst;
  type = static_cast<MsgType>(h.type);
  table_id = h.table_id;
  msg_id = h.msg_id;
  trace_id = h.trace_id;
  version = h.version;
  codec = static_cast<Codec>(h.codec);
  flags = h.flags;
  shard = h.shard_hint - 1;
}

int64_t Message::WireBytes() const {
  int64_t total = static_cast<int64_t>(sizeof(WireHeader));
  if (has_timing()) total += static_cast<int64_t>(sizeof(TimingTrail));
  if (has_audit()) total += static_cast<int64_t>(sizeof(AuditStamp));
  if (has_qos()) total += static_cast<int64_t>(sizeof(QosStamp));
  for (const auto& b : data)
    total += static_cast<int64_t>(sizeof(int64_t) + b.size());
  return total;
}

Blob Message::Serialize() const {
  Blob out(static_cast<size_t>(WireBytes()));
  char* p = out.data();
  WireHeader h;
  FillWireHeader(&h);
  std::memcpy(p, &h, sizeof(h));
  p += sizeof(h);
  if (has_timing()) {
    std::memcpy(p, &timing, sizeof(timing));
    p += sizeof(timing);
  }
  if (has_audit()) {
    std::memcpy(p, &audit, sizeof(audit));
    p += sizeof(audit);
  }
  if (has_qos()) {
    std::memcpy(p, &qos, sizeof(qos));
    p += sizeof(qos);
  }
  for (const auto& b : data) {
    int64_t len = static_cast<int64_t>(b.size());
    std::memcpy(p, &len, sizeof(len));
    p += sizeof(len);
    std::memcpy(p, b.data(), b.size());
    p += b.size();
  }
  return out;
}

namespace {

// Shared frame parser behind DeserializeView / DeserializeBorrow: the
// two receive paths differ ONLY in how an aligned payload blob is
// minted (a Blob::View sharing a vector slab vs a Blob::Borrow over
// registered arena bytes), so the bounds discipline — the hostile
// num_blobs cap, per-blob length validation, the 8-aligned view-vs-copy
// split, and the exact-consumption check — is written once and cannot
// drift between engines.  `align` is the frame's offset inside its
// 8-aligned slab (alignment is a slab property, not a frame property).
template <typename MakeBlob>
bool ParseWireFrame(const char* base, size_t align, size_t len,
                    Message* out, MakeBlob&& make_blob) {
  WireHeader h;
  std::memcpy(&h, base, sizeof(h));
  out->AdoptWireHeader(h);
  out->data.clear();
  out->timing = TimingTrail{};
  out->audit = AuditStamp{};
  out->qos = QosStamp{};
  out->qos_deadline_ns = 0;
  size_t pos = sizeof(h);
  // Optional latency trail (docs/observability.md): present iff the
  // sender set kHasTiming — an old-header frame parses exactly as
  // before, and a flagged frame too short to hold the trail is
  // malformed, not a silent misparse of blob bytes as timestamps.
  if (out->has_timing()) {
    if (len < pos + sizeof(TimingTrail)) return false;
    std::memcpy(&out->timing, base + pos, sizeof(TimingTrail));
    pos += sizeof(TimingTrail);
  }
  // Optional delivery-audit stamp (docs/observability.md "audit
  // plane"): same version-tolerance discipline as the trail.
  if (out->has_audit()) {
    if (len < pos + sizeof(AuditStamp)) return false;
    std::memcpy(&out->audit, base + pos, sizeof(AuditStamp));
    pos += sizeof(AuditStamp);
  }
  // Optional tenant QoS/deadline stamp (docs/serving.md "tail"): same
  // version-tolerance discipline as the trail and audit stamp.
  if (out->has_qos()) {
    if (len < pos + sizeof(QosStamp)) return false;
    std::memcpy(&out->qos, base + pos, sizeof(QosStamp));
    pos += sizeof(QosStamp);
  }
  // num_blobs comes off the wire: bound it against the frame BEFORE the
  // reserve — each blob costs at least its 8-byte length prefix, so a
  // frame of `len` bytes cannot hold more than (len - header)/8 blobs.
  // An unchecked reserve would let a 56-byte hostile frame claim
  // INT32_MAX blobs and force a multi-GB allocation the frame caps
  // exist to prevent.
  if (h.num_blobs < 0 ||
      static_cast<size_t>(h.num_blobs) > (len - pos) / sizeof(int64_t))
    return false;
  out->data.reserve(static_cast<size_t>(h.num_blobs));
  for (int32_t i = 0; i < h.num_blobs; ++i) {
    if (pos + sizeof(int64_t) > len) return false;
    int64_t blen;
    std::memcpy(&blen, base + pos, sizeof(blen));
    pos += sizeof(blen);
    if (blen < 0 || pos + static_cast<size_t>(blen) > len) return false;
    // Zero-copy only at 8-aligned payload offsets: consumers read
    // blobs as typed float/int32/int64 arrays (As<T>), and a view
    // following an odd-length blob would hand them a misaligned
    // pointer (UB, and a real fault on strict architectures).  The
    // hot path — one large payload right after the 8-aligned header —
    // always qualifies; small trailing blobs behind odd-length keys
    // pay a copy instead.
    if ((align + pos) % 8 == 0) {
      out->data.push_back(make_blob(pos, static_cast<size_t>(blen)));
    } else {
      out->data.emplace_back(base + pos, static_cast<size_t>(blen));
    }
    pos += static_cast<size_t>(blen);
  }
  return pos == len;
}

}  // namespace

bool Message::DeserializeView(std::shared_ptr<std::vector<char>> slab,
                              size_t off, size_t len, Message* out) {
  if (len < sizeof(WireHeader) || off + len > slab->size()) return false;
  const char* base = slab->data() + off;
  return ParseWireFrame(base, off, len, out,
                        [&](size_t pos, size_t blen) {
                          return Blob::View(slab, off + pos, blen);
                        });
}

bool Message::DeserializeBorrow(const char* frame, size_t align, size_t len,
                                const std::shared_ptr<void>& keepalive,
                                Message* out) {
  if (frame == nullptr || len < sizeof(WireHeader)) return false;
  return ParseWireFrame(frame, align, len, out,
                        [&](size_t pos, size_t blen) {
                          return Blob::Borrow(frame + pos, blen, keepalive);
                        });
}

Message Message::Deserialize(const Blob& buf) {
  Message m;
  const char* p = buf.data();
  WireHeader h;
  std::memcpy(&h, p, sizeof(h));
  p += sizeof(h);
  m.AdoptWireHeader(h);
  if (m.has_timing()) {
    std::memcpy(&m.timing, p, sizeof(m.timing));
    p += sizeof(m.timing);
  }
  if (m.has_audit()) {
    std::memcpy(&m.audit, p, sizeof(m.audit));
    p += sizeof(m.audit);
  }
  if (m.has_qos()) {
    std::memcpy(&m.qos, p, sizeof(m.qos));
    p += sizeof(m.qos);
  }
  m.data.reserve(static_cast<size_t>(h.num_blobs));
  for (int32_t i = 0; i < h.num_blobs; ++i) {
    int64_t len;
    std::memcpy(&len, p, sizeof(len));
    p += sizeof(len);
    m.data.emplace_back(p, static_cast<size_t>(len));
    p += len;
  }
  return m;
}

}  // namespace mvtpu
