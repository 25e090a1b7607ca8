// Native test driver — reference Test/ parity (SURVEY.md §2.35, §4):
// named scenarios + unit checks in one binary. Run all: ./mvtpu_test
// Run one: ./mvtpu_test blob|queue|configure|message|array|matrix|
//                        updater|checkpoint|threads
#include <unistd.h>

#include <algorithm>
#include <atomic>
#include <cassert>
#include <chrono>
#include <cmath>
#include <cstdio>
#include <cstring>
#include <limits>
#include <string>
#include <thread>
#include <vector>

#include "mvtpu/audit.h"
#include "mvtpu/blob.h"
#include "mvtpu/c_api.h"
#include "mvtpu/capacity.h"
#include "mvtpu/codec.h"
#include "mvtpu/configure.h"
#include "mvtpu/dashboard.h"
#include "mvtpu/host_arena.h"
#include "mvtpu/latency.h"
#include "mvtpu/message.h"
#include "mvtpu/mpi_net.h"
#include "mvtpu/mt_queue.h"
#include "mvtpu/net.h"
#include "mvtpu/ops.h"
#include "mvtpu/qos.h"
#include "mvtpu/repl.h"
#include "mvtpu/sketch.h"
#include "mvtpu/table.h"
#include "mvtpu/updater.h"
#include "mvtpu/waiter.h"
#include "mvtpu/watchdog.h"

#define CHECK(cond)                                                        \
  do {                                                                     \
    if (!(cond)) {                                                         \
      fprintf(stderr, "CHECK failed at %s:%d: %s\n", __FILE__, __LINE__,   \
              #cond);                                                      \
      return 1;                                                            \
    }                                                                      \
  } while (0)

static int TestBlob() {
  mvtpu::Blob b(16);
  CHECK(b.size() == 16);
  for (int i = 0; i < 4; ++i) b.As<float>()[i] = static_cast<float>(i) * 1.5f;
  mvtpu::Blob shared = b;  // shallow
  shared.As<float>()[0] = 42.0f;
  CHECK(b.As<float>()[0] == 42.0f);
  mvtpu::Blob deep;
  deep.CopyFrom(b);
  deep.As<float>()[0] = 0.0f;
  CHECK(b.As<float>()[0] == 42.0f);
  CHECK(b.count<float>() == 4);
  return 0;
}

static int TestBlobBorrow() {
  // Borrowed external memory (docs/host_bridge.md): Blob::Borrow wraps
  // caller bytes without copying; the keepalive's deleter fires when
  // the LAST shallow copy dies — the arena's "wire is done" signal.
  float ext[4] = {1.0f, 2.0f, 3.0f, 4.0f};
  int released = 0;
  {
    mvtpu::Blob outer;
    {
      auto keep = std::shared_ptr<void>(
          static_cast<void*>(ext), [&released](void*) { ++released; });
      mvtpu::Blob b = mvtpu::Blob::Borrow(ext, sizeof(ext), keep);
      CHECK(b.borrowed());
      CHECK(b.size() == sizeof(ext));
      CHECK(b.As<float>() == ext);  // zero copy: the caller's bytes
      outer = b;                    // shallow copy shares the keepalive
    }
    CHECK(released == 0);  // a live copy still pins the buffer
    CHECK(outer.As<float>()[2] == 3.0f);
    // CopyFrom flattens a borrow into an owning blob and drops the hook.
    mvtpu::Blob deep;
    deep.CopyFrom(outer);
    CHECK(!deep.borrowed());
    CHECK(deep.As<float>() != ext);
    CHECK(deep.As<float>()[3] == 4.0f);
  }
  CHECK(released == 1);  // last copy died -> exactly one release
  return 0;
}

static int TestArena() {
  auto* arena = mvtpu::HostArena::Get();
  // 64-byte alignment by construction (the MV008 contiguity guarantee).
  void* a = arena->Acquire(6144);
  void* b = arena->Acquire(6144);
  CHECK(a && b && a != b);
  CHECK(reinterpret_cast<uintptr_t>(a) % 64 == 0);
  CHECK(reinterpret_cast<uintptr_t>(b) % 64 == 0);
  // BufferOf: containment gate of the *Borrowed C API.
  char* ca = static_cast<char*>(a);
  CHECK(arena->BufferOf(ca, 6144) == a);
  CHECK(arena->BufferOf(ca + 100, 6044) == a);
  CHECK(arena->BufferOf(ca + 100, 6144) == nullptr);  // overruns
  int unknown[1];
  CHECK(arena->BufferOf(unknown, 4) == nullptr);
  // Release/recycle: same capacity comes back off the free list.
  CHECK(arena->Release(b) == 0);
  CHECK(arena->Release(b) == -2);       // double release
  CHECK(arena->Release(unknown) == -1);  // not arena memory
  void* b2 = arena->Acquire(6144);
  CHECK(b2 == b);  // recycled
  // DEFERRED recycle (the borrowed-lifetime regression, red on a naive
  // arena that recycles on caller release alone): while a native borrow
  // is in flight, Release must NOT put the buffer back in rotation —
  // an Acquire of the same size gets fresh memory, not the borrowed
  // bytes a late wire write could still read.
  void* c = nullptr;
  {
    auto hold = arena->BorrowHold(a);
    CHECK(hold);
    CHECK(arena->Release(a) == 0);          // safe mid-flight
    c = arena->Acquire(6144);
    CHECK(c != a);                          // NOT handed back while held
    CHECK(arena->BufferOf(ca, 64) == nullptr);  // released: not borrowable
  }                                         // hold drops -> recycle fires
  void* a2 = arena->Acquire(6144);          // c is still caller-held, so
  CHECK(a2 == a);                           // this must be the recycle
  auto st = arena->GetStats();
  CHECK(st.deferred >= 1);
  CHECK(st.recycled >= 2);
  CHECK(arena->Release(c) == 0);
  CHECK(arena->Release(a2) == 0);
  CHECK(arena->Release(b2) == 0);
  return 0;
}

static int TestQueue() {
  mvtpu::MtQueue<int> q;
  const int kN = 1000;
  std::thread producer([&] {
    for (int i = 0; i < kN; ++i) q.Push(i);
  });
  long long sum = 0;
  int got = 0, v;
  while (got < kN && q.Pop(&v)) {
    sum += v;
    ++got;
  }
  producer.join();
  CHECK(got == kN);
  CHECK(sum == (long long)kN * (kN - 1) / 2);
  q.Exit();
  CHECK(!q.Pop(&v));
  return 0;
}

static int TestConfigure() {
  namespace cfg = mvtpu::configure;
  cfg::RegisterDefaults();
  cfg::Reset();
  CHECK(cfg::GetBool("sync") == false);
  const char* argv[] = {"-sync=true", "-updater_type=sgd", "notaflag",
                        "-port=1234"};
  CHECK(cfg::ParseCmdFlags(4, argv) == 3);
  CHECK(cfg::GetBool("sync") == true);
  CHECK(cfg::GetString("updater_type") == "sgd");
  CHECK(cfg::GetInt("port") == 1234);
  const char* bad[] = {"-port=notanint"};
  CHECK(cfg::ParseCmdFlags(1, bad) == -1);
  const char* unknown[] = {"-no_such_flag=1"};
  CHECK(cfg::ParseCmdFlags(1, unknown) == -1);
  cfg::Reset();
  CHECK(cfg::GetBool("sync") == false);
  return 0;
}

static int TestMessage() {
  mvtpu::Message m;
  m.src = 1;
  m.dst = 2;
  m.type = mvtpu::MsgType::RequestAdd;
  m.table_id = 7;
  m.msg_id = 99;
  m.trace_id = 0x5551234;
  float payload[3] = {1.0f, 2.0f, 3.0f};
  int32_t rows[2] = {4, 5};
  m.data.emplace_back(payload, sizeof(payload));
  m.data.emplace_back(rows, sizeof(rows));
  mvtpu::Blob wire = m.Serialize();
  mvtpu::Message back = mvtpu::Message::Deserialize(wire);
  CHECK(back.src == 1 && back.dst == 2 && back.table_id == 7 &&
        back.msg_id == 99);
  CHECK(back.trace_id == 0x5551234);
  CHECK(back.type == mvtpu::MsgType::RequestAdd);
  CHECK(back.data.size() == 2);
  CHECK(back.data[0].count<float>() == 3);
  CHECK(back.data[0].As<float>()[2] == 3.0f);
  CHECK(back.data[1].As<int32_t>()[1] == 5);
  return 0;
}

static int TestLatencyTrail() {
  using mvtpu::latency::NowNs;
  mvtpu::latency::Reset();
  mvtpu::latency::Arm(true);

  // ---- trail rides the wire only when flagged (version tolerance) ---
  mvtpu::Message plain;
  plain.type = mvtpu::MsgType::RequestGet;
  float payload[2] = {1.0f, 2.0f};
  plain.data.emplace_back(payload, sizeof(payload));
  int64_t plain_bytes = plain.WireBytes();
  mvtpu::Message req = plain;
  mvtpu::latency::StampEnqueue(&req);
  CHECK(req.has_timing());
  CHECK(req.WireBytes() == plain_bytes +
        static_cast<int64_t>(sizeof(mvtpu::TimingTrail)));
  mvtpu::latency::StampSend(&req);
  mvtpu::Message back = mvtpu::Message::Deserialize(req.Serialize());
  CHECK(back.has_timing());
  CHECK(back.timing.t[mvtpu::TimingTrail::kEnqueue] ==
        req.timing.t[mvtpu::TimingTrail::kEnqueue]);
  CHECK(back.timing.t[mvtpu::TimingTrail::kSend] ==
        req.timing.t[mvtpu::TimingTrail::kSend]);
  // Old-header frame (no flag): parses exactly as before, no trail.
  mvtpu::Message old_back = mvtpu::Message::Deserialize(plain.Serialize());
  CHECK(!old_back.has_timing());
  CHECK(old_back.data.size() == 1 && old_back.data[0].count<float>() == 2);
  // Zero-copy path agrees.
  mvtpu::Blob w = req.Serialize();
  auto slab = std::make_shared<std::vector<char>>(w.data(),
                                                  w.data() + w.size());
  mvtpu::Message view;
  CHECK(mvtpu::Message::DeserializeView(slab, 0, slab->size(), &view));
  CHECK(view.has_timing());
  CHECK(view.timing.t[mvtpu::TimingTrail::kSend] ==
        req.timing.t[mvtpu::TimingTrail::kSend]);
  // A flagged frame too short for the trail is malformed, not misread.
  auto runt = std::make_shared<std::vector<char>>(
      slab->begin(), slab->begin() + sizeof(mvtpu::WireHeader));
  mvtpu::Message bad;
  CHECK(!mvtpu::Message::DeserializeView(runt, 0, runt->size(), &bad));

  // ---- stamp-once / reply-slot discipline ---------------------------
  mvtpu::latency::StampRecv(&back);
  int64_t recv1 = back.timing.t[mvtpu::TimingTrail::kRecv];
  CHECK(recv1 != 0);
  mvtpu::latency::StampRecv(&back);  // duplicate keeps the first
  CHECK(back.timing.t[mvtpu::TimingTrail::kRecv] == recv1);
  mvtpu::latency::StampDequeue(&back);
  mvtpu::Message reply;
  reply.type = mvtpu::MsgType::ReplyGet;
  mvtpu::latency::StampReply(back, &reply);
  CHECK(reply.has_timing());
  CHECK(reply.timing.t[mvtpu::TimingTrail::kApplyDone] != 0);
  mvtpu::latency::StampSend(&reply);  // reply type -> reply-send slot
  CHECK(reply.timing.t[mvtpu::TimingTrail::kReplySend] != 0);
  CHECK(reply.timing.t[mvtpu::TimingTrail::kSend] ==
        req.timing.t[mvtpu::TimingTrail::kSend]);

  // ---- OnReply: stages recorded + an offset estimate materializes ---
  // Simulate a peer clock running exactly 5 ms ahead by shifting the
  // server-side stamps; the NTP sample must recover ~that offset.
  const int64_t kShift = 5'000'000;
  reply.timing.t[mvtpu::TimingTrail::kRecv] += kShift;
  reply.timing.t[mvtpu::TimingTrail::kDequeue] += kShift;
  reply.timing.t[mvtpu::TimingTrail::kApplyDone] += kShift;
  reply.timing.t[mvtpu::TimingTrail::kReplySend] += kShift;
  mvtpu::Dashboard::Reset();
  mvtpu::latency::OnReply(reply, 3);
  long long n = 0;
  CHECK(mvtpu::Dashboard::Query("lat.total", &n, nullptr) && n == 1);
  CHECK(mvtpu::Dashboard::Query("lat.stage.apply", &n, nullptr) && n == 1);
  int64_t off = 0, rtt = 0;
  CHECK(mvtpu::latency::PeerOffset(3, &off, &rtt));
  // The estimate absorbs the handler wall time between the stamps, so
  // only bound it loosely around the injected shift.
  CHECK(off > kShift / 2 && off < kShift * 2);
  CHECK(rtt >= 0);
  CHECK(!mvtpu::latency::PeerOffset(99, &off, &rtt));

  // Disarmed: StampEnqueue mints nothing.
  mvtpu::latency::Arm(false);
  mvtpu::Message dis;
  mvtpu::latency::StampEnqueue(&dis);
  CHECK(!dis.has_timing());
  mvtpu::latency::Arm(true);
  mvtpu::latency::Reset();
  return 0;
}

static int TestAudit() {
  mvtpu::audit::Arm(true);

  // ---- stamp rides the wire only when flagged (version tolerance) ---
  mvtpu::Message plain;
  plain.type = mvtpu::MsgType::RequestAdd;
  float payload[2] = {1.0f, 2.0f};
  plain.data.emplace_back(payload, sizeof(payload));
  int64_t plain_bytes = plain.WireBytes();
  mvtpu::Message req = plain;
  req.flags |= mvtpu::msgflag::kHasAudit;
  req.audit = {7, 12};
  CHECK(req.WireBytes() == plain_bytes +
        static_cast<int64_t>(sizeof(mvtpu::AuditStamp)));
  mvtpu::Message back = mvtpu::Message::Deserialize(req.Serialize());
  CHECK(back.has_audit());
  CHECK(back.audit.seq_lo == 7 && back.audit.seq_hi == 12);
  // Old-header frame (no flag) parses exactly as before, no stamp.
  mvtpu::Message old_back = mvtpu::Message::Deserialize(plain.Serialize());
  CHECK(!old_back.has_audit());
  CHECK(old_back.data.size() == 1 && old_back.data[0].count<float>() == 2);
  // Timing trail + audit stamp compose (trail first, Serialize order).
  mvtpu::latency::Arm(true);
  mvtpu::latency::StampEnqueue(&req);
  mvtpu::Blob w = req.Serialize();
  auto slab = std::make_shared<std::vector<char>>(w.data(),
                                                  w.data() + w.size());
  mvtpu::Message view;
  CHECK(mvtpu::Message::DeserializeView(slab, 0, slab->size(), &view));
  CHECK(view.has_timing() && view.has_audit());
  CHECK(view.audit.seq_lo == 7 && view.audit.seq_hi == 12);
  CHECK(view.data[0].count<float>() == 2);
  // A flagged frame too short for the stamp is malformed, not misread.
  auto runt = std::make_shared<std::vector<char>>(
      slab->begin(), slab->begin() + sizeof(mvtpu::WireHeader));
  mvtpu::Message bad;
  CHECK(!mvtpu::Message::DeserializeView(runt, 0, runt->size(), &bad));

  // ---- AckLedger: dense per-shard streams + agg range accounting ----
  mvtpu::audit::AckLedger led;
  int64_t lo = 0, hi = 0;
  led.NextRange(0, 1, &lo, &hi);
  CHECK(lo == 1 && hi == 1);
  led.NextRange(0, 6, &lo, &hi);       // a 6-add agg flush window
  CHECK(lo == 2 && hi == 7);
  led.NextRange(1, 1, &lo, &hi);       // shard 1 is its own stream
  CHECK(lo == 1 && hi == 1);
  led.Ack(0, 7);
  led.Ack(0, 3);                       // stale ack never rolls back
  auto snap = led.Snapshot();
  CHECK(snap.size() == 2);
  CHECK(snap[0].sent == 7 && snap[0].acked == 7);
  CHECK(snap[1].sent == 1 && snap[1].acked == 0);

  // ---- DeliveryBook: advance / dup / reorder / drain ----------------
  mvtpu::audit::DeliveryBook book;
  book.NoteApply(2, 1, 1, 0);
  book.NoteApply(2, 2, 7, 0);          // agg range advances to 7
  book.NoteApply(2, 2, 7, 0);          // retry dup: visible, no advance
  book.NoteApply(2, 9, 9, 0);          // hole at 8: parked
  book.NoteApply(2, 10, 10, 0);        // still parked
  book.NoteApply(2, 8, 8, 0);          // hole filled: drains to 10
  std::string j = book.Json();
  CHECK(j.find("\"watermark\":10") != std::string::npos);
  CHECK(j.find("\"dups\":1") != std::string::npos);
  CHECK(j.find("\"reorders\":2") != std::string::npos);
  CHECK(j.find("\"pending\":[]") != std::string::npos);
  CHECK(j.find("\"kind\":\"dup\"") != std::string::npos);

  // ---- seq wraparound safety near INT64_MAX -------------------------
  // The books compare, never add, beyond +1 — a stream living at the
  // top of the seq space must not overflow into a phantom gap.
  mvtpu::audit::DeliveryBook top;
  const int64_t big = std::numeric_limits<int64_t>::max() - 1;
  top.NoteApply(0, 1, big, 0);
  top.NoteApply(0, big + 1, big + 1, 0);   // contiguous at the top
  std::string tj = top.Json();
  CHECK(tj.find("\"reorders\":0") != std::string::npos);
  CHECK(tj.find("\"dups\":0") != std::string::npos);

  // ---- anomaly ring wraps (bounded), total keeps counting -----------
  mvtpu::audit::DeliveryBook ringy;
  ringy.NoteApply(5, 1, 1, 0);
  for (int i = 0; i < 200; ++i) ringy.NoteApply(5, 1, 1, 0);  // 200 dups
  std::string rj = ringy.Json();
  CHECK(rj.find("\"anomaly_total\":200") != std::string::npos);
  CHECK(rj.find("\"dups\":200") != std::string::npos);

  // ---- checksum primitive -------------------------------------------
  const char* msg = "123456789";
  CHECK(mvtpu::audit::Crc32(msg, 9) == 0xcbf43926u);  // IEEE vector
  // Chaining: Crc32(b, seed=Crc32(a)) == Crc32(a+b).
  CHECK(mvtpu::audit::Crc32(msg + 4, 5, mvtpu::audit::Crc32(msg, 4)) ==
        mvtpu::audit::Crc32(msg, 9));

  // Bit-exact assign stores leave bit-identical bucket checksums; a
  // single changed element changes exactly its bucket's beacon.
  mvtpu::MatrixServerTable a(8, 4, mvtpu::UpdaterType::kAssign);
  mvtpu::MatrixServerTable b(8, 4, mvtpu::UpdaterType::kAssign);
  std::vector<float> rows(2 * 4, 1.5f);
  int32_t ids[2] = {1, 6};
  for (mvtpu::MatrixServerTable* t : {&a, &b}) {
    mvtpu::Message add;
    add.src = 3;
    mvtpu::AddOption opt;
    add.data.emplace_back(&opt, sizeof(opt));
    add.data.emplace_back(ids, sizeof(ids));
    add.data.emplace_back(rows.data(), rows.size() * sizeof(float));
    t->ProcessAdd(add);
  }
  auto ca = a.BucketChecksums();
  auto cb = b.BucketChecksums();
  CHECK(ca.size() == cb.size() && ca == cb);
  {
    mvtpu::Message add;
    add.src = 3;
    mvtpu::AddOption opt;
    int32_t one = 6;
    float bump[4] = {0.25f, 0, 0, 0};
    add.data.emplace_back(&opt, sizeof(opt));
    add.data.emplace_back(&one, sizeof(one));
    add.data.emplace_back(bump, sizeof(bump));
    b.ProcessAdd(add);
  }
  cb = b.BucketChecksums();
  int diffs = 0;
  for (size_t i = 0; i < ca.size(); ++i) diffs += ca[i] != cb[i];
  CHECK(diffs == 1);
  CHECK(ca[6 % mvtpu::ServerTable::kVersionBuckets] !=
        cb[6 % mvtpu::ServerTable::kVersionBuckets]);

  // ---- server-side booking via the table hook -----------------------
  mvtpu::Message stamped;
  stamped.src = 4;
  stamped.flags |= mvtpu::msgflag::kHasAudit;
  stamped.audit = {1, 3};
  a.NoteAuditApply(stamped);
  CHECK(a.audit_book().Json().find("\"watermark\":3") !=
        std::string::npos);

  // ---- disarmed: stamps nothing, books nothing ----------------------
  mvtpu::audit::Arm(false);
  mvtpu::Message dis;
  dis.src = 4;
  dis.flags |= mvtpu::msgflag::kHasAudit;
  dis.audit = {4, 4};
  a.NoteAuditApply(dis);
  CHECK(a.audit_book().Json().find("\"watermark\":3") !=
        std::string::npos);
  mvtpu::audit::Arm(true);
  return 0;
}

static int TestCodec() {
  using mvtpu::Blob;
  using mvtpu::codec::DecodeOneBit;
  using mvtpu::codec::DecodeSparse;
  using mvtpu::codec::EncodeOneBit;
  using mvtpu::codec::EncodeSparse;

  // ---- sparse: lossless round trips across the edge cases -----------
  {
    // Mostly-zero ODD-length payload with NaN/Inf nonzeros: bit-exact
    // round trip (sparse pays off once nonzeros < n/2 - 2).
    float d[33] = {0};
    d[1] = 1.5f;
    d[4] = -2.25f;
    d[31] = std::numeric_limits<float>::quiet_NaN();
    d[32] = std::numeric_limits<float>::infinity();
    Blob enc = EncodeSparse(d, 33);
    CHECK(enc.size() > 0 && enc.size() < 33 * sizeof(float));
    std::vector<float> out;
    CHECK(DecodeSparse(enc, &out));
    CHECK(out.size() == 33);
    CHECK(memcmp(out.data(), d, sizeof(d)) == 0);  // NaN survives memcmp
  }
  {
    // Empty payload: the sparse form (16 bytes) is never smaller than
    // 0 raw bytes — the encoder must fall back to raw.
    Blob enc = EncodeSparse(nullptr, 0);
    CHECK(enc.size() == 0);
  }
  {
    // Dense payload: no benefit, raw fallback signalled by empty blob.
    float d[4] = {1, 2, 3, 4};
    CHECK(EncodeSparse(d, 4).size() == 0);
  }
  {
    // Malformed payloads must decode false, not overread.
    std::vector<float> out;
    CHECK(!DecodeSparse(Blob("xy", 2), &out));
    int64_t bad[2] = {8, 9};  // k > n
    CHECK(!DecodeSparse(Blob(bad, sizeof(bad)), &out));
  }

  // ---- 1bit: shapes, signs, error-feedback drain --------------------
  {
    // Odd length, mixed signs, no residual.
    float d[5] = {1.0f, -3.0f, 2.0f, -1.0f, 0.0f};
    Blob enc = EncodeOneBit(d, 5, nullptr);
    CHECK(enc.size() == 16 + 1);  // header + one bit byte
    std::vector<float> out;
    CHECK(DecodeOneBit(enc, &out));
    CHECK(out.size() == 5);
    CHECK(fabsf(out[0] - 1.0f) < 1e-6f);   // pos mean = (1+2+0)/3
    CHECK(fabsf(out[1] + 2.0f) < 1e-6f);   // neg mean = (-3-1)/2
    CHECK(out[0] == out[2] && out[1] == out[3] && out[0] == out[4]);
  }
  {
    // All-negative payload: pos bucket empty -> pos_scale 0, decode ok.
    float d[3] = {-1.0f, -2.0f, -3.0f};
    std::vector<float> out;
    CHECK(DecodeOneBit(EncodeOneBit(d, 3, nullptr), &out));
    CHECK(fabsf(out[0] + 2.0f) < 1e-6f && out[0] == out[1]);
  }
  {
    // Empty payload round-trips to an empty vector.
    std::vector<float> out{1.0f};
    CHECK(DecodeOneBit(EncodeOneBit(nullptr, 0, nullptr), &out));
    CHECK(out.empty());
  }
  {
    // Non-finite inputs are sanitized: finite scales, zeroed residual.
    float d[4] = {std::numeric_limits<float>::quiet_NaN(),
                  -std::numeric_limits<float>::infinity(), 2.0f, -2.0f};
    float res[4] = {0, 0, 0, 0};
    std::vector<float> out;
    CHECK(DecodeOneBit(EncodeOneBit(d, 4, res), &out));
    for (float v : out) CHECK(std::isfinite(v));
    CHECK(res[0] == 0.0f && res[1] == 0.0f);
    for (float v : res) CHECK(std::isfinite(v));
  }
  {
    // Error feedback: repeated compress/apply with a ROTATING deviation
    // pattern (real gradients fluctuate; a constant per-element
    // deviation is the known two-global-scale pathology where the
    // residual grows linearly).  Over full rotation cycles every
    // element's true sum is kSteps * 0.7 exactly; the applied sum must
    // track it with the residual bounded by one cycle's spread —
    // i.e. the error DRAINS into later messages instead of
    // accumulating.
    const int kN = 16, kSteps = 60;  // 12 full cycles of 5
    float delta[kN], res[kN] = {0};
    std::vector<float> applied(kN, 0.0f);
    for (int s = 0; s < kSteps; ++s) {
      for (int i = 0; i < kN; ++i)
        delta[i] = 0.5f + 0.1f * static_cast<float>((i + s) % 5);
      std::vector<float> out;
      CHECK(DecodeOneBit(EncodeOneBit(delta, kN, res), &out));
      for (int i = 0; i < kN; ++i) applied[i] += out[i];
    }
    const float want = 0.7f * kSteps;
    for (int i = 0; i < kN; ++i) {
      CHECK(fabsf(applied[i] - want) < 1.0f);
      CHECK(fabsf(applied[i] - want) / want < 0.02f);
      CHECK(fabsf(res[i]) < 1.0f);  // drained, not accumulated
    }
  }

  // ---- header stamp + in-place decode (the server's path) -----------
  {
    mvtpu::Message m;
    m.type = mvtpu::MsgType::RequestAdd;
    float d[16] = {0};
    d[2] = 4.0f;
    d[15] = -1.0f;
    Blob enc = EncodeSparse(d, 16);
    CHECK(enc.size() > 0);
    m.codec = mvtpu::Codec::kSparse;
    m.flags = mvtpu::msgflag::kAcceptRaw | mvtpu::msgflag::kAcceptSparse;
    m.data.push_back(enc);
    // Codec + flags survive the wire header round trip.
    mvtpu::Message back = mvtpu::Message::Deserialize(m.Serialize());
    CHECK(back.codec == mvtpu::Codec::kSparse);
    CHECK(back.flags == m.flags);
    CHECK(mvtpu::codec::DecodeInPlace(&back));
    CHECK(back.codec == mvtpu::Codec::kRaw);
    CHECK(back.data[0].count<float>() == 16);
    CHECK(back.data[0].As<float>()[2] == 4.0f);
    CHECK(back.data[0].As<float>()[15] == -1.0f);
    // Reply encoding honors the accept list: raw-only stays raw.
    mvtpu::Message reply;
    reply.data.emplace_back(d, sizeof(d));
    mvtpu::codec::MaybeEncodeReply(&reply, mvtpu::msgflag::kAcceptRaw);
    CHECK(reply.codec == mvtpu::Codec::kRaw);
    mvtpu::codec::MaybeEncodeReply(
        &reply, mvtpu::msgflag::kAcceptRaw | mvtpu::msgflag::kAcceptSparse);
    CHECK(reply.codec == mvtpu::Codec::kSparse);
    CHECK(reply.data[0].size() < sizeof(d));
  }
  return 0;
}

static int TestDashboard() {
  using mvtpu::Dashboard;
  Dashboard::Reset();
  Dashboard::Record("Unit::fast", 2e-6);   // bucket 1 (<= 2 µs)
  Dashboard::Record("Unit::fast", 2e-6);
  Dashboard::Record("Unit::slow", 1e-3);
  long long c = 0;
  double t = 0.0;
  CHECK(Dashboard::Query("Unit::fast", &c, &t) && c == 2);
  // One-call enumeration: both monitors, with bucket columns.
  std::string dump = Dashboard::Dump();
  CHECK(dump.find("Unit::fast\t2\t") != std::string::npos);
  CHECK(dump.find("Unit::slow\t1\t") != std::string::npos);
  CHECK(std::count(dump.begin(), dump.end(), '\n') == 2);
  // Spans: a Monitor under tracing records one span; nested monitors on
  // the same thread share the generated trace id.
  Dashboard::SetTraceRank(3);
  Dashboard::SetTraceEnabled(true);
  {
    mvtpu::Monitor outer("Unit::outer");
    mvtpu::Monitor inner("Unit::inner");
  }
  Dashboard::SetTraceEnabled(false);
  std::string spans = Dashboard::DumpSpans();
  CHECK(spans.find("Unit::outer\t") != std::string::npos);
  CHECK(spans.find("Unit::inner\t") != std::string::npos);
  // Same trace id on both lines (field 2), carrying the rank-3 salt.
  long long id_outer = 0, id_inner = 0;
  CHECK(sscanf(spans.c_str() + spans.find("Unit::inner\t") + 12, "%lld",
               &id_inner) == 1);
  CHECK(sscanf(spans.c_str() + spans.find("Unit::outer\t") + 12, "%lld",
               &id_outer) == 1);
  CHECK(id_outer == id_inner);
  CHECK((id_outer >> 40) == 4);  // rank + 1
  // Thread-local cleaned up: next monitor outside tracing stays span-free.
  CHECK(Dashboard::ThreadTraceId() == 0);
  Dashboard::ClearSpans();
  CHECK(Dashboard::DumpSpans().empty());
  Dashboard::SetTraceRank(0);
  Dashboard::Reset();
  return 0;
}

static int TestUpdater() {
  using mvtpu::AddOption;
  using mvtpu::UpdaterType;
  AddOption opt;
  opt.learning_rate = 0.5f;
  float w[2] = {1.0f, 1.0f}, d[2] = {2.0f, 2.0f};
  mvtpu::ApplyUpdate(UpdaterType::kSGD, opt, w, nullptr, d, 2);
  CHECK(w[0] == 0.0f);
  // adagrad twice matches the JAX test: -0.1 - 0.1/sqrt(2)
  opt.learning_rate = 0.1f;
  opt.eps = 1e-8f;
  float w2[1] = {0.0f}, h[1] = {0.0f}, g[1] = {1.0f};
  mvtpu::ApplyUpdate(UpdaterType::kAdaGrad, opt, w2, h, g, 1);
  mvtpu::ApplyUpdate(UpdaterType::kAdaGrad, opt, w2, h, g, 1);
  float expect = -0.1f - 0.1f / sqrtf(2.0f);
  CHECK(fabsf(w2[0] - expect) < 1e-5f);
  // assign: stored bits == pushed bits (the offload bridge's bit-exact
  // remote store, docs/host_bridge.md); repeated assigns do not
  // accumulate, and NumSlots is 0 (no optimizer state of its own).
  CHECK(mvtpu::NumSlots(UpdaterType::kAssign) == 0);
  CHECK(mvtpu::UpdaterFromName("assign") == UpdaterType::kAssign);
  CHECK(mvtpu::IsUpdaterName("assign"));
  float w3[2] = {7.0f, -7.0f}, d3[2] = {0.25f, -1.5f};
  mvtpu::ApplyUpdate(UpdaterType::kAssign, opt, w3, nullptr, d3, 2);
  mvtpu::ApplyUpdate(UpdaterType::kAssign, opt, w3, nullptr, d3, 2);
  CHECK(w3[0] == 0.25f && w3[1] == -1.5f);
  return 0;
}

static int TestArray() {
  const char* argv[] = {"-updater_type=default", "-log_level=error"};
  CHECK(MV_Init(2, argv) == 0);
  int32_t h;
  CHECK(MV_NewArrayTable(64, &h) == 0);
  std::vector<float> delta(64, 1.0f), out(64, -1.0f);
  CHECK(MV_AddArrayTable(h, delta.data(), 64) == 0);
  CHECK(MV_AddAsyncArrayTable(h, delta.data(), 64) == 0);
  CHECK(MV_Barrier() == 0);  // flushes the async add
  CHECK(MV_GetArrayTable(h, out.data(), 64) == 0);
  for (float v : out) CHECK(v == 2.0f);
  CHECK(MV_NumWorkers() == 1 && MV_WorkerId() == 0 && MV_ServerId() == 0);
  return 0;
}

static int TestMatrix() {
  int32_t h;
  CHECK(MV_NewMatrixTable(8, 4, &h) == 0);
  std::vector<float> all(32, 0.5f), out(32, 0.0f);
  CHECK(MV_AddMatrixTableAll(h, all.data(), 32) == 0);
  int32_t rows[3] = {1, 3, 1};  // duplicate row composes sequentially
  std::vector<float> rd(12, 1.0f), rout(8, 0.0f);
  CHECK(MV_AddMatrixTableByRows(h, rd.data(), rows, 3, 4) == 0);
  int32_t qrows[2] = {1, 3};
  CHECK(MV_GetMatrixTableByRows(h, rout.data(), qrows, 2, 4) == 0);
  for (int c = 0; c < 4; ++c) {
    CHECK(rout[c] == 2.5f);       // row 1: 0.5 + 1 + 1
    CHECK(rout[4 + c] == 1.5f);   // row 3: 0.5 + 1
  }
  CHECK(MV_GetMatrixTableAll(h, out.data(), 32) == 0);
  CHECK(out[0] == 0.5f);
  return 0;
}

static int TestBridge() {
  // Host-bridge fast path over the C API (docs/host_bridge.md); runs
  // after `array` armed the single-process runtime.  Every payload here
  // lives in a HostArena buffer and ships borrowed — zero payload copy
  // on the send side.
  int32_t h;
  CHECK(MV_NewArrayTable(48, &h) == 0);
  void* p = nullptr;
  CHECK(MV_ArenaAcquire(48 * sizeof(float), &p) == 0);
  float* buf = static_cast<float*>(p);
  for (int i = 0; i < 48; ++i) buf[i] = static_cast<float>(i);
  // Borrowed calls FAIL LOUDLY on non-arena memory (rc -7, nothing
  // sent) — the contract mvlint MV012 polices from the Python side.
  std::vector<float> heap(48, 1.0f);
  CHECK(MV_AddArrayTableBorrowed(h, heap.data(), 48) == -7);
  CHECK(MV_GetArrayTableBorrowed(h, heap.data(), 48) == -7);
  // Blocking borrowed add + borrowed get into a second arena buffer.
  CHECK(MV_AddArrayTableBorrowed(h, buf, 48) == 0);
  void* po = nullptr;
  CHECK(MV_ArenaAcquire(48 * sizeof(float), &po) == 0);
  float* out = static_cast<float*>(po);
  CHECK(MV_GetArrayTableBorrowed(h, out, 48) == 0);
  for (int i = 0; i < 48; ++i) CHECK(out[i] == static_cast<float>(i));
  // Async borrowed add: the arena defers the buffer past the in-flight
  // send; the barrier flushes, then values must read back doubled.
  CHECK(MV_AddAsyncArrayTableBorrowed(h, buf, 48) == 0);
  CHECK(MV_Barrier() == 0);
  CHECK(MV_GetArrayTableBorrowed(h, out, 48) == 0);
  for (int i = 0; i < 48; ++i) CHECK(out[i] == 2.0f * i);
  // Async borrowed get + EARLY caller release: the ticket's arena hold
  // keeps the destination un-recycled until MV_WaitGet consumes it — an
  // Acquire of the same size mid-flight must get different memory.
  int32_t ticket = -1;
  CHECK(MV_GetAsyncArrayTableBorrowed(h, out, 48, &ticket) == 0);
  CHECK(MV_ArenaRelease(po) == 0);  // safe: recycle deferred past Wait
  void* other = nullptr;
  CHECK(MV_ArenaAcquire(48 * sizeof(float), &other) == 0);
  CHECK(other != po);
  CHECK(MV_WaitGet(ticket) == 0);
  for (int i = 0; i < 48; ++i) CHECK(out[i] == 2.0f * i);
  CHECK(MV_ArenaRelease(other) == 0);
  // Matrix plane: whole-table + by-rows borrowed (single shard -> the
  // no-staging fast path) + async borrowed row get.
  int32_t hm;
  CHECK(MV_NewMatrixTable(6, 4, &hm) == 0);
  void* pm = nullptr;
  CHECK(MV_ArenaAcquire(24 * sizeof(float), &pm) == 0);
  float* md = static_cast<float*>(pm);
  for (int i = 0; i < 24; ++i) md[i] = 0.5f;
  CHECK(MV_AddMatrixTableAllBorrowed(hm, md, 24) == 0);
  int32_t rows[2] = {1, 4};
  CHECK(MV_AddMatrixTableByRowsBorrowed(hm, md, rows, 2, 4) == 0);
  int32_t bad_rows[2] = {1, 99};  // out of range: staging path handles
  CHECK(MV_AddMatrixTableByRowsBorrowed(hm, md, bad_rows, 2, 4) == 0);
  void* pr = nullptr;
  CHECK(MV_ArenaAcquire(8 * sizeof(float), &pr) == 0);
  float* rout = static_cast<float*>(pr);
  int32_t t2 = -1;
  CHECK(MV_GetAsyncMatrixTableByRowsBorrowed(hm, rout, rows, 2, 4, &t2)
        == 0);
  CHECK(MV_WaitGet(t2) == 0);
  for (int c = 0; c < 4; ++c) {
    CHECK(rout[c] == 1.5f);      // row 1: 0.5 + 0.5 + 0.5
    CHECK(rout[4 + c] == 1.0f);  // row 4: 0.5 + 0.5
  }
  CHECK(MV_ArenaRelease(pr) == 0);
  CHECK(MV_ArenaRelease(pm) == 0);
  CHECK(MV_ArenaRelease(p) == 0);
  long long buffers = 0, in_flight = 0, deferred = 0;
  CHECK(MV_ArenaStats(&buffers, nullptr, nullptr, &in_flight, &deferred,
                      nullptr, nullptr) == 0);
  CHECK(in_flight == 0);   // every borrowed send drained
  CHECK(deferred >= 1);    // the early release above was deferred
  return 0;
}

static int TestCheckpoint() {
  int32_t h;
  CHECK(MV_NewArrayTable(16, &h) == 0);
  std::vector<float> delta(16, 3.0f), out(16, 0.0f);
  CHECK(MV_AddArrayTable(h, delta.data(), 16) == 0);
  const char* path = "/tmp/mvtpu_native_ck.bin";
  CHECK(MV_StoreTable(h, path) == 0);
  CHECK(MV_AddArrayTable(h, delta.data(), 16) == 0);
  CHECK(MV_LoadTable(h, path) == 0);
  CHECK(MV_GetArrayTable(h, out.data(), 16) == 0);
  for (float v : out) CHECK(v == 3.0f);
  return 0;
}

static int TestSparseMatrix() {
  // Worker row cache: own adds invalidate their rows; a barrier (clock)
  // invalidates everything; reads serve correct values throughout.
  int32_t h;
  CHECK(MV_NewSparseMatrixTable(6, 4, &h) == 0);
  int32_t rows[2] = {1, 4};
  std::vector<float> d(8, 2.0f), out(8, -1.0f);
  CHECK(MV_AddMatrixTableByRows(h, d.data(), rows, 2, 4) == 0);
  CHECK(MV_GetMatrixTableByRows(h, out.data(), rows, 2, 4) == 0);
  for (float v : out) CHECK(v == 2.0f);          // cache filled
  CHECK(MV_GetMatrixTableByRows(h, out.data(), rows, 2, 4) == 0);
  for (float v : out) CHECK(v == 2.0f);          // cache hit, same value
  CHECK(MV_AddMatrixTableByRows(h, d.data(), rows, 2, 4) == 0);
  CHECK(MV_GetMatrixTableByRows(h, out.data(), rows, 2, 4) == 0);
  for (float v : out) CHECK(v == 4.0f);          // own add invalidated
  CHECK(MV_Barrier() == 0);                      // clock invalidate
  CHECK(MV_GetMatrixTableByRows(h, out.data(), rows, 2, 4) == 0);
  for (float v : out) CHECK(v == 4.0f);
  // An SSP tick (MV_Clock) must invalidate the cache like a barrier —
  // a cache hit would bypass the server's -staleness enforcement.
  // Observable via the base table's wire-fetch monitor: warm reads
  // don't touch it, the post-tick read must.
  long long wire0 = 0, wire1 = 0, wire2 = 0;
  double tot = 0.0;
  mvtpu::Dashboard::Query("MatrixWorker::GetRows", &wire0, &tot);
  CHECK(MV_GetMatrixTableByRows(h, out.data(), rows, 2, 4) == 0);
  mvtpu::Dashboard::Query("MatrixWorker::GetRows", &wire1, &tot);
  CHECK(wire1 == wire0);                         // warm: pure cache hit
  CHECK(MV_Clock() == 0);
  CHECK(MV_GetMatrixTableByRows(h, out.data(), rows, 2, 4) == 0);
  mvtpu::Dashboard::Query("MatrixWorker::GetRows", &wire2, &tot);
  CHECK(wire2 == wire1 + 1);                     // tick forced a re-fetch
  for (float v : out) CHECK(v == 4.0f);
  int32_t oob[1] = {99};
  std::vector<float> zout(4, -1.0f);
  CHECK(MV_GetMatrixTableByRows(h, zout.data(), oob, 1, 4) == 0);
  for (float v : zout) CHECK(v == 0.0f);         // out-of-range zeros
  return 0;
}

static int TestKV() {
  // Single-process KV round trips: singles, batch (with a duplicate key
  // summing), absent-key zero reads, and a checkpoint round trip.
  int32_t h;
  CHECK(MV_NewKVTable(&h) == 0);
  float v = -1.0f;
  CHECK(MV_GetKV(h, "absent", &v) == 0);
  CHECK(v == 0.0f);
  CHECK(MV_AddKV(h, "alpha", 2.5f) == 0);
  CHECK(MV_AddAsyncKV(h, "alpha", 0.5f) == 0);
  CHECK(MV_Barrier() == 0);  // flush the async add
  CHECK(MV_GetKV(h, "alpha", &v) == 0);
  CHECK(v == 3.0f);
  // Batch: "bee"+"bee" duplicate must compose to the sum, "sea" lands.
  const char keys[] = "beebeesea";
  int32_t lens[3] = {3, 3, 3};
  float deltas[3] = {1.0f, 2.0f, 4.0f};
  CHECK(MV_AddKVBatch(h, keys, lens, 3, deltas) == 0);
  float vals[3] = {-1, -1, -1};
  CHECK(MV_GetKVBatch(h, keys, lens, 3, vals) == 0);
  CHECK(vals[0] == 3.0f && vals[1] == 3.0f && vals[2] == 4.0f);
  // Checkpoint: mutate after store, load must restore the snapshot.
  const char* path = "/tmp/mvtpu_native_kv_ck.bin";
  CHECK(MV_StoreTable(h, path) == 0);
  CHECK(MV_AddKV(h, "alpha", 10.0f) == 0);
  CHECK(MV_LoadTable(h, path) == 0);
  CHECK(MV_GetKV(h, "alpha", &v) == 0);
  CHECK(v == 3.0f);
  CHECK(MV_GetKV(h, "sea", &v) == 0);
  CHECK(v == 4.0f);
  return 0;
}

static int TestServeVersions() {
  // Serve-layer version protocol (docs/serving.md), single process:
  // fresh tables read version 0; every apply bumps monotonically; the
  // header-only probe (MV_TableVersion) and the free local bound
  // (MV_LastVersion, refreshed by reply stamps) agree; bucket stamps
  // let reads of untouched rows/keys report an older version.
  int32_t h;
  CHECK(MV_NewArrayTable(8, &h) == 0);
  long long v = -1;
  CHECK(MV_TableVersion(h, &v) == 0);
  CHECK(v == 0);
  std::vector<float> ones(8, 1.0f), out(8);
  CHECK(MV_AddArrayTable(h, ones.data(), 8) == 0);
  CHECK(MV_TableVersion(h, &v) == 0);
  CHECK(v == 1);
  // The blocking-add ack stamped the post-apply version locally.
  long long lv = -1;
  CHECK(MV_LastVersion(h, &lv) == 0);
  CHECK(lv == 1);
  CHECK(MV_AddArrayTable(h, ones.data(), 8) == 0);
  CHECK(MV_GetArrayTable(h, out.data(), 8) == 0);
  CHECK(MV_LastVersion(h, &lv) == 0);
  CHECK(lv == 2);
  // KV: adds to one key leave OTHER buckets' read stamps behind the
  // table version (bucket-granular staleness).  Async adds (no ack →
  // no local stamp) so the READ stamps are what last_version observes.
  int32_t kv;
  CHECK(MV_NewKVTable(&kv) == 0);
  CHECK(MV_AddAsyncKV(kv, "hot", 1.0f) == 0);
  CHECK(MV_AddAsyncKV(kv, "hot", 1.0f) == 0);
  CHECK(MV_Barrier() == 0);                 // flush the async adds
  float val = -1.0f;
  CHECK(MV_GetKV(kv, "cold", &val) == 0);   // untouched bucket
  CHECK(MV_LastVersion(kv, &lv) == 0);
  CHECK(lv == 0);  // cold bucket never bumped — read stamped 0
  CHECK(MV_GetKV(kv, "hot", &val) == 0);
  CHECK(val == 2.0f);
  CHECK(MV_LastVersion(kv, &lv) == 0);
  CHECK(lv == 2);  // hot bucket carries both applies
  long long kvv = -1;
  CHECK(MV_TableVersion(kv, &kvv) == 0);
  CHECK(kvv == 2);
  CHECK(MV_ServeQueueDepth() >= 0);
  long long hits = -1, misses = -1;
  CHECK(MV_CacheStats(&hits, &misses) == 0);
  CHECK(hits >= 0 && misses >= 0);
  return 0;
}

static int TestWorkload() {
  using mvtpu::workload::CountMin;
  using mvtpu::workload::KeyHash;
  using mvtpu::workload::SpaceSaving;

  // --- SpaceSaving: planted heavy hitters always surface -------------
  SpaceSaving ss(4);
  for (int round = 0; round < 200; ++round) {
    ss.Offer(KeyHash((int64_t)1), "1", 1);        // 2 in 3 offers: hot
    ss.Offer(KeyHash((int64_t)1), "1", 1);
    ss.Offer(KeyHash((int64_t)(100 + round)), std::to_string(100 + round));
  }
  auto top = ss.TopK();
  CHECK(!top.empty());
  CHECK(top[0].label == "1");
  CHECK(top[0].count - top[0].error <= 400);      // lower bound honest
  CHECK(top[0].count >= 400);                     // upper bound covers
  CHECK(ss.total() == 600);

  // --- CountMin: never underestimates; eps-bounded overestimate ------
  CountMin cm(1024, 4);
  for (int i = 0; i < 5000; ++i) cm.Add(KeyHash((int64_t)(i % 50)));
  for (int i = 0; i < 50; ++i) {
    int64_t est = cm.Estimate(KeyHash((int64_t)i));
    CHECK(est >= 100);                            // true count = 100
    CHECK(est <= 100 + 2 * 5000 * 4 / 1024);      // ~eps*N slack
  }
  CHECK(cm.Estimate(KeyHash((int64_t)999999)) <= 2 * 5000 * 4 / 1024);

  // --- merge across ranks: the fleet-scope fold -----------------------
  SpaceSaving a(4), b(4);
  for (int i = 0; i < 30; ++i) a.Offer(KeyHash((int64_t)7), "7");
  for (int i = 0; i < 20; ++i) b.Offer(KeyHash((int64_t)7), "7");
  b.Offer(KeyHash((int64_t)8), "8");
  a.Merge(b);
  CHECK(a.TopK()[0].label == "7");
  CHECK(a.TopK()[0].count == 50);
  CHECK(a.total() == 51);

  // --- server hot path: skewed row gets -> top-K + skew ratio ---------
  int32_t h;
  CHECK(MV_NewMatrixTable(256, 4, &h) == 0);
  std::vector<float> row(4, 0.5f), got(4);
  std::vector<int32_t> hot_id = {3};
  for (int i = 0; i < 64; ++i) {
    CHECK(MV_AddMatrixTableByRows(h, row.data(), hot_id.data(), 1, 4) == 0);
    CHECK(MV_GetMatrixTableByRows(h, got.data(), hot_id.data(), 1, 4) == 0);
    int32_t cold = 10 + i;                        // one touch each
    CHECK(MV_GetMatrixTableByRows(h, got.data(), &cold, 1, 4) == 0);
  }
  long long gets = 0, adds = 0, nans = 0, infs = 0;
  double skew = 0, l2 = 0, linf = 0;
  CHECK(MV_TableLoadStats(h, &gets, &adds, &skew, &l2, &linf, &nans,
                          &infs) == 0);
  CHECK(gets == 128 && adds == 64);
  CHECK(skew > 2.0);                              // row 3's bucket is hot
  CHECK(l2 > 0.0 && linf == 0.5);
  CHECK(nans == 0 && infs == 0);
  char* json = MV_HotKeys(h);
  CHECK(json && strstr(json, "\"key\":\"3\"") != nullptr);
  CHECK(strstr(json, "\"skew_ratio\"") != nullptr);
  MV_FreeString(json);
  json = MV_OpsReport("hotkeys");
  CHECK(json && strstr(json, "\"topk\"") != nullptr);
  MV_FreeString(json);

  // --- NaN sentinel: first poisoned add trips the black box -----------
  long long triggers0 = 0;
  CHECK(MV_QueryMonitor("blackbox.trigger", &triggers0) == 0);
  int32_t hn;
  CHECK(MV_NewArrayTable(8, &hn) == 0);
  std::vector<float> poison(8, 1.0f);
  poison[3] = std::numeric_limits<float>::quiet_NaN();
  poison[5] = std::numeric_limits<float>::infinity();
  CHECK(MV_AddArrayTable(hn, poison.data(), 8) == 0);
  CHECK(MV_TableLoadStats(hn, nullptr, nullptr, nullptr, nullptr,
                          nullptr, &nans, &infs) == 0);
  CHECK(nans == 1 && infs == 1);
  long long triggers1 = 0;
  CHECK(MV_QueryMonitor("blackbox.trigger", &triggers1) == 0);
  CHECK(triggers1 == triggers0 + 1);
  // Second poisoned add: counted, but the trigger fired once per table.
  CHECK(MV_AddArrayTable(hn, poison.data(), 8) == 0);
  CHECK(MV_QueryMonitor("blackbox.trigger", &triggers1) == 0);
  CHECK(triggers1 == triggers0 + 1);

  // --- disarmed: accounting freezes at one atomic check ---------------
  CHECK(MV_SetHotKeyTracking(0) == 0);
  CHECK(MV_GetMatrixTableByRows(h, got.data(), hot_id.data(), 1, 4) == 0);
  long long gets2 = 0;
  CHECK(MV_TableLoadStats(h, &gets2, nullptr, nullptr, nullptr, nullptr,
                          nullptr, nullptr) == 0);
  CHECK(gets2 == gets);
  CHECK(MV_SetHotKeyTracking(1) == 0);
  return 0;
}

static int TestReplica() {
  // Hot-key read replica (docs/embedding.md), single process: the
  // server's SpaceSaving top-K pushes into the worker-side table,
  // GetRows serves hits with zero additional server applies, and the
  // version gate IS the invalidation — at -replica_max_staleness=0 an
  // acked add stales every entry from before it (the regression the
  // acceptance bar names: RED on a replica that serves without
  // invalidation).
  int32_t h;
  CHECK(MV_NewMatrixTable(64, 4, &h) == 0);
  std::vector<float> ones(2 * 4, 1.0f), out(3 * 4, -1.0f);
  int32_t hot[2] = {1, 2};
  CHECK(MV_AddMatrixTableByRows(h, ones.data(), hot, 2, 4) == 0);
  int32_t ids[3] = {1, 2, 3};
  for (int i = 0; i < 10; ++i)
    CHECK(MV_GetMatrixTableByRows(h, out.data(), ids, 3, 4) == 0);
  CHECK(MV_SetHotKeyReplica(1) == 0);
  CHECK(MV_ReplicaRefresh(h) == 0);
  long long hits = 0, misses = 0, rows = 0, refreshes = 0, pushes = 0;
  CHECK(MV_ReplicaStats(h, &hits, &misses, &rows, &refreshes,
                        &pushes) == 0);
  CHECK(rows >= 2);      // the hot rows were pushed
  CHECK(pushes >= 1);
  long long hits0 = hits;
  CHECK(MV_GetMatrixTableByRows(h, out.data(), ids, 3, 4) == 0);
  CHECK(out[0] == 1.0f && out[4] == 1.0f);
  CHECK(MV_ReplicaStats(h, &hits, &misses, nullptr, nullptr,
                        nullptr) == 0);
  CHECK(hits > hits0);   // served from the replica, not the wire
  // Invalidation, own-add shape: a blocking add to row 1 (ack bumps
  // last_version) — the next read of row 1 MUST return the new value.
  std::vector<float> bump(4, 5.0f);
  int32_t one[1] = {1};
  CHECK(MV_AddMatrixTableByRows(h, bump.data(), one, 1, 4) == 0);
  CHECK(MV_GetMatrixTableByRows(h, out.data(), one, 1, 4) == 0);
  CHECK(out[0] == 6.0f);
  // Version gate specifically: row 2 is still IN the replica (the add
  // touched only row 1's entry) but its stamp predates the acked add —
  // at staleness 0 it must MISS to the wire, not serve the old stamp.
  long long miss0 = 0;
  CHECK(MV_ReplicaStats(h, nullptr, &miss0, nullptr, nullptr,
                        nullptr) == 0);
  int32_t two[1] = {2};
  CHECK(MV_GetMatrixTableByRows(h, out.data(), two, 1, 4) == 0);
  CHECK(out[0] == 1.0f);
  CHECK(MV_ReplicaStats(h, nullptr, &misses, nullptr, nullptr,
                        nullptr) == 0);
  CHECK(misses > miss0);
  // A fresh refresh re-covers the hot set at the NEW version: reads
  // hit again and serve the post-add value.
  CHECK(MV_ReplicaRefresh(h) == 0);
  CHECK(MV_ReplicaStats(h, &hits0, nullptr, nullptr, nullptr,
                        nullptr) == 0);
  CHECK(MV_GetMatrixTableByRows(h, out.data(), one, 1, 4) == 0);
  CHECK(out[0] == 6.0f);
  CHECK(MV_ReplicaStats(h, &hits, nullptr, nullptr, nullptr,
                        nullptr) == 0);
  CHECK(hits > hits0);
  CHECK(MV_SetHotKeyReplica(0) == 0);
  return 0;
}

// First integer after "\"key\":" in a JSON doc, or `dflt` when absent
// (strstr-grade parsing, the house style for report assertions).
static long long JsonIntAfter(const std::string& doc, const std::string& key,
                              long long dflt = -1) {
  size_t at = doc.find("\"" + key + "\":");
  if (at == std::string::npos) return dflt;
  return std::strtoll(doc.c_str() + at + key.size() + 3, nullptr, 10);
}

static int TestCapacity() {
  using mvtpu::capacity::kKVEntryOverhead;

  // ---- matrix shard bytes: exact at construction ---------------------
  int32_t h;
  CHECK(MV_NewMatrixTable(128, 4, &h) == 0);
  char* rep = MV_CapacityReport();
  CHECK(rep != nullptr);
  std::string doc(rep);
  MV_FreeString(rep);
  // Single process: the shard is the whole table — 128 rows x 4 cols
  // x 4 bytes (default updater: no slot plane).
  size_t at = doc.find("\"id\":" + std::to_string(h) + ",");
  CHECK(at != std::string::npos);
  std::string entry = doc.substr(at);
  CHECK(JsonIntAfter(entry, "resident_bytes") == 128 * 4 * 4);
  CHECK(JsonIntAfter(entry, "rows") == 128);
  // Per-bucket bytes sum back to the shard total (the 64-bucket map).
  {
    size_t bb = entry.find("\"bucket_bytes\":[");
    CHECK(bb != std::string::npos);
    const char* p = entry.c_str() + bb + 16;
    long long sum = 0;
    for (int i = 0; i < 64; ++i) {
      char* end = nullptr;
      sum += std::strtoll(p, &end, 10);
      p = end + 1;
    }
    CHECK(sum == 128 * 4 * 4);
  }
  // Proc stats ride the health report (RSS / fds present).
  rep = MV_OpsReport("health");
  std::string health(rep);
  MV_FreeString(rep);
  CHECK(health.find("\"rss_bytes\":") != std::string::npos);
  CHECK(health.find("\"open_fds\":") != std::string::npos);
  CHECK(JsonIntAfter(health, "rss_bytes") > 0);
  CHECK(JsonIntAfter(health, "open_fds") > 0);

  // ---- KV incremental accounting vs the ground-truth walk ------------
  int32_t hk;
  CHECK(MV_NewKVTable(&hk) == 0);
  long long expect = 0;
  for (int i = 0; i < 20; ++i) {
    std::string key = "cap-key-" + std::to_string(i);
    CHECK(MV_AddKV(hk, key.c_str(), 1.0f) == 0);
    expect += static_cast<long long>(key.size()) + 4 + kKVEntryOverhead;
  }
  rep = MV_CapacityReport();
  doc.assign(rep);
  MV_FreeString(rep);
  at = doc.find("\"id\":" + std::to_string(hk) + ",");
  CHECK(at != std::string::npos);
  entry = doc.substr(at);
  CHECK(JsonIntAfter(entry, "resident_bytes") == expect);
  CHECK(JsonIntAfter(entry, "rows") == 20);
  // Duplicate adds do not grow the books.
  CHECK(MV_AddKV(hk, "cap-key-0", 1.0f) == 0);
  rep = MV_CapacityReport();
  doc.assign(rep);
  MV_FreeString(rep);
  entry = doc.substr(doc.find("\"id\":" + std::to_string(hk) + ","));
  CHECK(JsonIntAfter(entry, "rows") == 20);

  // ---- disarm: growth hooks freeze; re-arm resyncs exactly -----------
  CHECK(MV_SetCapacityTracking(0) == 0);
  CHECK(MV_AddKV(hk, "while-disarmed", 2.0f) == 0);
  rep = MV_CapacityReport();
  doc.assign(rep);
  MV_FreeString(rep);
  CHECK(doc.find("\"armed\":false") != std::string::npos);
  entry = doc.substr(doc.find("\"id\":" + std::to_string(hk) + ","));
  CHECK(JsonIntAfter(entry, "rows") == 20);  // stale while disarmed
  CHECK(MV_SetCapacityTracking(1) == 0);     // re-arm RESYNCS
  expect += static_cast<long long>(strlen("while-disarmed")) + 4 +
            kKVEntryOverhead;
  rep = MV_CapacityReport();
  doc.assign(rep);
  MV_FreeString(rep);
  entry = doc.substr(doc.find("\"id\":" + std::to_string(hk) + ","));
  CHECK(JsonIntAfter(entry, "rows") == 21);
  CHECK(JsonIntAfter(entry, "resident_bytes") == expect);

  // ---- history ring: bounded at 64 windows ---------------------------
  CHECK(MV_SetFlag("capacity_history_ms", "0") == 0);
  for (int i = 0; i < 70; ++i) {
    rep = MV_CapacityReport();
    MV_FreeString(rep);
  }
  rep = MV_CapacityReport();
  doc.assign(rep);
  MV_FreeString(rep);
  long long windows = JsonIntAfter(doc, "windows");
  CHECK(windows >= 2 && windows <= 64);
  CHECK(doc.find("\"curve\":[") != std::string::npos);
  CHECK(doc.find("\"bucket_rate\":[") != std::string::npos);
  CHECK(MV_SetFlag("capacity_history_ms", "250") == 0);

  // ---- replica rows are their OWN field (double-count regression) ----
  // With an armed replica install, the "tables" report must keep the
  // shard row count pure and report replica entries separately — a
  // capacity sum over rows+replica_rows is the caller's CHOICE, never
  // a baked-in double count.
  std::vector<float> ones(2 * 4, 1.0f), out(2 * 4, 0.0f);
  int32_t hot[2] = {1, 2};
  CHECK(MV_AddMatrixTableByRows(h, ones.data(), hot, 2, 4) == 0);
  for (int i = 0; i < 8; ++i)
    CHECK(MV_GetMatrixTableByRows(h, out.data(), hot, 2, 4) == 0);
  CHECK(MV_SetHotKeyReplica(1) == 0);
  CHECK(MV_ReplicaRefresh(h) == 0);
  rep = MV_OpsReport("tables");
  doc.assign(rep);
  MV_FreeString(rep);
  entry = doc.substr(doc.find("\"id\":" + std::to_string(h) + ","));
  CHECK(JsonIntAfter(entry, "rows") == 128);          // shard rows only
  CHECK(JsonIntAfter(entry, "replica_rows") >= 2);    // own field
  // The capacity report agrees: worker.replica_bytes > 0, and the
  // shard's resident bytes did NOT absorb the replica copies.
  rep = MV_CapacityReport();
  doc.assign(rep);
  MV_FreeString(rep);
  entry = doc.substr(doc.find("\"id\":" + std::to_string(h) + ","));
  CHECK(JsonIntAfter(entry, "resident_bytes") == 128 * 4 * 4);
  CHECK(JsonIntAfter(entry, "replica_bytes") > 0);
  CHECK(MV_SetHotKeyReplica(0) == 0);

  // ---- gauges object carries the registered native gauges ------------
  CHECK(doc.find("\"host_arena.bytes\":") != std::string::npos);
  CHECK(doc.find("\"net.writeq_bytes\":") != std::string::npos);
  return 0;
}

static int TestQos() {
  // ---- wire format: stamp rides only when flagged -------------------
  mvtpu::Message plain;
  plain.type = mvtpu::MsgType::RequestGet;
  float payload[2] = {1.0f, 2.0f};
  plain.data.emplace_back(payload, sizeof(payload));
  int64_t plain_bytes = plain.WireBytes();
  mvtpu::Message req = plain;
  req.flags |= mvtpu::msgflag::kHasQos;
  req.qos.klass = 1;
  req.qos.budget_ns = 5'000'000'000ll;
  CHECK(req.WireBytes() ==
        plain_bytes + static_cast<int64_t>(sizeof(mvtpu::QosStamp)));
  mvtpu::Message back = mvtpu::Message::Deserialize(req.Serialize());
  CHECK(back.has_qos());
  CHECK(back.qos.klass == 1 && back.qos.budget_ns == 5'000'000'000ll);
  // Old-header frame (no flag) parses byte-identically, no stamp.
  mvtpu::Message old_back = mvtpu::Message::Deserialize(plain.Serialize());
  CHECK(!old_back.has_qos());
  CHECK(old_back.data.size() == 1 && old_back.data[0].count<float>() == 2);
  // Trail + audit + qos compose in Serialize order.
  mvtpu::latency::Arm(true);
  mvtpu::latency::StampEnqueue(&req);
  req.flags |= mvtpu::msgflag::kHasAudit;
  req.audit = {3, 4};
  mvtpu::Blob w = req.Serialize();
  auto slab = std::make_shared<std::vector<char>>(w.data(),
                                                  w.data() + w.size());
  mvtpu::Message view;
  CHECK(mvtpu::Message::DeserializeView(slab, 0, slab->size(), &view));
  CHECK(view.has_timing() && view.has_audit() && view.has_qos());
  CHECK(view.qos.klass == 1 && view.qos.budget_ns == 5'000'000'000ll);
  CHECK(view.audit.seq_lo == 3 && view.data[0].count<float>() == 2);
  // A flagged frame too short for the stamp is malformed, not misread.
  auto runt = std::make_shared<std::vector<char>>(
      slab->begin(), slab->begin() + sizeof(mvtpu::WireHeader));
  mvtpu::Message bad;
  CHECK(!mvtpu::Message::DeserializeView(runt, 0, runt->size(), &bad));

  // ---- weighted deficit admission -----------------------------------
  mvtpu::configure::RegisterDefaults();
  mvtpu::configure::Set("qos_classes", "gold:8,bulk:1");
  mvtpu::configure::Set("qos_inflight_max", "9");
  mvtpu::qos::Configure();
  mvtpu::qos::Reset();
  CHECK(mvtpu::qos::NumClasses() == 2);
  CHECK(mvtpu::qos::ClassId("gold") == 0);
  CHECK(mvtpu::qos::ClassId("bulk") == 1);
  CHECK(mvtpu::qos::ClassId("nope") == -1);
  CHECK(mvtpu::qos::ClassName(1) == "bulk");
  // Guaranteed shares: gold 8 slots, bulk 1 (cap * w / sum).
  CHECK(mvtpu::qos::TryAdmit(1));            // bulk's guaranteed slot
  for (int i = 0; i < 8; ++i) CHECK(mvtpu::qos::TryAdmit(0));  // gold
  CHECK(!mvtpu::qos::TryAdmit(1));           // at cap: bulk sheds
  CHECK(!mvtpu::qos::TryAdmit(0));           // at cap: even gold sheds
  mvtpu::qos::Release(0);
  // One spare slot: bulk borrows only after deficit credit accrues in
  // weight proportion (one admit per max-weight failed passes).
  int admitted = 0;
  for (int i = 0; i < 8; ++i) admitted += mvtpu::qos::TryAdmit(1) ? 1 : 0;
  CHECK(admitted == 1);
  // Gold borrows the next spare immediately (weight == quantum).
  mvtpu::qos::Release(1);
  CHECK(mvtpu::qos::TryAdmit(0));
  std::string j = mvtpu::qos::Json();
  CHECK(j.find("\"name\":\"gold\"") != std::string::npos);
  CHECK(j.find("\"inflight_max\":9") != std::string::npos);

  // ---- deadline adoption + dequeue shed -----------------------------
  mvtpu::Message dm;
  dm.flags |= mvtpu::msgflag::kHasQos;
  dm.qos.budget_ns = 1;                      // expires immediately
  mvtpu::qos::AdoptDeadline(&dm);
  CHECK(dm.qos_deadline_ns != 0);
  std::this_thread::sleep_for(std::chrono::milliseconds(2));
  CHECK(mvtpu::qos::ShedExpired(dm));
  CHECK(mvtpu::qos::DeadlineSheds() >= 1);
  mvtpu::Message fresh;
  fresh.flags |= mvtpu::msgflag::kHasQos;
  fresh.qos.budget_ns = 60'000'000'000ll;    // a minute: never expires here
  mvtpu::qos::AdoptDeadline(&fresh);
  CHECK(!mvtpu::qos::ShedExpired(fresh));
  mvtpu::Message unstamped;                  // no budget: never shed
  mvtpu::qos::AdoptDeadline(&unstamped);
  CHECK(unstamped.qos_deadline_ns == 0);
  CHECK(!mvtpu::qos::ShedExpired(unstamped));

  // ---- request stamping follows -wire_deadline / -qos_class ---------
  mvtpu::configure::Set("qos_class", "bulk");
  mvtpu::configure::Set("rpc_timeout_ms", "250");
  mvtpu::qos::Configure();
  mvtpu::Message stamped;
  mvtpu::qos::StampRequest(&stamped);
  CHECK(stamped.has_qos());
  CHECK(stamped.qos.klass == 1);             // bulk's positional id
  CHECK(stamped.qos.budget_ns == 250'000'000ll);
  mvtpu::configure::Set("wire_deadline", "false");
  mvtpu::qos::Configure();
  mvtpu::Message unflagged;
  mvtpu::qos::StampRequest(&unflagged);
  CHECK(!unflagged.has_qos());

  // ---- hedge-cancel registry: consume-once --------------------------
  mvtpu::qos::NoteCancel(5, 42);
  CHECK(mvtpu::qos::Cancelled(5, 42));
  CHECK(!mvtpu::qos::Cancelled(5, 42));      // consumed
  CHECK(!mvtpu::qos::Cancelled(5, 43));      // never noted

  // Restore defaults so later cases see a clean slate.
  mvtpu::configure::Set("qos_classes", "bulk:1,gold:8");
  mvtpu::configure::Set("qos_inflight_max", "0");
  mvtpu::configure::Set("wire_deadline", "true");
  mvtpu::configure::Set("qos_class", "bulk");
  mvtpu::configure::Set("rpc_timeout_ms", "30000");
  mvtpu::qos::Configure();
  mvtpu::qos::Reset();
  return 0;
}

static int TestMultiBlobAdd() {
  // Multi-shard borrowed AddRows wire shape (docs/embedding.md): the
  // delta may arrive split across SEVERAL row-aligned blobs (one per
  // contiguous caller run); the server walks rows across the sequence
  // (RowBlobCursor) and a cross-blob size mismatch drops cleanly.
  mvtpu::MatrixServerTable t(8, 2, mvtpu::UpdaterType::kDefault);
  mvtpu::AddOption opt;
  mvtpu::Message req;
  req.data.emplace_back(&opt, sizeof(opt));
  int32_t ids[3] = {1, 2, 5};
  req.data.emplace_back(ids, sizeof(ids));
  float run1[4] = {1.0f, 1.0f, 2.0f, 2.0f};  // rows 1, 2
  float run2[2] = {5.0f, 5.0f};              // row 5
  req.data.emplace_back(run1, sizeof(run1));
  req.data.emplace_back(run2, sizeof(run2));
  t.ProcessAdd(req);
  mvtpu::Message get, reply;
  get.data.emplace_back(ids, sizeof(ids));
  t.ProcessGet(get, &reply);
  const float* vals = reply.data[0].As<float>();
  CHECK(vals[0] == 1.0f && vals[1] == 1.0f);
  CHECK(vals[2] == 2.0f && vals[3] == 2.0f);
  CHECK(vals[4] == 5.0f && vals[5] == 5.0f);
  // 3 ids but only 2 rows of delta across the blobs: dropped whole.
  mvtpu::Message bad;
  bad.data.emplace_back(&opt, sizeof(opt));
  bad.data.emplace_back(ids, sizeof(ids));
  bad.data.emplace_back(run1, sizeof(run1));
  t.ProcessAdd(bad);
  mvtpu::Message reply2;
  t.ProcessGet(get, &reply2);
  const float* vals2 = reply2.data[0].As<float>();
  for (int i = 0; i < 6; ++i) CHECK(vals2[i] == vals[i]);
  return 0;
}

static int TestWatchdog() {
  namespace wd = mvtpu::watchdog;
  wd::Reset();
  // Disarmed (the default): Bump/Busy are no-ops, nothing registers.
  wd::Bump("t.noop");
  CHECK(!wd::Armed());
  CHECK(wd::StatsJson() == "[]");
  long long triggers0 = mvtpu::ops::BlackboxTriggerCount();
  wd::Arm(50);
  CHECK(wd::Armed());
  // A busy loop that never progresses must be flagged within
  // stall_ms + one checker period; a progressing loop never is.
  wd::Busy("t.stuck", 3);
  bool stalled = false;
  for (int i = 0; i < 200 && !stalled; ++i) {
    wd::Bump("t.live");
    wd::Busy("t.live", 1);
    std::this_thread::sleep_for(std::chrono::milliseconds(5));
    stalled = wd::StallCount() > 0;
  }
  CHECK(stalled);
  CHECK(wd::StallCount() == 1);  // flagged once, not once per period
  std::string js = wd::StatsJson();
  CHECK(js.find("\"loop\":\"t.stuck\"") != std::string::npos);
  CHECK(js.find("\"stalled\":true") != std::string::npos);
  CHECK(js.find("\"loop\":\"t.live\"") != std::string::npos);
  // The stall dumped a blackbox (stall message + folded stacks).
  CHECK(mvtpu::ops::BlackboxTriggerCount() > triggers0);
  // Recovery: one unit of progress clears the flag.
  wd::Bump("t.stuck");
  bool cleared = false;
  for (int i = 0; i < 50 && !cleared; ++i) {
    std::this_thread::sleep_for(std::chrono::milliseconds(5));
    cleared = wd::StatsJson().find("\"stalled\":true") ==
              std::string::npos;
  }
  CHECK(cleared);
  wd::Busy("t.stuck", 0);  // idle: cannot re-stall
  // C API surface.
  CHECK(MV_WatchdogBump("t.capi") == 0);
  CHECK(MV_WatchdogBusy("t.capi", 1) == 0);
  char* stats = MV_WatchdogStats();
  CHECK(stats != nullptr);
  CHECK(std::string(stats).find("t.capi") != std::string::npos);
  MV_FreeString(stats);
  CHECK(MV_WatchdogBump(nullptr) == -1);
  CHECK(MV_WatchdogBusy(nullptr, 1) == -1);
  CHECK(MV_SetWatchdog(0) == 0);
  CHECK(!wd::Armed());
  // The "alerts" ops report carries the watchdog table + host push.
  CHECK(MV_SetOpsHostAlerts("{\"armed\":true,\"alerts\":[]}") == 0);
  char* rep = MV_OpsReport("alerts");
  CHECK(rep != nullptr);
  std::string alerts(rep);
  MV_FreeString(rep);
  CHECK(alerts.find("\"watchdog\":[") != std::string::npos);
  CHECK(alerts.find("\"host\":{\"armed\":true") != std::string::npos);
  CHECK(MV_SetOpsHostAlerts(nullptr) == 0);  // clears → null
  rep = MV_OpsReport("alerts");
  CHECK(std::string(rep).find("\"host\":null") != std::string::npos);
  MV_FreeString(rep);
  wd::Reset();
  CHECK(wd::StatsJson() == "[]");
  return 0;
}

static int TestThreads() {
  // Concurrent blocking adds from many app threads — the actor pipeline
  // must serialize them without loss (reference MtQueue/actor guarantee).
  int32_t h;
  CHECK(MV_NewArrayTable(32, &h) == 0);
  const int kThreads = 8, kAdds = 50;
  std::vector<std::thread> ts;
  for (int t = 0; t < kThreads; ++t)
    ts.emplace_back([h] {
      std::vector<float> d(32, 1.0f);
      for (int i = 0; i < kAdds; ++i) MV_AddArrayTable(h, d.data(), 32);
    });
  for (auto& t : ts) t.join();
  std::vector<float> out(32, 0.0f);
  CHECK(MV_GetArrayTable(h, out.data(), 32) == 0);
  for (float v : out) CHECK(v == (float)(kThreads * kAdds));
  return 0;
}

static int NetChild(const char* machine_file, const char* rank,
                    const char* engine) {
  // N-process scenario (spawned N times by tests/test_native.py): sharded
  // tables over the TCP transport — Add/Get round-trips cross the process
  // boundary, MV_Barrier rendezvouses through rank 0's controller.
  // N comes from the machine file (2 and 4 in CI); N <= 4.  `engine`
  // picks the readiness model (tcp|epoll; tests run both).
  std::string mf = std::string("-machine_file=") + machine_file;
  std::string rk = std::string("-rank=") + rank;
  std::string eng = std::string("-net_engine=") + engine;
  // Bounded deadlines: an infra failure (stolen port, dead sibling)
  // must fail a CHECK quickly, not hang the rank past pytest's timeout.
  const char* argv2[] = {mf.c_str(), rk.c_str(), eng.c_str(),
                         "-updater_type=default",
                         "-log_level=error", "-rpc_timeout_ms=60000",
                         "-barrier_timeout_ms=60000"};
  CHECK(MV_Init(7, argv2) == 0);
  int me = MV_WorkerId();
  int n = MV_NumWorkers();
  CHECK(n >= 2 && n <= 4);
  float total = (float)(n * (n + 1) / 2);  // sum over ranks of (r+1)

  int32_t h;
  CHECK(MV_NewArrayTable(10, &h) == 0);
  int32_t hm;
  CHECK(MV_NewMatrixTable(8, 4, &hm) == 0);
  CHECK(MV_Barrier() == 0);  // every rank registered both tables

  // Each rank pushes its own delta; shards live on EVERY rank, so every
  // Add crosses the wire for the remote shards. After the barrier all
  // ranks must read the sum.
  std::vector<float> delta(10, (float)(me + 1)), out(10, -1.0f);
  CHECK(MV_AddArrayTable(h, delta.data(), 10) == 0);
  CHECK(MV_Barrier() == 0);
  CHECK(MV_GetArrayTable(h, out.data(), 10) == 0);
  for (float v : out) CHECK(v == total);
  // Rendezvous between rounds: without it, a slow rank's verify-Get
  // races the fast ranks' next-round async adds (observed at n=4).
  CHECK(MV_Barrier() == 0);

  // Async add flushes through the pipeline before the barrier completes.
  CHECK(MV_AddAsyncArrayTable(h, delta.data(), 10) == 0);
  CHECK(MV_Barrier() == 0);
  CHECK(MV_GetArrayTable(h, out.data(), 10) == 0);
  for (float v : out) CHECK(v == 2 * total);
  CHECK(MV_Barrier() == 0);  // same read-vs-next-round fence as above

  // Matrix rows: rank r touches rows {r, 4+r}, so row blocks from every
  // shard see both local and remote writes.
  int32_t rows[2] = {me, 4 + me};
  std::vector<float> rd(8, (float)(me + 1));
  CHECK(MV_AddMatrixTableByRows(hm, rd.data(), rows, 2, 4) == 0);
  CHECK(MV_Barrier() == 0);
  for (int r = 0; r < n; ++r) {
    int32_t qrows[2] = {r, 4 + r};
    std::vector<float> rout(8, -1.0f);
    CHECK(MV_GetMatrixTableByRows(hm, rout.data(), qrows, 2, 4) == 0);
    for (float v : rout) CHECK(v == (float)(r + 1));
  }

  // Sparse matrix cross-rank: the worker row cache serves CACHED values
  // while peers add (AD-LDA staleness), and a barrier makes peers' adds
  // visible.  A KV counter synchronizes "all +10 adds applied" without
  // touching the sparse cache, so the staleness assert is deterministic.
  int32_t hs;
  CHECK(MV_NewSparseMatrixTable(4, 4, &hs) == 0);
  int32_t hsync;
  CHECK(MV_NewKVTable(&hsync) == 0);
  CHECK(MV_Barrier() == 0);
  int32_t my_row[1] = {me};
  std::vector<float> mine(4, (float)(me + 1));
  CHECK(MV_AddMatrixTableByRows(hs, mine.data(), my_row, 1, 4) == 0);
  CHECK(MV_Barrier() == 0);
  // Fill the cache with every rank's row, then RENDEZVOUS THROUGH KV
  // (not a barrier — that would invalidate the cache) before anyone
  // bumps: a fast rank's bump must not land before a slow rank's
  // snapshot read, or the snapshot values race.
  std::vector<int32_t> all_rows(n);
  for (int r = 0; r < n; ++r) all_rows[r] = r;
  std::vector<float> snap(n * 4, -1.0f);
  CHECK(MV_GetMatrixTableByRows(hs, snap.data(), all_rows.data(), n, 4) == 0);
  for (int r = 0; r < n; ++r)
    for (int c = 0; c < 4; ++c) CHECK(snap[r * 4 + c] == (float)(r + 1));
  CHECK(MV_AddKV(hsync, "cached", 1.0f) == 0);
  float cached = 0.0f;
  for (int tries = 0; tries < 500 && cached < (float)n; ++tries) {
    CHECK(MV_GetKV(hsync, "cached", &cached) == 0);
    std::this_thread::sleep_for(std::chrono::milliseconds(10));
  }
  CHECK(cached == (float)n);
  // Everyone bumps their own row by 10 (blocking), then announces via KV.
  std::vector<float> bump(4, 10.0f);
  CHECK(MV_AddMatrixTableByRows(hs, bump.data(), my_row, 1, 4) == 0);
  CHECK(MV_AddKV(hsync, "adds_done", 1.0f) == 0);
  float done = 0.0f;
  for (int tries = 0; tries < 500 && done < (float)n; ++tries) {
    CHECK(MV_GetKV(hsync, "adds_done", &done) == 0);
    std::this_thread::sleep_for(std::chrono::milliseconds(10));
  }
  CHECK(done == (float)n);
  // Peer rows: served from the cache — the PRE-bump snapshot — even
  // though every +10 is provably applied server-side by now.  Own row:
  // our add invalidated it, so it re-fetches fresh.
  int peer = (me + 1) % n;
  int32_t prow[1] = {(int32_t)peer};
  std::vector<float> pv(4, -1.0f);
  CHECK(MV_GetMatrixTableByRows(hs, pv.data(), prow, 1, 4) == 0);
  for (float v : pv) CHECK(v == (float)(peer + 1));       // stale (cached)
  std::vector<float> ov(4, -1.0f);
  CHECK(MV_GetMatrixTableByRows(hs, ov.data(), my_row, 1, 4) == 0);
  for (float v : ov) CHECK(v == (float)(me + 11));        // fresh (own add)
  CHECK(MV_Barrier() == 0);                               // clock closes
  CHECK(MV_GetMatrixTableByRows(hs, pv.data(), prow, 1, 4) == 0);
  for (float v : pv) CHECK(v == (float)(peer + 11));      // now visible

  // KV cross-rank: every rank adds (rank+1) under a SHARED key (entries
  // hash-shard, so whichever rank owns it sees remote adds) plus its own
  // key; after the barrier every rank reads the merged map.
  int32_t hk;
  CHECK(MV_NewKVTable(&hk) == 0);
  CHECK(MV_Barrier() == 0);  // every rank registered the table
  char own_key[16];
  snprintf(own_key, sizeof(own_key), "rank_%d", me);
  CHECK(MV_AddKV(hk, "shared", (float)(me + 1)) == 0);
  CHECK(MV_AddAsyncKV(hk, own_key, 100.0f + static_cast<float>(me)) == 0);
  CHECK(MV_Barrier() == 0);  // async adds flushed, all ranks landed
  float kv = -1.0f;
  CHECK(MV_GetKV(hk, "shared", &kv) == 0);
  CHECK(kv == total);
  for (int r = 0; r < n; ++r) {
    char qk[16];
    snprintf(qk, sizeof(qk), "rank_%d", r);
    CHECK(MV_GetKV(hk, qk, &kv) == 0);
    CHECK(kv == 100.0f + static_cast<float>(r));
  }

  CHECK(MV_Barrier() == 0);
  CHECK(MV_ShutDown() == 0);
  printf("NET_CHILD_OK %d\n", me);
  return 0;
}

static int NetUpdaterChild(const char* machine_file, const char* rank,
                           const char* updater) {
  // Stateful-updater cross-rank scenario: every rank pushes identical
  // blocking deltas, the server shards apply them SEQUENTIALLY through
  // the stateful updater (slot state lives with the shard), and every
  // rank must read the same deterministic result.
  std::string mf = std::string("-machine_file=") + machine_file;
  std::string rk = std::string("-rank=") + rank;
  std::string up = std::string("-updater_type=") + updater;
  const char* argv2[] = {mf.c_str(), rk.c_str(), up.c_str(),
                         "-log_level=error", "-rpc_timeout_ms=60000",
                         "-barrier_timeout_ms=60000"};
  CHECK(MV_Init(6, argv2) == 0);
  int me = MV_WorkerId();
  int n = MV_NumWorkers();
  CHECK(MV_SetAddOption(0.1f, 0.9f, 0.9f, 1e-8f) == 0);

  int32_t h;
  CHECK(MV_NewArrayTable(6, &h) == 0);
  CHECK(MV_Barrier() == 0);
  std::vector<float> ones(6, 1.0f), out(6, -1.0f);
  CHECK(MV_AddArrayTable(h, ones.data(), 6) == 0);  // blocking
  CHECK(MV_Barrier() == 0);                         // all n adds applied
  CHECK(MV_GetArrayTable(h, out.data(), 6) == 0);

  float want = 0.0f;
  if (std::string(updater) == "sgd") {
    want = -0.1f * static_cast<float>(n);                       // linear: order-free
  } else if (std::string(updater) == "adagrad") {
    // n sequential g=1 applies: w -= lr * g / sqrt(h_i), h_i = i
    for (int i = 1; i <= n; ++i) want -= 0.1f / sqrtf((float)i);
  } else if (std::string(updater) == "momentum") {
    // v_i = mu*v_{i-1} + lr;  w -= v_i  (identical g=1 deltas)
    float v = 0.0f;
    for (int i = 0; i < n; ++i) {
      v = 0.9f * v + 0.1f;
      want -= v;
    }
  } else if (std::string(updater) == "smooth_gradient") {
    // s_i = rho*s_{i-1} + (1-rho);  w -= lr*s_i
    float sgd_s = 0.0f;
    for (int i = 0; i < n; ++i) {
      sgd_s = 0.9f * sgd_s + 0.1f;
      want -= 0.1f * sgd_s;
    }
  } else {
    CHECK(false);
  }
  for (float v : out) CHECK(fabsf(v - want) < 1e-4f);

  CHECK(MV_Barrier() == 0);
  CHECK(MV_ShutDown() == 0);
  printf("NET_UPDATER_OK %d\n", me);
  return 0;
}

static int DeadPeerChild(const char* machine_file, const char* rank) {
  // One live rank; the OTHER endpoint has nothing listening.  Every
  // blocking call that needs the dead rank must ERROR within its
  // deadline — the round-2 behavior was an infinite hang.  Rank 0
  // exercises the quorum-timeout path (it is its own barrier
  // authority); rank 1 exercises the unreachable-authority path
  // (Deliver latches barrier_failed_ — a false "success" here would
  // silently break BSP).
  std::string mf = std::string("-machine_file=") + machine_file;
  std::string rk = std::string("-rank=") + rank;
  const char* argv2[] = {mf.c_str(),       rk.c_str(),
                         "-updater_type=default", "-log_level=error",
                         "-connect_retry_ms=300", "-rpc_timeout_ms=3000",
                         "-barrier_timeout_ms=1000"};
  CHECK(MV_Init(7, argv2) == 0);
  int32_t h;
  CHECK(MV_NewArrayTable(10, &h) == 0);

  auto t0 = std::chrono::steady_clock::now();
  std::vector<float> out(10, 0.0f);
  CHECK(MV_GetArrayTable(h, out.data(), 10) == -3);  // peer unreachable
  std::vector<float> d(10, 1.0f);
  CHECK(MV_AddArrayTable(h, d.data(), 10) == -3);
  CHECK(MV_Barrier() == -3);
  CHECK(MV_Barrier() == -3);  // a retry must not fake a quorum either
  auto ms = std::chrono::duration_cast<std::chrono::milliseconds>(
                std::chrono::steady_clock::now() - t0)
                .count();
  CHECK(ms < 20000);  // fail-fast, not rpc_timeout*calls hang
  CHECK(MV_ShutDown() == 0);  // barrier inside times out and proceeds
  printf("DEAD_PEER_OK\n");
  return 0;
}

static int DeadServerChild(const char* machine_file, const char* rank) {
  // Both ranks start and rendezvous; rank 1 then dies WITHOUT shutdown
  // (a crash).  Rank 0's next blocking Get must error within the
  // deadline instead of waiting forever on the never-coming reply.
  std::string mf = std::string("-machine_file=") + machine_file;
  std::string rk = std::string("-rank=") + rank;
  const char* argv2[] = {mf.c_str(),       rk.c_str(),
                         "-updater_type=default", "-log_level=error",
                         "-connect_retry_ms=500", "-rpc_timeout_ms=2500",
                         "-barrier_timeout_ms=2000"};
  CHECK(MV_Init(7, argv2) == 0);
  int me = MV_WorkerId();
  int32_t h;
  CHECK(MV_NewArrayTable(10, &h) == 0);
  CHECK(MV_Barrier() == 0);
  if (me == 1) _exit(0);  // simulated crash: no shutdown, no goodbye

  std::this_thread::sleep_for(std::chrono::milliseconds(800));
  auto t0 = std::chrono::steady_clock::now();
  std::vector<float> out(10, 0.0f);
  CHECK(MV_GetArrayTable(h, out.data(), 10) == -3);
  auto ms = std::chrono::duration_cast<std::chrono::milliseconds>(
                std::chrono::steady_clock::now() - t0)
                .count();
  CHECK(ms < 10000);
  CHECK(MV_ShutDown() == 0);
  printf("DEAD_SERVER_OK\n");
  return 0;
}

static int RegisterChild(const char* ctrl, const char* port,
                         const char* role, const char* num,
                         const char* is_ctrl) {
  // Dynamic registration scenario (reference Control_Register): three
  // processes — controller (role all), a worker-only node, a
  // server-only node — find each other through the controller alone (no
  // machine file, no -rank).  Tables shard across the TWO server-role
  // ranks; only the TWO worker-role ranks push/pull.
  std::string a_ctrl = std::string("-controller_endpoint=") + ctrl;
  std::string a_port = std::string("-port=") + port;
  std::string a_role = std::string("-role=") + role;
  std::string a_num = std::string("-num_nodes=") + num;
  std::string a_isc = std::string("-is_controller=") + is_ctrl;
  const char* argv2[] = {a_ctrl.c_str(), a_port.c_str(), a_role.c_str(),
                         a_num.c_str(),  a_isc.c_str(),
                         "-updater_type=default", "-log_level=error",
                         "-rpc_timeout_ms=60000",
                         "-barrier_timeout_ms=60000"};
  CHECK(MV_Init(9, argv2) == 0);
  int wid = MV_WorkerId(), sid = MV_ServerId();
  if (std::string(role) == "worker") CHECK(sid == -1 && wid >= 0);
  if (std::string(role) == "server") CHECK(wid == -1 && sid >= 0);
  if (std::string(role) == "all") CHECK(wid == 0 && sid == 0);
  CHECK(MV_NumWorkers() == 2);

  int32_t h;
  CHECK(MV_NewArrayTable(12, &h) == 0);
  int32_t hm;
  CHECK(MV_NewMatrixTable(6, 2, &hm) == 0);
  CHECK(MV_Barrier() == 0);

  if (wid >= 0) {
    std::vector<float> d(12, (float)(wid + 1));
    CHECK(MV_AddArrayTable(h, d.data(), 12) == 0);
    int32_t row = wid;
    std::vector<float> rd(2, (float)(wid + 1));
    CHECK(MV_AddMatrixTableByRows(hm, rd.data(), &row, 1, 2) == 0);
  }
  CHECK(MV_Barrier() == 0);
  if (wid >= 0) {
    std::vector<float> out(12, -1.0f);
    CHECK(MV_GetArrayTable(h, out.data(), 12) == 0);
    for (float v : out) CHECK(v == 3.0f);   // worker ids 0,1 → 1+2
    int32_t qrows[2] = {0, 1};
    std::vector<float> rout(4, -1.0f);
    CHECK(MV_GetMatrixTableByRows(hm, rout.data(), qrows, 2, 2) == 0);
    CHECK(rout[0] == 1.0f && rout[1] == 1.0f);
    CHECK(rout[2] == 2.0f && rout[3] == 2.0f);
  }
  // Store/Load are collective (internal barrier): EVERY rank calls them,
  // the worker-only rank contributes no shard but must not deadlock the
  // server ranks (each rank stores its own shard file, reference model).
  std::string ck = std::string("/tmp/mvtpu_register_ck_") + port + ".bin";
  CHECK(MV_StoreTable(h, ck.c_str()) == 0);
  if (wid >= 0) {
    std::vector<float> d(12, 100.0f);
    CHECK(MV_AddArrayTable(h, d.data(), 12) == 0);
  }
  CHECK(MV_Barrier() == 0);
  CHECK(MV_LoadTable(h, ck.c_str()) == 0);
  CHECK(MV_Barrier() == 0);
  if (wid >= 0) {
    std::vector<float> out(12, -1.0f);
    CHECK(MV_GetArrayTable(h, out.data(), 12) == 0);
    for (float v : out) CHECK(v == 3.0f);  // post-store adds rolled back
  }

  CHECK(MV_Barrier() == 0);
  CHECK(MV_ShutDown() == 0);
  printf("REGISTER_OK %s\n", role);
  return 0;
}

static int SspChild(const char* machine_file, const char* rank,
                    const char* staleness) {
  // SSP scenario (SURVEY.md §2.9-bis, -staleness + MV_Clock): rank 0
  // races ahead while rank 1 lags ~1.5 s.  With s=1 the first fast-rank
  // Get OVERLAPS the straggler (admitted, no wait); one more clock and
  // the bound binds (held until the straggler's tick).  With s=0 every
  // ahead-Get is held — and the released read must include the
  // straggler's clock adds (ticks ride the connection BEHIND the adds),
  // which is exactly the BSP read guarantee.
  std::string mf = std::string("-machine_file=") + machine_file;
  std::string rk = std::string("-rank=") + rank;
  std::string st = std::string("-staleness=") + staleness;
  const char* argv2[] = {mf.c_str(), rk.c_str(), st.c_str(),
                         "-updater_type=default", "-log_level=error",
                         "-rpc_timeout_ms=20000",
                         "-barrier_timeout_ms=20000"};
  CHECK(MV_Init(7, argv2) == 0);
  int me = MV_WorkerId();
  int s = atoi(staleness);
  int32_t h;
  CHECK(MV_NewArrayTable(4, &h) == 0);
  CHECK(MV_Barrier() == 0);

  if (me == 1) {
    // The straggler: adds for its clock 1, then ticks, 1.5 s late.
    std::this_thread::sleep_for(std::chrono::milliseconds(1500));
    std::vector<float> twos(4, 2.0f);
    CHECK(MV_AddAsyncArrayTable(h, twos.data(), 4) == 0);
    CHECK(MV_Clock() == 0);
  } else {
    auto t0 = std::chrono::steady_clock::now();
    std::vector<float> ones(4, 1.0f), out(4, -1.0f);
    CHECK(MV_AddArrayTable(h, ones.data(), 4) == 0);
    CHECK(MV_Clock() == 0);  // clock 1
    CHECK(MV_GetArrayTable(h, out.data(), 4) == 0);
    auto ms1 = std::chrono::duration_cast<std::chrono::milliseconds>(
                   std::chrono::steady_clock::now() - t0)
                   .count();
    if (s >= 1) {
      // Overlap: admitted while 1 - 0 <= s, no straggler wait.
      CHECK(ms1 < 1000);
      CHECK(MV_Clock() == 0);  // clock 2: now 2 - 0 > s — must hold
      CHECK(MV_GetArrayTable(h, out.data(), 4) == 0);
    }
    // (s=0: the first Get itself was the held one.)
    auto ms2 = std::chrono::duration_cast<std::chrono::milliseconds>(
                   std::chrono::steady_clock::now() - t0)
                   .count();
    CHECK(ms2 >= 1200);  // held until the straggler's tick
    // Released read includes the straggler's clock-1 adds (BSP read).
    for (float v : out) CHECK(v == 3.0f);
  }
  CHECK(MV_Barrier() == 0);
  CHECK(MV_ShutDown() == 0);
  printf("SSP_OK %d s=%d\n", me, s);
  return 0;
}

static int BackupChild(const char* machine_file, const char* rank,
                       const char* ratio) {
  // backup_worker_ratio scenario (reference server.h sync variant,
  // SURVEY §2.9; VERDICT r4 action 3): 3 workers, staleness 0.  Ranks
  // 0/1 add + tick clock 1 immediately; rank 2 is a deliberate ~1.5 s
  // straggler.  With -backup_worker_ratio=0.34 the quorum is
  // ceil(0.66*3)=2, so the fast ranks' clock-1 reads admit as soon as
  // BOTH fast ranks ticked — no straggler wait (asserted < 1000 ms).
  // With ratio=0 (control) the same reads park until the straggler's
  // tick (asserted >= 1200 ms) — the quorum releases only because of
  // the ratio.  Either way the straggler's adds are never dropped:
  // after the final barrier every rank reads the full sum.
  std::string mf = std::string("-machine_file=") + machine_file;
  std::string rk = std::string("-rank=") + rank;
  std::string rt = std::string("-backup_worker_ratio=") + ratio;
  const char* argv2[] = {mf.c_str(), rk.c_str(), rt.c_str(),
                         "-staleness=0",  "-updater_type=default",
                         "-log_level=error", "-rpc_timeout_ms=20000",
                         "-barrier_timeout_ms=20000"};
  CHECK(MV_Init(8, argv2) == 0);
  int me = MV_WorkerId();
  bool slack = atof(ratio) > 0.0;
  int32_t h;
  CHECK(MV_NewArrayTable(4, &h) == 0);
  CHECK(MV_Barrier() == 0);

  if (me == 2) {
    // The straggler: its clock-1 work lands ~1.5 s late.
    std::this_thread::sleep_for(std::chrono::milliseconds(1500));
    std::vector<float> twos(4, 2.0f);
    CHECK(MV_AddAsyncArrayTable(h, twos.data(), 4) == 0);
    CHECK(MV_Clock() == 0);
  } else {
    auto t0 = std::chrono::steady_clock::now();
    std::vector<float> ones(4, 1.0f), out(4, -1.0f);
    CHECK(MV_AddArrayTable(h, ones.data(), 4) == 0);
    CHECK(MV_Clock() == 0);  // clock 1
    CHECK(MV_GetArrayTable(h, out.data(), 4) == 0);
    auto ms = std::chrono::duration_cast<std::chrono::milliseconds>(
                  std::chrono::steady_clock::now() - t0)
                  .count();
    if (slack) {
      CHECK(ms < 1000);    // quorum of 2 released without the straggler
      // Quorum-released read carries at least both fast ranks' adds
      // (the straggler's may or may not have landed — ASP fold).
      for (float v : out) CHECK(v >= 2.0f);
    } else {
      CHECK(ms >= 1200);   // control: parked until the straggler's tick
      for (float v : out) CHECK(v == 4.0f);  // BSP read: all adds
    }
  }
  // Straggler catch-up fence, then the consistency check: no add was
  // dropped by the quorum release.
  CHECK(MV_Barrier() == 0);
  std::vector<float> fin(4, -1.0f);
  CHECK(MV_GetArrayTable(h, fin.data(), 4) == 0);
  for (float v : fin) CHECK(v == 4.0f);
  CHECK(MV_Barrier() == 0);
  CHECK(MV_ShutDown() == 0);
  printf("BACKUP_OK %d ratio=%s\n", me, ratio);
  return 0;
}

static int SspThroughputChild(const char* machine_file, const char* rank,
                              const char* staleness) {
  // SSP-earns-its-keep scenario (VERDICT r4 action 7): 2 workers, 10
  // clocks.  Rank 0 computes a steady 40 ms per clock; rank 1 is a
  // JITTERY straggler — alternating 0 / 160 ms (same 80 ms average).
  // With -staleness=0 every rank-0 read rendezvouses with the
  // straggler's CURRENT clock, so rank 0 pays the straggler's
  // worst-case path.  With -staleness=3 the window absorbs the
  // alternation — rank 0 only ever waits for clock c-3, which the
  // straggler's average pace has long passed.  Rank 0 prints its timed
  // window; the pytest side runs both modes and asserts the SSP run is
  // meaningfully faster on the SAME straggler profile.
  std::string mf = std::string("-machine_file=") + machine_file;
  std::string rk = std::string("-rank=") + rank;
  std::string st = std::string("-staleness=") + staleness;
  const char* argv2[] = {mf.c_str(), rk.c_str(), st.c_str(),
                         "-updater_type=default", "-log_level=error",
                         "-rpc_timeout_ms=30000",
                         "-barrier_timeout_ms=30000"};
  CHECK(MV_Init(7, argv2) == 0);
  int me = MV_WorkerId();
  const int kClocks = 10;
  int32_t h;
  CHECK(MV_NewArrayTable(8, &h) == 0);
  CHECK(MV_Barrier() == 0);

  std::vector<float> delta(8, 1.0f), out(8, 0.0f);
  auto t0 = std::chrono::steady_clock::now();
  for (int c = 0; c < kClocks; ++c) {
    int ms = (me == 0) ? 40 : ((c % 2) ? 160 : 0);   // the "compute"
    std::this_thread::sleep_for(std::chrono::milliseconds(ms));
    CHECK(MV_AddAsyncArrayTable(h, delta.data(), 8) == 0);
    CHECK(MV_Clock() == 0);
    CHECK(MV_GetArrayTable(h, out.data(), 8) == 0);  // SSP-gated read
  }
  auto dt_ms = std::chrono::duration_cast<std::chrono::milliseconds>(
                   std::chrono::steady_clock::now() - t0)
                   .count();
  if (me == 0)
    printf("SSP_TPUT ms=%lld staleness=%s\n",
           static_cast<long long>(dt_ms), staleness);
  CHECK(MV_Barrier() == 0);
  CHECK(MV_ShutDown() == 0);
  printf("SSP_TPUT_OK %d\n", me);
  return 0;
}

static int SspDeadChild(const char* machine_file, const char* rank) {
  // SSP + dead straggler: rank 1 rendezvouses then crashes without ever
  // ticking.  Rank 0 races ahead; its held Gets must fail fast (rc=-3,
  // bounded by -rpc_timeout_ms) and repeated attempts must keep failing
  // fast — each park purges the previous expired one (no unbounded
  // held_gets_ growth, no hang).
  std::string mf = std::string("-machine_file=") + machine_file;
  std::string rk = std::string("-rank=") + rank;
  const char* argv2[] = {mf.c_str(), rk.c_str(), "-staleness=0",
                         "-updater_type=default", "-log_level=error",
                         "-connect_retry_ms=500", "-rpc_timeout_ms=2000",
                         "-barrier_timeout_ms=2000"};
  CHECK(MV_Init(8, argv2) == 0);
  int me = MV_WorkerId();
  int32_t h;
  CHECK(MV_NewArrayTable(4, &h) == 0);
  CHECK(MV_Barrier() == 0);
  if (me == 1) _exit(0);  // crash before any MV_Clock

  std::this_thread::sleep_for(std::chrono::milliseconds(300));
  CHECK(MV_Clock() == 0);  // now ahead of the dead rank 1 forever
  auto t0 = std::chrono::steady_clock::now();
  std::vector<float> out(4, 0.0f);
  CHECK(MV_GetArrayTable(h, out.data(), 4) == -3);
  CHECK(MV_GetArrayTable(h, out.data(), 4) == -3);  // retry also bounded
  auto ms = std::chrono::duration_cast<std::chrono::milliseconds>(
                std::chrono::steady_clock::now() - t0)
                .count();
  CHECK(ms < 15000);
  CHECK(MV_ShutDown() == 0);
  printf("SSP_DEAD_OK\n");
  return 0;
}

// Scenario children: a CHECK failure returns without MV_ShutDown, and
// live runtime threads then crash during normal process exit (rc=-11),
// MPI scenarios (SURVEY §2.17, reference net/mpi_net.h).  MPI allows one
// init/finalize cycle per process, so each scenario is its own argv[1]
// dispatch (own subprocess from pytest).  When no usable libmpi resolves
// they print MPI_UNAVAILABLE and exit 0 — the pytest side skips.

// Direct wire exercise: a Message with real float payload rides MPI to
// this rank (self-send traverses the actual transport — MpiNet::Send →
// MPI_Send → probe thread → inbound callback; the Zoo's local-dst
// shortcut is deliberately not in the path).
static int MpiSelfScenario() {
  if (!mvtpu::MpiNet::Available()) {
    printf("MPI_UNAVAILABLE\n");
    return 0;
  }
  mvtpu::MpiNet net;
  mvtpu::MtQueue<mvtpu::Message> inbox;
  CHECK(net.Init([&](mvtpu::Message&& m) { inbox.Push(std::move(m)); }));
  CHECK(net.size() >= 1);

  mvtpu::Message msg;
  msg.src = net.rank();
  msg.dst = net.rank();
  msg.type = mvtpu::MsgType::RequestAdd;
  msg.table_id = 7;
  msg.msg_id = 1234;
  mvtpu::Blob payload(4 * sizeof(float));
  for (int i = 0; i < 4; ++i) payload.As<float>()[i] = 0.5f * static_cast<float>(i);
  msg.data.push_back(payload);
  CHECK(net.Send(net.rank(), msg));

  mvtpu::Message got;
  CHECK(inbox.Pop(&got));
  CHECK(got.src == net.rank() && got.dst == net.rank());
  CHECK(got.type == mvtpu::MsgType::RequestAdd);
  CHECK(got.table_id == 7 && got.msg_id == 1234);
  CHECK(got.data.size() == 1 && got.data[0].count<float>() == 4);
  for (int i = 0; i < 4; ++i)
    CHECK(std::fabs(got.data[0].As<float>()[i] - 0.5f * static_cast<float>(i)) < 1e-6f);

  // Unknown rank → clean false, not an MPI abort.
  CHECK(!net.Send(net.size() + 3, msg));

  // Concurrent senders: 4 threads x 50 sends through the serial-mode
  // lock (Isend + Test polling) while the probe thread drains — the
  // exact interleaving a worker/server pair generates under load.
  std::atomic<int> sent{0};
  std::vector<std::thread> senders;
  for (int s = 0; s < 4; ++s)
    senders.emplace_back([&net, &sent, &msg] {
      for (int i = 0; i < 50; ++i)
        if (net.Send(net.rank(), msg)) ++sent;
    });
  for (auto& t : senders) t.join();
  CHECK(sent.load() == 200);
  for (int i = 0; i < 200; ++i) {
    mvtpu::Message m;
    CHECK(inbox.Pop(&m));
    CHECK(m.table_id == 7 && m.data.size() == 1);
  }
  // Every send above completed or failed before Isend (unknown rank):
  // no payload may be parked in the orphan list — an increment here
  // would mean the error/timeout path fired on a healthy transport.
  CHECK(mvtpu::MpiNet::OrphanedSendBufCount() == 0);
  net.Stop();
  printf("MPI_SELF_OK rank=%d size=%d\n", net.rank(), net.size());
  return 0;
}

// Full runtime lifecycle over the MPI transport: MV_Init with
// -net_type=mpi (isolated singleton under a plain launch; the same path
// serves mpirun-launched jobs), table round trips, clean shutdown.
static int MpiZooScenario() {
  if (!mvtpu::MpiNet::Available()) {
    printf("MPI_UNAVAILABLE\n");
    return 0;
  }
  const char* argv[] = {"-net_type=mpi", "-updater_type=default",
                        "-log_level=error"};
  CHECK(MV_Init(3, argv) == 0);
  CHECK(MV_NumWorkers() >= 1);
  int32_t h = -1;
  CHECK(MV_NewArrayTable(16, &h) == 0);
  std::vector<float> delta(16, 2.0f), out(16, 0.0f);
  CHECK(MV_AddArrayTable(h, delta.data(), 16) == 0);
  CHECK(MV_Barrier() == 0);
  CHECK(MV_GetArrayTable(h, out.data(), 16) == 0);
  for (float v : out) CHECK(std::fabs(v - 2.0f) < 1e-6f);
  CHECK(MV_ShutDown() == 0);
  printf("MPI_ZOO_OK\n");
  return 0;
}

static int WireBenchChild(const char* machine_file, const char* rank,
                          const char* net_type) {
  // Direct transport microbench (VERDICT r4 action 6): message-size
  // sweep at the Net layer itself — no tables, no updaters — so a
  // transport regression is visible independent of the LR/w2v
  // aggregates.  Protocol per size S in 4 KiB → 16 MiB:
  //   put: rank 0 fires K S-byte messages at rank 1; rank 1 acks once
  //        after the K-th (time ≈ K·S / one-way bandwidth).
  //   get: rank 0 sends one tiny request; rank 1 answers K S-byte
  //        messages (the reply-payload direction).
  //   rtt: median of 64 empty round trips.
  // Output: one "WIRE <size> <put_gbps> <get_gbps> <rtt_ms>" line per
  // size on rank 0, parsed by bench.py into wire_{tcp,mpi}_* keys.
  using mvtpu::Blob;
  using mvtpu::Message;
  using mvtpu::MsgType;
  // net_type: "tcp" | "epoll" (rank transports via the -net_engine
  // factory seam) | "mpi" (the literal MPI wire).
  const bool mpi = std::string(net_type) == "mpi";
  int me = atoi(rank);

  // Payload sizes; K scaled so each probe moves ~32 MiB.
  const size_t kSizes[] = {4 << 10, 64 << 10, 1 << 20, 16 << 20};
  const int kNumSizes = 4, kPings = 64;
  auto burst_len = [](size_t s) {
    return std::max(2, (int)((32u << 20) / s));
  };

  // Directional protocol (each counter only ever counts the peer's
  // sends): rank 0 receives ReplyFlush (ping echo), ReplyAdd (burst
  // ack), RequestAdd (get payloads); rank 1 receives RequestFlush
  // (ping), RequestAdd (put payloads), RequestGet (serve request),
  // ControlRegister (done sentinel).
  std::atomic<int> pings{0}, payloads{0}, get_reqs{0}, echoes{0},
      burst_acks{0}, done{0};

  std::unique_ptr<mvtpu::RankTransport> rank_net;
  mvtpu::MpiNet mpin;
  mvtpu::Net* net = nullptr;
  auto inbound = [&](Message&& m) {
    switch (m.type) {
      case MsgType::RequestFlush: pings.fetch_add(1); break;
      case MsgType::ReplyFlush: echoes.fetch_add(1); break;
      case MsgType::RequestAdd: payloads.fetch_add(1); break;
      case MsgType::ReplyAdd: burst_acks.fetch_add(1); break;
      case MsgType::RequestGet: get_reqs.fetch_add(1); break;
      case MsgType::ControlRegister: done.store(1); break;
      default: break;
    }
  };
  if (mpi) {
    if (!mvtpu::MpiNet::Available()) {
      printf("MPI_UNAVAILABLE\n");
      return 0;
    }
    CHECK(mpin.Init(inbound));
    if (mpin.size() < 2) {
      // No mpirun in the image: singleton mode gives size 1 — report
      // and succeed so the bench can skip the MPI sweep cleanly.
      printf("WIRE_MPI_SINGLETON\n");
      mpin.Stop();
      return 0;
    }
    net = &mpin;
    me = mpin.rank();
  } else {
    auto eps = mvtpu::TcpNet::ParseMachineFile(machine_file);
    CHECK(eps.size() == 2);
    rank_net = mvtpu::MakeRankTransport(net_type);
    CHECK(rank_net != nullptr);
    CHECK(rank_net->Init(eps, me, inbound, 15000));
    net = rank_net.get();
  }

  auto mk = [&](MsgType t, size_t bytes) {
    Message m;
    m.type = t;
    m.src = me;
    m.dst = 1 - me;
    m.msg_id = 0;
    m.table_id = 0;
    if (bytes) {
      Blob b(bytes);
      memset(b.data(), 7, bytes);
      m.data.push_back(std::move(b));
    }
    return m;
  };
  auto wait_until = [&](std::atomic<int>& ctr, int target) {
    while (ctr.load() < target)
      std::this_thread::sleep_for(std::chrono::microseconds(50));
  };
  auto now = [] { return std::chrono::steady_clock::now(); };
  auto secs = [](auto d) {
    return std::chrono::duration<double>(d).count();
  };

  if (me == 0) {
    // Ping 0 is the startup rendezvous; 1..kPings time the RTT.
    std::vector<double> rtts;
    for (int i = 0; i <= kPings; ++i) {
      auto t0 = now();
      CHECK(net->Send(1, mk(MsgType::RequestFlush, 0)));
      wait_until(echoes, i + 1);
      if (i > 0) rtts.push_back(secs(now() - t0));
    }
    std::sort(rtts.begin(), rtts.end());
    double rtt_ms = rtts[rtts.size() / 2] * 1e3;

    int acks_seen = 0, payloads_seen = 0;
    for (size_t S : kSizes) {
      int K = burst_len(S);
      // put: K payloads, then the peer's counted ack.
      auto t0 = now();
      for (int i = 0; i < K; ++i)
        CHECK(net->Send(1, mk(MsgType::RequestAdd, S)));
      wait_until(burst_acks, ++acks_seen);
      double put_gbps = (double)K * (double)S / secs(now() - t0) / 1e9;
      // get: one request, K payloads back.
      t0 = now();
      CHECK(net->Send(1, mk(MsgType::RequestGet, 0)));
      payloads_seen += K;
      wait_until(payloads, payloads_seen);
      double get_gbps = (double)K * (double)S / secs(now() - t0) / 1e9;
      printf("WIRE %zu %.4f %.4f %.4f\n", S, put_gbps, get_gbps, rtt_ms);
    }
    CHECK(net->Send(1, mk(MsgType::ControlRegister, 0)));  // done
  } else {
    // Peer state machine: echo pings, ack completed put bursts (sizes
    // arrive in order), serve get requests, exit on the sentinel.
    int echoed = 0, served = 0, acked = 0, burst_base = 0;
    while (!done.load()) {
      while (echoed < pings.load()) {
        ++echoed;
        CHECK(net->Send(0, mk(MsgType::ReplyFlush, 0)));
      }
      if (acked < kNumSizes) {
        int K = burst_len(kSizes[acked]);
        if (payloads.load() - burst_base >= K) {
          burst_base += K;
          ++acked;
          CHECK(net->Send(0, mk(MsgType::ReplyAdd, 0)));
        }
      }
      if (served < get_reqs.load() && served < kNumSizes) {
        size_t S = kSizes[served];
        int K = burst_len(S);
        for (int i = 0; i < K; ++i)
          CHECK(net->Send(0, mk(MsgType::RequestAdd, S)));
        ++served;
      }
      std::this_thread::sleep_for(std::chrono::microseconds(50));
    }
  }
  net->Stop();
  printf("WIRE_BENCH_OK %d\n", me);
  return 0;
}

static int CodecWireChild(const char* machine_file, const char* rank) {
  // Compressed data plane acceptance (docs/wire_compression.md): the
  // SAME dense-add workload over the 2-process wire, once on the raw
  // codec and once on 1bit, measured via the net.bytes.sent ledger
  // (MV_WireStats).  1bit must ship >= 3x fewer bytes (it actually
  // ships ~30x fewer; the bar leaves room for framing/control traffic)
  // and the served values must stay within tolerance thanks to the
  // worker-side error feedback.  Rank 0 prints one
  //   CODEC <name> bytes=<b> msgs=<m> secs=<s>
  // line per phase (bench.py's wire_{raw,1bit}_* keys) plus the
  // headline ratio.
  std::string mf = std::string("-machine_file=") + machine_file;
  std::string rk = std::string("-rank=") + rank;
  const char* argv2[] = {mf.c_str(), rk.c_str(), "-updater_type=default",
                         "-log_level=error", "-rpc_timeout_ms=60000",
                         "-barrier_timeout_ms=60000"};
  CHECK(MV_Init(6, argv2) == 0);
  int me = MV_WorkerId();
  const int64_t kN = 1 << 16;  // 256 KiB of payload per full add
  const int kAdds = 8;
  std::vector<float> delta(kN), out(kN, -1.0f);
  // Per-add rotation of the deviation pattern (delta depends on i + a):
  // over kAdds (two full cycles of 4) every element's true sum is
  // kAdds * 1.375 EXACTLY, and the 1-bit error-feedback residual stays
  // bounded (a constant per-element deviation would instead grow it
  // linearly — the known two-scale-quantizer pathology real gradients
  // don't exhibit).
  auto fill_delta = [&](int a) {
    for (int64_t i = 0; i < kN; ++i)
      delta[i] = 1.0f + 0.25f * static_cast<float>((i + a) % 4);
  };
  double mean = 1.0 + 0.25 * (0 + 1 + 2 + 3) / 4.0;  // 1.375

  auto sent_bytes = []() -> long long {
    long long sb = 0, rb = 0, sm = 0, rm = 0;
    if (MV_WireStats(&sb, &rb, &sm, &rm) != 0) return -1;
    return sb;
  };
  auto sent_msgs = []() -> long long {
    long long sb = 0, rb = 0, sm = 0, rm = 0;
    if (MV_WireStats(&sb, &rb, &sm, &rm) != 0) return -1;
    return sm;
  };
  auto now = [] { return std::chrono::steady_clock::now(); };
  auto secs = [](auto d) {
    return std::chrono::duration<double>(d).count();
  };

  long long phase_bytes[2] = {0, 0}, phase_msgs[2] = {0, 0};
  double phase_secs[2] = {0, 0};
  const char* names[2] = {"raw", "1bit"};
  for (int phase = 0; phase < 2; ++phase) {
    int32_t h;
    CHECK(MV_NewArrayTable(kN, &h) == 0);
    if (phase == 1) CHECK(MV_SetTableCodec(h, "1bit") == 0);
    CHECK(MV_Barrier() == 0);
    long long b0 = sent_bytes(), m0 = sent_msgs();
    auto t0 = now();
    if (me == 0)
      for (int a = 0; a < kAdds; ++a) {
        fill_delta(a);
        CHECK(MV_AddArrayTable(h, delta.data(), kN) == 0);
      }
    CHECK(MV_Barrier() == 0);
    phase_secs[phase] = secs(now() - t0);
    phase_bytes[phase] = sent_bytes() - b0;
    phase_msgs[phase] = sent_msgs() - m0;
    CHECK(MV_GetArrayTable(h, out.data(), kN) == 0);
    const double want = kAdds * mean;  // exact per element (full cycles)
    if (phase == 0) {
      for (int64_t i = 0; i < kN; ++i)
        CHECK(fabs(out[i] - want) < 1e-3);
    } else {
      // 1bit + error feedback: per-element error bounded by the
      // un-flushed residual (~one deviation cycle's spread); the MEAN
      // is preserved tightly — comfortably inside the 5% loss bar.
      double sum = 0.0;
      for (int64_t i = 0; i < kN; ++i) {
        sum += out[i];
        CHECK(fabs(out[i] - want) < 1.5);
      }
      double got_mean = sum / static_cast<double>(kN);
      CHECK(fabs(got_mean - want) / want < 0.02);
    }
    CHECK(MV_Barrier() == 0);
  }
  if (me == 0) {
    CHECK(phase_bytes[0] > 0 && phase_bytes[1] > 0);
    double ratio = static_cast<double>(phase_bytes[0]) /
                   static_cast<double>(phase_bytes[1]);
    for (int p = 0; p < 2; ++p)
      printf("CODEC %s bytes=%lld msgs=%lld secs=%.4f\n", names[p],
             phase_bytes[p], phase_msgs[p], phase_secs[p]);
    printf("CODEC_RATIO %.2f\n", ratio);
    CHECK(ratio >= 3.0);  // acceptance bar (measured ~20-30x)
  }
  CHECK(MV_Barrier() == 0);
  CHECK(MV_ShutDown() == 0);
  printf("CODEC_WIRE_OK %d\n", me);
  return 0;
}

static int AggChild(const char* machine_file, const char* rank,
                    const char* engine) {
  // Worker-side add aggregation (docs/wire_compression.md): async dense
  // adds sum into a local buffer and ship as ONE wire message per flush
  // window; Get, Clock, and Barrier all force the flush, so read and
  // BSP/SSP visibility semantics are unchanged.  Counters: agg.adds
  // (absorbed adds), agg.flush (windows shipped).
  std::string mf = std::string("-machine_file=") + machine_file;
  std::string rk = std::string("-rank=") + rank;
  std::string eng = std::string("-net_engine=") + engine;
  const char* argv2[] = {mf.c_str(), rk.c_str(), eng.c_str(),
                         "-updater_type=default",
                         "-log_level=error", "-rpc_timeout_ms=60000",
                         "-barrier_timeout_ms=60000",
                         "-add_agg_bytes=16777216"};
  CHECK(MV_Init(8, argv2) == 0);
  int me = MV_WorkerId();
  int32_t h;
  CHECK(MV_NewArrayTable(16, &h) == 0);
  CHECK(MV_Barrier() == 0);
  std::vector<float> ones(16, 1.0f), out(16, -1.0f);
  long long adds = 0, flushes = 0;

  // Phase 1 — flush-on-Get: 6 tiny async adds collapse into one wire
  // message; the Get that follows must still read its own writes.
  if (me == 0) {
    for (int i = 0; i < 6; ++i)
      CHECK(MV_AddAsyncArrayTable(h, ones.data(), 16) == 0);
    CHECK(MV_QueryMonitor("agg.flush", &flushes) == 0);
    CHECK(flushes == 0);  // still buffered — nothing on the wire yet
    CHECK(MV_GetArrayTable(h, out.data(), 16) == 0);
    for (float v : out) CHECK(v == 6.0f);  // read-your-writes held
    CHECK(MV_QueryMonitor("agg.adds", &adds) == 0);
    CHECK(MV_QueryMonitor("agg.flush", &flushes) == 0);
    CHECK(adds == 6);
    CHECK(flushes == 1);  // >= 4 adds collapsed into ONE message
  }
  CHECK(MV_Barrier() == 0);

  // Phase 2 — flush-on-Clock: the SSP tick must ride BEHIND the
  // aggregated adds it announces.
  if (me == 0) {
    for (int i = 0; i < 4; ++i)
      CHECK(MV_AddAsyncArrayTable(h, ones.data(), 16) == 0);
    CHECK(MV_Clock() == 0);
    CHECK(MV_QueryMonitor("agg.flush", &flushes) == 0);
    CHECK(flushes == 2);
  } else {
    CHECK(MV_Clock() == 0);  // keep the worker clocks aligned
  }
  CHECK(MV_Barrier() == 0);
  CHECK(MV_GetArrayTable(h, out.data(), 16) == 0);
  for (float v : out) CHECK(v == 10.0f);  // both ranks see 6 + 4
  // Rendezvous between rounds (the NetChild race note): without this,
  // a slow rank's verify-Get races the fast rank's next-phase async
  // adds — the blocking engine's synchronous Send masked the window,
  // the reactor's enqueue-and-return Send opens it.
  CHECK(MV_Barrier() == 0);

  // Phase 3 — flush-on-Barrier: BSP visibility for aggregated adds.
  if (me == 0) {
    for (int i = 0; i < 5; ++i)
      CHECK(MV_AddAsyncArrayTable(h, ones.data(), 16) == 0);
  }
  CHECK(MV_Barrier() == 0);
  CHECK(MV_GetArrayTable(h, out.data(), 16) == 0);
  for (float v : out) CHECK(v == 15.0f);
  if (me == 0) {
    CHECK(MV_QueryMonitor("agg.adds", &adds) == 0);
    CHECK(MV_QueryMonitor("agg.flush", &flushes) == 0);
    CHECK(adds == 15);
    CHECK(flushes == 3);
  }
  CHECK(MV_Barrier() == 0);  // same verify-vs-next-round fence as above

  // Phase 4 — explicit flush (MV_FlushAdds) + blocking-add ordering:
  // a blocking add flushes the buffer first, so its ack covers both.
  if (me == 0) {
    CHECK(MV_AddAsyncArrayTable(h, ones.data(), 16) == 0);
    CHECK(MV_FlushAdds(h) == 0);
    CHECK(MV_QueryMonitor("agg.flush", &flushes) == 0);
    CHECK(flushes == 4);
    CHECK(MV_AddAsyncArrayTable(h, ones.data(), 16) == 0);
    CHECK(MV_AddArrayTable(h, ones.data(), 16) == 0);  // blocking
    CHECK(MV_GetArrayTable(h, out.data(), 16) == 0);
    for (float v : out) CHECK(v == 18.0f);
  }
  CHECK(MV_Barrier() == 0);
  CHECK(MV_ShutDown() == 0);
  printf("AGG_OK %d\n", me);
  return 0;
}

static int AggBenchChild(const char* machine_file, const char* rank) {
  // Aggregation throughput probe (bench.py add_agg keys): rank 0 fires
  // bursts of small async adds under an armed aggregation window and
  // reports the adds-per-wire-message collapse ratio from the
  // agg.adds/agg.flush counters.  Correctness is asserted (the final
  // read must equal the add count) so the numbers can't be "fast but
  // wrong".
  std::string mf = std::string("-machine_file=") + machine_file;
  std::string rk = std::string("-rank=") + rank;
  const char* argv2[] = {mf.c_str(), rk.c_str(), "-updater_type=default",
                         "-log_level=error", "-rpc_timeout_ms=60000",
                         "-barrier_timeout_ms=60000",
                         "-add_agg_bytes=262144"};
  CHECK(MV_Init(7, argv2) == 0);
  int me = MV_WorkerId();
  const int64_t kN = 1024;     // 4 KiB per add
  const int kBursts = 16, kPerBurst = 16;
  int32_t h;
  CHECK(MV_NewArrayTable(kN, &h) == 0);
  CHECK(MV_Barrier() == 0);
  std::vector<float> ones(kN, 1.0f), out(kN, -1.0f);
  auto t0 = std::chrono::steady_clock::now();
  if (me == 0) {
    for (int b = 0; b < kBursts; ++b) {
      for (int i = 0; i < kPerBurst; ++i)
        CHECK(MV_AddAsyncArrayTable(h, ones.data(), kN) == 0);
      CHECK(MV_FlushAdds(h) == 0);
    }
  }
  CHECK(MV_Barrier() == 0);
  double secs = std::chrono::duration<double>(
                    std::chrono::steady_clock::now() - t0)
                    .count();
  CHECK(MV_GetArrayTable(h, out.data(), kN) == 0);
  for (float v : out) CHECK(v == (float)(kBursts * kPerBurst));
  if (me == 0) {
    long long adds = 0, flushes = 0;
    CHECK(MV_QueryMonitor("agg.adds", &adds) == 0);
    CHECK(MV_QueryMonitor("agg.flush", &flushes) == 0);
    CHECK(adds == (long long)kBursts * kPerBurst);
    CHECK(flushes >= 1 && adds / flushes >= 4);
    printf("AGG_BENCH adds=%lld flushes=%lld secs=%.4f\n", adds, flushes,
           secs);
  }
  CHECK(MV_Barrier() == 0);
  CHECK(MV_ShutDown() == 0);
  printf("AGG_BENCH_OK %d\n", me);
  return 0;
}

static int AsyncOverlapChild(const char* machine_file, const char* rank) {
  // Async Get overlap scenario (reference WorkerTable::GetAsync + Wait,
  // SURVEY.md §2.10 / the AsyncBuffer idiom §2.24): the pull must make
  // wire progress WHILE the caller computes.  Protocol on rank 0: time
  // a blocking GetRows of a wire-heavy row set; start the identical
  // pull async; spend ~3x the blocking time "computing" (sleep); then
  // Wait() — which must return in well under the blocking time, since
  // the shards answered during the compute.  Bounds are generous (half
  // the blocking time plus 50 ms absolute slack) so a loaded CI host
  // cannot flake the assertion; the w2v native bench carries the
  // quantitative overlap claim.
  std::string mf = std::string("-machine_file=") + machine_file;
  std::string rk = std::string("-rank=") + rank;
  const char* argv2[] = {mf.c_str(), rk.c_str(), "-updater_type=default",
                         "-log_level=error", "-rpc_timeout_ms=60000",
                         "-barrier_timeout_ms=60000"};
  CHECK(MV_Init(6, argv2) == 0);
  int me = MV_WorkerId();
  const int64_t R = 20000, C = 128, K = 16000;   // pull ~8 MB of rows
  int32_t hm;
  CHECK(MV_NewMatrixTable(R, C, &hm) == 0);
  CHECK(MV_Barrier() == 0);
  if (me == 0) {
    std::vector<float> ones(R * C, 1.0f);
    CHECK(MV_AddMatrixTableAll(hm, ones.data(), R * C) == 0);
  }
  CHECK(MV_Barrier() == 0);  // the add is visible everywhere

  if (me == 0) {
    std::vector<int32_t> ids(K);
    for (int64_t i = 0; i < K; ++i)
      ids[i] = static_cast<int32_t>((i * 2654435761ull) % R);
    std::vector<float> out1(K * C, -1.0f), out2(K * C, -1.0f);
    auto now = [] { return std::chrono::steady_clock::now(); };
    auto secs = [](auto d) {
      return std::chrono::duration<double>(d).count();
    };

    auto t0 = now();
    CHECK(MV_GetMatrixTableByRows(hm, out1.data(), ids.data(), K, C) == 0);
    double t_sync = secs(now() - t0);

    int32_t ticket = -1;
    t0 = now();
    CHECK(MV_GetAsyncMatrixTableByRows(hm, out2.data(), ids.data(), K, C,
                                       &ticket) == 0);
    double t_start = secs(now() - t0);
    // The start call must not secretly block for the round trip.
    CHECK(t_start < t_sync * 0.5 + 0.05);
    std::this_thread::sleep_for(std::chrono::duration<double>(
        t_sync * 3.0 + 0.05));                     // the "compute"
    t0 = now();
    CHECK(MV_WaitGet(ticket) == 0);
    double t_wait = secs(now() - t0);
    CHECK(t_wait < t_sync * 0.5 + 0.05);           // overlapped, not serial
    CHECK(MV_WaitGet(ticket) == -2);               // ticket consumed
    for (int64_t i = 0; i < K * C; i += 997)
      CHECK(out2[i] == 1.0f);
    printf("overlap: sync=%.3fs start=%.4fs wait=%.4fs\n", t_sync,
           t_start, t_wait);
  }
  CHECK(MV_Barrier() == 0);
  CHECK(MV_ShutDown() == 0);
  printf("ASYNC_OVERLAP_OK %d\n", me);
  return 0;
}

// ---------------------------------------------------------------- chaos
// Scripted-failure scenarios (docs/fault_tolerance.md): the injection
// hooks in mvtpu/fault.h let these DRIVE the failure modes the dead_*
// scenarios can only approximate with real process death.  All run with
// a fixed seed so CI is deterministic.

static int ChaosRetryChild(const char* machine_file, const char* rank,
                           const char* engine) {
  // Send retry-then-succeed: the first two write attempts of rank 0's
  // blocking Add are injected failures; the bounded-backoff retry loop
  // reconnects and lands the delta.  Proves retries are counted and the
  // payload survives the faulty wire — on EITHER engine (the fault seam
  // consumes an attempt the same way on the reactor path).
  std::string mf = std::string("-machine_file=") + machine_file;
  std::string rk = std::string("-rank=") + rank;
  std::string eng = std::string("-net_engine=") + engine;
  const char* argv2[] = {mf.c_str(), rk.c_str(), eng.c_str(),
                         "-updater_type=default",
                         "-log_level=error", "-rpc_timeout_ms=30000",
                         "-barrier_timeout_ms=30000", "-send_retries=3",
                         "-send_backoff_ms=20", "-connect_retry_ms=2000"};
  CHECK(MV_Init(10, argv2) == 0);
  CHECK(MV_SetFaultSeed(1234) == 0);
  int me = MV_WorkerId();
  int32_t h;
  CHECK(MV_NewArrayTable(10, &h) == 0);
  CHECK(MV_Barrier() == 0);
  if (me == 0) {
    CHECK(MV_SetFaultN("fail_send", 2) == 0);
    std::vector<float> ones(10, 1.0f);
    CHECK(MV_AddArrayTable(h, ones.data(), 10) == 0);  // survives the faults
    long long retries = 0, injected = 0;
    CHECK(MV_QueryMonitor("net.retries", &retries) == 0);
    CHECK(MV_QueryMonitor("fault.fail_send", &injected) == 0);
    CHECK(retries >= 2);
    CHECK(injected == 2);
    CHECK(MV_ClearFaults() == 0);
  }
  CHECK(MV_Barrier() == 0);
  std::vector<float> out(10, -1.0f);
  CHECK(MV_GetArrayTable(h, out.data(), 10) == 0);
  for (float v : out) CHECK(v == 1.0f);
  CHECK(MV_Barrier() == 0);
  CHECK(MV_ShutDown() == 0);
  printf("CHAOS_RETRY_OK %d\n", me);
  return 0;
}

static int ChaosDropDupChild(const char* machine_file, const char* rank) {
  // Lossy/duplicating wire: rank 0 drops exactly one async-add message
  // (the remote shard misses the delta; the local shard applies), then
  // duplicates exactly one (the remote shard double-applies) — counters
  // and values both assert the injected behavior.  Shards split 5/5
  // (balanced contiguous partition): elements 0-4 live on rank 0,
  // 5-9 on rank 1; only the remote partition rides the faulty wire.
  std::string mf = std::string("-machine_file=") + machine_file;
  std::string rk = std::string("-rank=") + rank;
  const char* argv2[] = {mf.c_str(), rk.c_str(), "-updater_type=default",
                         "-log_level=error", "-rpc_timeout_ms=30000",
                         "-barrier_timeout_ms=30000"};
  CHECK(MV_Init(6, argv2) == 0);
  CHECK(MV_SetFaultSeed(1234) == 0);
  int me = MV_WorkerId();
  int32_t h;
  CHECK(MV_NewArrayTable(10, &h) == 0);
  CHECK(MV_Barrier() == 0);
  std::vector<float> ones(10, 1.0f), out(10, -1.0f);
  // Rank 1 STAGGERS its entry into the barrier that follows each armed
  // add: its own barrier-flush request would otherwise race rank 0's
  // add for the injected budget (rank 0's ReplyFlush to it is also a
  // wire send), and the budget must deterministically hit the add.
  if (me == 0) {
    CHECK(MV_SetFaultN("drop", 1) == 0);
    CHECK(MV_AddAsyncArrayTable(h, ones.data(), 10) == 0);  // remote lost
  } else {
    std::this_thread::sleep_for(std::chrono::milliseconds(500));
  }
  CHECK(MV_Barrier() == 0);
  CHECK(MV_GetArrayTable(h, out.data(), 10) == 0);
  for (int i = 0; i < 5; ++i) CHECK(out[i] == 1.0f);   // local applied
  for (int i = 5; i < 10; ++i) CHECK(out[i] == 0.0f);  // dropped on wire
  CHECK(MV_Barrier() == 0);
  if (me == 0) {
    CHECK(MV_SetFaultN("dup", 1) == 0);
    CHECK(MV_AddAsyncArrayTable(h, ones.data(), 10) == 0);  // remote 2x
  } else {
    std::this_thread::sleep_for(std::chrono::milliseconds(500));
  }
  CHECK(MV_Barrier() == 0);
  CHECK(MV_GetArrayTable(h, out.data(), 10) == 0);
  for (int i = 0; i < 10; ++i) CHECK(out[i] == 2.0f);  // 1+1 local, 0+2 remote
  if (me == 0) {
    long long dropped = 0, duped = 0;
    CHECK(MV_QueryMonitor("net.dropped", &dropped) == 0);
    CHECK(MV_QueryMonitor("net.duplicated", &duped) == 0);
    CHECK(dropped == 1);
    CHECK(duped == 1);
    CHECK(MV_ClearFaults() == 0);
  }
  CHECK(MV_Barrier() == 0);
  CHECK(MV_ShutDown() == 0);
  printf("CHAOS_DROPDUP_OK %d\n", me);
  return 0;
}

static int BridgeChild(const char* machine_file, const char* rank,
                       const char* engine) {
  // Borrowed sends UNDER CHAOS (docs/host_bridge.md): 2 ranks, arena
  // buffers shipped zero-copy over the wire with drop/dup/delay faults
  // armed on rank 0's sends.  The point is lifetime, not arithmetic:
  // a dropped frame's message dies on the retry path, a duplicated one
  // extends the borrow, a delayed one parks it — in every case the
  // arena must defer recycling until the LAST in-flight borrow drops,
  // and the sanitizer sweeps (tests/test_native.py) run this scenario
  // under TSan and ASan to prove no borrowed byte is read after reuse.
  std::string mf = std::string("-machine_file=") + machine_file;
  std::string rk = std::string("-rank=") + rank;
  std::string eng = std::string("-net_engine=") + engine;
  const char* argv2[] = {mf.c_str(), rk.c_str(), eng.c_str(),
                         "-updater_type=default", "-log_level=error",
                         "-rpc_timeout_ms=60000",
                         "-barrier_timeout_ms=60000"};
  CHECK(MV_Init(7, argv2) == 0);
  CHECK(MV_SetFaultSeed(4242) == 0);
  int me = MV_WorkerId();
  int32_t h;
  CHECK(MV_NewArrayTable(10, &h) == 0);
  CHECK(MV_Barrier() == 0);

  void* p = nullptr;
  CHECK(MV_ArenaAcquire(10 * sizeof(float), &p) == 0);
  float* buf = static_cast<float*>(p);
  for (int i = 0; i < 10; ++i) buf[i] = 1.0f;

  // Round 1: rank 0 drops exactly one borrowed async add's remote frame
  // (same stagger discipline as ChaosDropDupChild so the budget
  // deterministically hits the add, not rank 1's barrier flush).
  if (me == 0) {
    CHECK(MV_SetFaultN("drop", 1) == 0);
    CHECK(MV_AddAsyncArrayTableBorrowed(h, buf, 10) == 0);
  } else {
    std::this_thread::sleep_for(std::chrono::milliseconds(500));
  }
  CHECK(MV_Barrier() == 0);
  std::vector<float> out(10, -1.0f);
  CHECK(MV_GetArrayTable(h, out.data(), 10) == 0);
  if (me == 0) {
    for (int i = 0; i < 5; ++i) CHECK(out[i] == 1.0f);   // local applied
    for (int i = 5; i < 10; ++i) CHECK(out[i] == 0.0f);  // dropped
  }
  CHECK(MV_Barrier() == 0);

  // Round 2: duplicate a borrowed async add's remote frame — the dup's
  // shallow message copy EXTENDS the borrow (two frames gather-read the
  // same arena bytes).
  if (me == 0) {
    CHECK(MV_SetFaultN("dup", 1) == 0);
    CHECK(MV_AddAsyncArrayTableBorrowed(h, buf, 10) == 0);
  } else {
    std::this_thread::sleep_for(std::chrono::milliseconds(500));
  }
  CHECK(MV_Barrier() == 0);
  CHECK(MV_GetArrayTable(h, out.data(), 10) == 0);
  if (me == 0) {
    for (int i = 0; i < 5; ++i) CHECK(out[i] == 2.0f);   // 2 local adds
    for (int i = 5; i < 10; ++i) CHECK(out[i] == 2.0f);  // 0 + dup(2)
  }
  CHECK(MV_Barrier() == 0);

  // Round 3: DELAY the remote frame and release the buffer mid-flight —
  // the worker-actor send sleeps 50 ms while the caller's Release lands,
  // so the recycle MUST defer behind the parked borrow (a naive arena
  // frees here and the delayed sendmsg reads freed memory — ASan red).
  if (me == 0) {
    CHECK(MV_SetFault("delay_ms", 50) == 0);
    CHECK(MV_SetFaultN("delay", 1) == 0);
    CHECK(MV_AddAsyncArrayTableBorrowed(h, buf, 10) == 0);
    CHECK(MV_ArenaRelease(p) == 0);  // mid-flight: defer, no use-after-free
  } else {
    std::this_thread::sleep_for(std::chrono::milliseconds(500));
    CHECK(MV_ArenaRelease(p) == 0);
  }
  CHECK(MV_Barrier() == 0);
  CHECK(MV_GetArrayTable(h, out.data(), 10) == 0);
  if (me == 0) {
    // Local shard: 3 clean applies; remote shard: drop(-1) + dup(+1)
    // cancel — both read 3.
    for (int i = 0; i < 10; ++i) CHECK(out[i] == 3.0f);
    long long duped = 0, delayed = 0;
    CHECK(MV_QueryMonitor("net.duplicated", &duped) == 0);
    CHECK(MV_QueryMonitor("net.delayed", &delayed) == 0);
    CHECK(duped == 1);
    CHECK(delayed == 1);
    CHECK(MV_ClearFaults() == 0);
  }
  CHECK(MV_Barrier() == 0);
  // Every borrow must drain: no buffer may stay parked in flight once
  // the fleet quiesced (spin briefly — the dup's extra frame finishes
  // asynchronously of the barrier).
  long long in_flight = 1, deferred = 0;
  for (int spin = 0; spin < 100 && in_flight != 0; ++spin) {
    CHECK(MV_ArenaStats(nullptr, nullptr, nullptr, &in_flight, &deferred,
                        nullptr, nullptr) == 0);
    std::this_thread::sleep_for(std::chrono::milliseconds(10));
  }
  CHECK(in_flight == 0);
  if (me == 0) CHECK(deferred >= 1);  // the mid-flight release deferred
  CHECK(MV_Barrier() == 0);
  CHECK(MV_ShutDown() == 0);
  printf("BRIDGE_CHAOS_OK %d\n", me);
  return 0;
}

static int EmbedChild(const char* machine_file, const char* rank,
                      const char* engine) {
  // Sparse-embedding data plane UNDER CHAOS (docs/embedding.md): 2
  // ranks, multi-shard borrowed AddRows shipping run-iovecs out of one
  // arena buffer, and hot-key replica pushes — with drop/dup/delay
  // armed on rank 1's sends.  Like BridgeChild the point is lifetime
  // and semantics, not arithmetic luck: a dropped run frame loses
  // exactly the remote shard's rows, a duplicated one doubles them, a
  // delayed one parks the borrow past a mid-flight release (deferred
  // recycle), and a dropped/duplicated/delayed replica push can never
  // make the version gate serve a stale row.  The sanitizer sweeps
  // (tests/test_native.py) run this under TSan and ASan.
  std::string mf = std::string("-machine_file=") + machine_file;
  std::string rk = std::string("-rank=") + rank;
  std::string eng = std::string("-net_engine=") + engine;
  const char* argv2[] = {mf.c_str(), rk.c_str(), eng.c_str(),
                         "-updater_type=default", "-log_level=error",
                         "-rpc_timeout_ms=60000",
                         "-barrier_timeout_ms=60000",
                         "-hotkey_topk=8", "-replica_lease_ms=50"};
  CHECK(MV_Init(9, argv2) == 0);
  CHECK(MV_SetFaultSeed(2424) == 0);
  int me = MV_WorkerId();
  int32_t h;
  CHECK(MV_NewMatrixTable(16, 4, &h) == 0);  // 8 rows per shard
  CHECK(MV_Barrier() == 0);

  // Rank 1 drives: SORTED ids {1, 9} span both shards — row 1 is
  // REMOTE (rank 0's shard), row 9 local — so the borrowed
  // multi-shard run path (one iovec per shard) is what every round
  // exercises.
  void* p = nullptr;
  CHECK(MV_ArenaAcquire(2 * 4 * sizeof(float), &p) == 0);
  float* buf = static_cast<float*>(p);
  for (int i = 0; i < 8; ++i) buf[i] = 1.0f;
  int32_t ids[2] = {1, 9};
  std::vector<float> out(16 * 4, -1.0f);
  int32_t all[16];
  for (int i = 0; i < 16; ++i) all[i] = i;

  // Round 1: drop exactly the remote run frame — row 1's add dies,
  // row 9's local apply lands.
  if (me == 1) {
    CHECK(MV_SetFaultN("drop", 1) == 0);
    // No ClearFaults here: the async send happens on the worker-actor
    // thread, so the N=1 budget must stay armed until IT fires (the
    // BridgeChild discipline) — budgets self-consume.
    CHECK(MV_AddAsyncMatrixTableByRowsBorrowed(h, buf, ids, 2, 4) == 0);
  } else {
    std::this_thread::sleep_for(std::chrono::milliseconds(500));
  }
  CHECK(MV_Barrier() == 0);
  CHECK(MV_GetMatrixTableByRows(h, out.data(), all, 16, 4) == 0);
  if (me == 1) {
    CHECK(out[1 * 4] == 0.0f);   // dropped remote run
    CHECK(out[9 * 4] == 1.0f);   // local run applied
  }
  CHECK(MV_Barrier() == 0);

  // Round 2: duplicate the remote run frame — the dup's shallow copy
  // EXTENDS the borrow; row 1 applies twice.
  if (me == 1) {
    CHECK(MV_SetFaultN("dup", 1) == 0);
    CHECK(MV_AddAsyncMatrixTableByRowsBorrowed(h, buf, ids, 2, 4) == 0);
  } else {
    std::this_thread::sleep_for(std::chrono::milliseconds(500));
  }
  CHECK(MV_Barrier() == 0);
  CHECK(MV_GetMatrixTableByRows(h, out.data(), all, 16, 4) == 0);
  if (me == 1) {
    CHECK(out[1 * 4] == 2.0f);   // 0 + dup(2)
    CHECK(out[9 * 4] == 2.0f);   // 1 + 1
  }
  CHECK(MV_Barrier() == 0);

  // Round 3: DELAY the remote run frame and release the arena buffer
  // mid-flight — the recycle must defer behind the parked borrow (a
  // naive arena frees and the delayed sendmsg reads freed memory:
  // ASan red).
  if (me == 1) {
    CHECK(MV_SetFault("delay_ms", 50) == 0);
    CHECK(MV_SetFaultN("delay", 1) == 0);
    CHECK(MV_AddAsyncMatrixTableByRowsBorrowed(h, buf, ids, 2, 4) == 0);
    CHECK(MV_ArenaRelease(p) == 0);  // mid-flight: defer, no UAF
  } else {
    std::this_thread::sleep_for(std::chrono::milliseconds(500));
    CHECK(MV_ArenaRelease(p) == 0);
  }
  CHECK(MV_Barrier() == 0);
  CHECK(MV_GetMatrixTableByRows(h, out.data(), all, 16, 4) == 0);
  if (me == 1) {
    CHECK(out[1 * 4] == 3.0f);
    CHECK(out[9 * 4] == 3.0f);
  }
  CHECK(MV_Barrier() == 0);

  // Replica plane under chaos.  Rank 1 warms rank 0's tracker on rows
  // 1/2 (remote gets), then refreshes with faults armed:
  //  - DROPPED push: the refresh round-trip times out (bounded by a
  //    lowered rpc deadline) and the replica simply stays cold — no
  //    torn install;
  //  - DUPLICATED push: OnReplicaPush is idempotent (never rolls a
  //    fresher entry back);
  //  - after a fresh add, a replica read must serve the NEW value
  //    (version gate, cross-chaos).
  CHECK(MV_SetHotKeyReplica(1) == 0);
  if (me == 1) {
    int32_t warm[2] = {1, 2};
    std::vector<float> w(2 * 4);
    for (int i = 0; i < 6; ++i)
      CHECK(MV_GetMatrixTableByRows(h, w.data(), warm, 2, 4) == 0);
    CHECK(MV_SetFlag("rpc_timeout_ms", "500") == 0);
    CHECK(MV_SetFaultN("drop", 1) == 0);
    CHECK(MV_ReplicaRefresh(h) != 0);  // dropped push: bounded failure
    CHECK(MV_ClearFaults() == 0);
    CHECK(MV_SetFlag("rpc_timeout_ms", "60000") == 0);
    CHECK(MV_SetFaultN("dup", 1) == 0);
    CHECK(MV_ReplicaRefresh(h) == 0);  // duplicated push: idempotent
    CHECK(MV_ClearFaults() == 0);
    long long rows = 0;
    CHECK(MV_ReplicaStats(h, nullptr, nullptr, &rows, nullptr,
                          nullptr) == 0);
    CHECK(rows >= 1);
    // Fresh blocking add to replicated row 1, then read: the version
    // gate must refetch — never the pre-add replica value.
    float bump[4] = {10.0f, 10.0f, 10.0f, 10.0f};
    int32_t one[1] = {1};
    CHECK(MV_AddMatrixTableByRows(h, bump, one, 1, 4) == 0);
    std::vector<float> fresh(4, -1.0f);
    CHECK(MV_GetMatrixTableByRows(h, fresh.data(), one, 1, 4) == 0);
    CHECK(fresh[0] == 13.0f);
  } else {
    std::this_thread::sleep_for(std::chrono::milliseconds(200));
  }
  CHECK(MV_Barrier() == 0);
  CHECK(MV_SetHotKeyReplica(0) == 0);

  // Every borrow must drain (the dup's extra frame finishes async of
  // the barrier).
  long long in_flight = 1, deferred = 0;
  for (int spin = 0; spin < 100 && in_flight != 0; ++spin) {
    CHECK(MV_ArenaStats(nullptr, nullptr, nullptr, &in_flight, &deferred,
                        nullptr, nullptr) == 0);
    std::this_thread::sleep_for(std::chrono::milliseconds(10));
  }
  CHECK(in_flight == 0);
  if (me == 1) CHECK(deferred >= 1);
  CHECK(MV_Barrier() == 0);
  CHECK(MV_ShutDown() == 0);
  printf("EMBED_CHAOS_OK %d\n", me);
  return 0;
}

static int ChaosBarrierTimeoutChild(const char* machine_file,
                                    const char* rank) {
  // Deadline-bounded barrier: rank 1 simply never arrives (busy for 4 s)
  // — rank 0's barrier must return -3 within the configured deadline
  // with an error NAMING rank 1 (asserted by the pytest side on this
  // process's stderr), never hang.
  std::string mf = std::string("-machine_file=") + machine_file;
  std::string rk = std::string("-rank=") + rank;
  const char* argv2[] = {mf.c_str(), rk.c_str(), "-updater_type=default",
                         "-log_level=error", "-rpc_timeout_ms=3000",
                         "-barrier_timeout_ms=1500",
                         "-connect_retry_ms=300"};
  CHECK(MV_Init(7, argv2) == 0);
  int me = MV_WorkerId();
  int32_t h;
  CHECK(MV_NewArrayTable(4, &h) == 0);
  if (me == 1) {
    // The straggler: never joins this barrier round, then leaves
    // without a goodbye (its own shutdown barrier would also time out).
    std::this_thread::sleep_for(std::chrono::milliseconds(4000));
    fflush(stdout);
    printf("CHAOS_BARRIER_OK 1\n");
    fflush(stdout);
    _exit(0);
  }
  auto t0 = std::chrono::steady_clock::now();
  CHECK(MV_Barrier() == -3);
  auto ms = std::chrono::duration_cast<std::chrono::milliseconds>(
                std::chrono::steady_clock::now() - t0)
                .count();
  CHECK(ms >= 1400 && ms < 10000);  // deadline honored, not a hang
  CHECK(MV_ShutDown() == 0);        // its barrier times out and proceeds
  printf("CHAOS_BARRIER_OK %d\n", me);
  return 0;
}

static int ChaosHeartbeatChild(const char* machine_file, const char* rank) {
  // Dropped-peer heartbeat report: leases on (-heartbeat_ms=100), rank 1
  // crashes after the rendezvous; within a few intervals rank 0 reports
  // the dead peer (MV_DeadPeerCount, Dashboard hb.missed) WITHOUT any
  // blocking call having to discover it the hard way.
  std::string mf = std::string("-machine_file=") + machine_file;
  std::string rk = std::string("-rank=") + rank;
  const char* argv2[] = {mf.c_str(), rk.c_str(), "-updater_type=default",
                         "-log_level=error", "-rpc_timeout_ms=3000",
                         "-barrier_timeout_ms=1500", "-heartbeat_ms=100",
                         "-heartbeat_timeout_ms=400",
                         "-connect_retry_ms=300"};
  CHECK(MV_Init(9, argv2) == 0);
  int me = MV_WorkerId();
  CHECK(MV_Barrier() == 0);
  if (me == 1) _exit(0);  // crash: no shutdown, no goodbye

  CHECK(MV_DeadPeerCount() == 0);  // lease still fresh at the crash
  // Lease expiry is 400 ms of silence; poll up to 3 s for the report.
  int dead = 0;
  for (int tries = 0; tries < 150 && dead == 0; ++tries) {
    std::this_thread::sleep_for(std::chrono::milliseconds(20));
    dead = MV_DeadPeerCount();
  }
  CHECK(dead == 1);
  long long missed = 0;
  CHECK(MV_QueryMonitor("hb.missed", &missed) == 0);
  CHECK(missed >= 1);
  CHECK(MV_ShutDown() == 0);  // shutdown barrier times out and proceeds
  printf("CHAOS_HB_OK %d\n", me);
  return 0;
}

static int ChaosQuietChild(const char* machine_file, const char* rank) {
  // Injection disabled ⇒ zero observable difference: a normal 2-rank
  // round trip leaves every injected-path counter at exactly zero.
  std::string mf = std::string("-machine_file=") + machine_file;
  std::string rk = std::string("-rank=") + rank;
  const char* argv2[] = {mf.c_str(), rk.c_str(), "-updater_type=default",
                         "-log_level=error", "-rpc_timeout_ms=30000",
                         "-barrier_timeout_ms=30000"};
  CHECK(MV_Init(6, argv2) == 0);
  int me = MV_WorkerId();
  int32_t h;
  CHECK(MV_NewArrayTable(10, &h) == 0);
  CHECK(MV_Barrier() == 0);
  std::vector<float> ones(10, 1.0f), out(10, -1.0f);
  CHECK(MV_AddArrayTable(h, ones.data(), 10) == 0);
  CHECK(MV_Barrier() == 0);
  CHECK(MV_GetArrayTable(h, out.data(), 10) == 0);
  for (float v : out) CHECK(v == 2.0f);
  for (const char* counter :
       {"net.retries", "net.dropped", "net.delayed", "net.duplicated",
        "fault.fail_send", "hb.missed"}) {
    long long c = -1;
    CHECK(MV_QueryMonitor(counter, &c) == 0);
    CHECK(c == 0);
  }
  CHECK(MV_Barrier() == 0);
  CHECK(MV_ShutDown() == 0);
  printf("CHAOS_QUIET_OK %d\n", me);
  return 0;
}

static int TestRepl() {
  using mvtpu::Message;
  using mvtpu::MsgType;
  // ---- shard-hint wire round trip (version-tolerant bias) -----------
  {
    Message m;
    m.type = MsgType::RequestGet;
    m.table_id = 2;
    m.msg_id = 9;
    m.shard = 3;
    Message back = Message::Deserialize(m.Serialize());
    CHECK(back.shard == 3);
    Message unhinted;
    unhinted.type = MsgType::RequestGet;
    Message back2 = Message::Deserialize(unhinted.Serialize());
    CHECK(back2.shard == -1);  // old wire value 0 = no hint
    // Zero-copy parse adopts the hint too.
    mvtpu::Blob frame = m.Serialize();
    auto slab = std::make_shared<std::vector<char>>(
        frame.data(), frame.data() + frame.size());
    Message viewed;
    CHECK(Message::DeserializeView(slab, 0, slab->size(), &viewed));
    CHECK(viewed.shard == 3);
  }
  // ---- MemStream: the snapshot wire form ----------------------------
  {
    mvtpu::repl::MemStream ms;
    int64_t vals[3] = {7, -1, 42};
    CHECK(ms.Write(vals, sizeof(vals)) == sizeof(vals));
    mvtpu::repl::MemStream in(ms.bytes());
    int64_t got[3] = {0, 0, 0};
    CHECK(in.Read(got, sizeof(got)) == sizeof(got));
    CHECK(got[0] == 7 && got[1] == -1 && got[2] == 42);
    char extra;
    CHECK(in.Read(&extra, 1) == 0);  // drained
  }
  // ---- whole-shard catch-up: Store -> Load, beacons converge --------
  {
    mvtpu::MatrixServerTable primary(8, 4, mvtpu::UpdaterType::kDefault,
                                     /*rank=*/0, /*size=*/2);
    mvtpu::MatrixServerTable backup(8, 4, mvtpu::UpdaterType::kDefault,
                                    /*rank=*/0, /*size=*/2);
    Message add;
    add.type = MsgType::RequestAdd;
    mvtpu::AddOption opt;
    std::vector<int32_t> ids = {0, 2, 3};
    std::vector<float> delta(3 * 4, 1.5f);
    add.data.emplace_back(&opt, sizeof(opt));
    add.data.emplace_back(ids.data(), ids.size() * sizeof(int32_t));
    add.data.emplace_back(delta.data(), delta.size() * sizeof(float));
    primary.ProcessAdd(add);
    CHECK(primary.BucketChecksums() != backup.BucketChecksums());
    mvtpu::repl::MemStream snap;
    CHECK(primary.Store(&snap));
    mvtpu::repl::MemStream in(snap.bytes());
    CHECK(backup.Load(&in));
    CHECK(primary.BucketChecksums() == backup.BucketChecksums());
    // Version adoption: the installed backup must never stamp BEHIND
    // what clients already saw from the primary.
    backup.AdvanceVersionTo(primary.version());
    CHECK(backup.version() >= primary.version());
    // Delta forwarding after the snapshot keeps them converged.
    primary.ProcessAdd(add);
    backup.ProcessAdd(add);
    CHECK(primary.BucketChecksums() == backup.BucketChecksums());
  }
  // ---- idempotent stamped replay: Covers + NoteDupSkipped -----------
  {
    mvtpu::audit::DeliveryBook book;
    mvtpu::audit::Arm(true);
    book.NoteApply(/*origin=*/1, 1, 3, /*table_id=*/0);
    CHECK(book.Covers(1, 1, 3));
    CHECK(book.Covers(1, 2, 2));
    CHECK(!book.Covers(1, 3, 4));   // hi past the watermark
    CHECK(!book.Covers(2, 1, 1));   // unseen origin
    book.NoteApply(1, 6, 6, 0);     // parked ahead of the 4..5 hole
    CHECK(book.Covers(1, 6, 6));    // pending ranges count as seen
    CHECK(!book.Covers(1, 4, 5));
    book.NoteDupSkipped(1, 1, 3);
    CHECK(book.Json().find("\"dups\":1") != std::string::npos);
    // Watermark export/import: the catch-up payload's book half.
    mvtpu::audit::DeliveryBook joined;
    joined.ImportWatermarks(book.ExportWatermarks());
    CHECK(joined.Covers(1, 1, 3));
  }
  return 0;
}

static int FailoverChild(const char* machine_file, const char* rank,
                         const char* engine) {
  // Replication + lease-triggered failover chaos (docs/replication.md):
  // a 3-rank fleet with -replication_factor=1 (shard i backed by
  // server i+1 mod 3).  After a converged warm phase rank 1 is
  // CRASHED (no goodbye); rank 2 — shard 1's backup — detects the
  // expired lease on its own (symmetric watching), promotes, and
  // broadcasts the routing-epoch flip; rank 0's retried adds re-route
  // and the fleet converges to the exact expected values with zero
  // lost acked adds (sync replication: an acked add is on both
  // replicas by construction).
  std::string mf = std::string("-machine_file=") + machine_file;
  std::string rk = std::string("-rank=") + rank;
  std::string eng = std::string("-net_engine=") + engine;
  const char* argv2[] = {mf.c_str(), rk.c_str(), eng.c_str(),
                         "-updater_type=default", "-log_level=error",
                         "-rpc_timeout_ms=2000",
                         "-barrier_timeout_ms=8000",
                         "-heartbeat_ms=100", "-heartbeat_timeout_ms=400",
                         "-replication_factor=1", "-repl_sync=true",
                         "-promote_auto=true", "-send_retries=2",
                         "-send_backoff_ms=20", "-connect_retry_ms=500"};
  CHECK(MV_Init(15, argv2) == 0);
  int me = MV_WorkerId();
  constexpr int64_t kN = 12;  // 3 shards of 4
  int32_t h;
  CHECK(MV_NewArrayTable(kN, &h) == 0);
  CHECK(MV_Barrier() == 0);

  std::vector<float> ones(kN, 1.0f), out(kN, -1.0f);
  // Warm phase: every rank lands one acked add — with sync replication
  // the ack certifies BOTH replicas applied it.
  CHECK(MV_AddArrayTable(h, ones.data(), kN) == 0);
  CHECK(MV_Barrier() == 0);
  CHECK(MV_GetArrayTable(h, out.data(), kN) == 0);
  for (float v : out) CHECK(v == 3.0f);
  long long fwd = 0, acks = 0;
  CHECK(MV_ReplicationStats(&fwd, &acks, nullptr, nullptr, nullptr,
                            nullptr, nullptr, nullptr) == 0);
  CHECK(fwd >= 1);  // this rank forwarded its shard's applies
  CHECK(MV_Barrier() == 0);

  // Dup-idempotence probe: with replication armed, a re-delivered
  // stamped frame (injected dup — the same wire-retry shape) must be
  // SKIPPED, not re-applied, so post-failover replays cannot double
  // count.  Rank 0 dups exactly one of its three shard sends; the
  // exact value proves the second delivery was dropped by the
  // Covers() gate (without it, one shard's slice would read +2).
  if (me == 0) {
    CHECK(MV_SetFaultSeed(17) == 0);
    CHECK(MV_SetFaultN("dup", 1) == 0);
    CHECK(MV_AddArrayTable(h, ones.data(), kN) == 0);
    CHECK(MV_ClearFaults() == 0);
  }
  CHECK(MV_Barrier() == 0);
  CHECK(MV_GetArrayTable(h, out.data(), kN) == 0);
  for (float v : out) CHECK(v == 4.0f);
  CHECK(MV_Barrier() == 0);

  if (me == 1) _exit(0);  // SIGKILL stand-in: no shutdown, no goodbye

  // Lease expiry detected by each SURVIVOR on its own (symmetric
  // watching — rank 0 is not special; the same path covers rank 0
  // itself being the corpse).
  int dead = 0;
  for (int tries = 0; tries < 300 && dead == 0; ++tries) {
    std::this_thread::sleep_for(std::chrono::milliseconds(20));
    dead = MV_DeadPeerCount();
  }
  CHECK(dead >= 1);
  // Promotion within the lease window: shard 1's routed owner
  // converges on global rank 2 (the promoted backup broadcasts the
  // epoch flip; rank 0 adopts it without restarting).
  int owner = -1;
  for (int tries = 0; tries < 300; ++tries) {
    owner = MV_ShardOwner(1);
    if (owner == 2) break;
    std::this_thread::sleep_for(std::chrono::milliseconds(20));
  }
  CHECK(owner == 2);
  CHECK(MV_RoutingEpoch() >= 1);
  if (me == 2) {
    long long promos = 0;
    CHECK(MV_ReplicationStats(nullptr, nullptr, nullptr, nullptr,
                              &promos, nullptr, nullptr, nullptr) == 0);
    CHECK(promos >= 1);
    CHECK(MV_BackupShard() == 1);
  }
  // Post-promotion traffic: blocking adds through the flipped route —
  // the promoted shard takes rank 1's slice without a fleet restart.
  // (The retry loop guards the adoption race; a whole-array add is
  // only exactness-safe once every shard routes to a live rank.)
  int failures = 0;
  for (int i = 0; i < 2; ++i) {
    int rc = -1;
    for (int tries = 0; tries < 100 && rc != 0; ++tries) {
      rc = MV_AddArrayTable(h, ones.data(), kN);
      if (rc != 0) {
        ++failures;
        std::this_thread::sleep_for(std::chrono::milliseconds(50));
      }
    }
    CHECK(rc == 0);
  }
  // Survivor rendezvous: the dead-leased rank is EXCUSED from the
  // barrier quorum (elastic membership) — then prove exact
  // convergence: 4 (warm + dup probe) + 2 rounds from each of the 2
  // survivors = 8 everywhere, the promoted shard included.
  CHECK(MV_Barrier() == 0);
  CHECK(MV_GetArrayTable(h, out.data(), kN) == 0);
  for (float v : out) CHECK(v == 8.0f);
  CHECK(MV_ShutDown() == 0);
  printf("FAILOVER_OK %d failures=%d\n", me, failures);
  return 0;
}

static int JoinChild(const char* ctrl, const char* port, const char* role,
                     const char* num, const char* is_ctrl) {
  // Elastic-join scenario (docs/replication.md): three dynamically
  // registered processes — controller (role all, rank 0), a
  // server-only node, and a WORKER-ONLY node that joins the
  // replication set live: MV_ReplJoin(0) creates backup instances,
  // announces via a routing-epoch flip (the primary starts
  // forwarding), and pulls a whole-shard catch-up snapshot.  The
  // joiner then takes shard 0 over through an operator-driven
  // promotion (MV_PromoteBackup) — traffic re-routes with no fleet
  // restart, and exact values prove the snapshot + delta stream
  // delivered the full shard (a join is replication + an epoch flip).
  std::string a_ctrl = std::string("-controller_endpoint=") + ctrl;
  std::string a_port = std::string("-port=") + port;
  std::string a_role = std::string("-role=") + role;
  std::string a_num = std::string("-num_nodes=") + num;
  std::string a_isc = std::string("-is_controller=") + is_ctrl;
  const char* argv2[] = {a_ctrl.c_str(), a_port.c_str(), a_role.c_str(),
                         a_num.c_str(),  a_isc.c_str(),
                         "-updater_type=default", "-log_level=error",
                         "-rpc_timeout_ms=20000",
                         "-barrier_timeout_ms=30000",
                         "-replication_factor=1", "-repl_sync=true",
                         "-promote_auto=false"};
  CHECK(MV_Init(12, argv2) == 0);
  int wid = MV_WorkerId(), sid = MV_ServerId();
  bool joiner = std::string(role) == "worker";
  constexpr int64_t kN = 8;  // 2 server shards of 4
  int32_t h;
  CHECK(MV_NewArrayTable(kN, &h) == 0);
  CHECK(MV_Barrier() == 0);

  std::vector<float> ones(kN, 1.0f), out(kN, -1.0f);
  if (wid >= 0) CHECK(MV_AddArrayTable(h, ones.data(), kN) == 0);
  CHECK(MV_Barrier() == 0);
  if (wid >= 0) {
    CHECK(MV_GetArrayTable(h, out.data(), kN) == 0);
    for (float v : out) CHECK(v == 2.0f);  // two worker-role ranks
  }
  CHECK(MV_Barrier() == 0);

  if (joiner) {
    CHECK(MV_BackupShard() == -1);  // worker-only: backs nothing yet
    CHECK(MV_ReplJoin(0) == 0);     // live join: announce + catch-up
    // Chaos re-run (the kill-mid-catch-up recovery path): the second
    // pull re-installs the snapshot idempotently.
    CHECK(MV_ReplJoin(0) == 0);
    CHECK(MV_BackupShard() == 0);
    long long catchups = 0;
    CHECK(MV_ReplicationStats(nullptr, nullptr, nullptr, nullptr,
                              nullptr, nullptr, nullptr,
                              &catchups) == 0);
    CHECK(catchups >= 1);
  }
  CHECK(MV_Barrier() == 0);
  // Post-join writes stream to the joiner as forwards.
  if (wid >= 0) CHECK(MV_AddArrayTable(h, ones.data(), kN) == 0);
  CHECK(MV_Barrier() == 0);

  if (joiner) {
    // Operator-driven handover: promote the joined backup into
    // serving shard 0 (the lease-expiry path minus the corpse).
    CHECK(MV_PromoteBackup(0) == 1);
    CHECK(MV_ShardOwner(0) != 0);
  }
  // Every rank adopts the epoch flip: shard 0's owner leaves rank 0.
  int owner = 0;
  for (int tries = 0; tries < 300; ++tries) {
    owner = MV_ShardOwner(0);
    if (owner != 0) break;
    std::this_thread::sleep_for(std::chrono::milliseconds(20));
  }
  CHECK(owner != 0);
  CHECK(MV_RoutingEpoch() >= 1);
  CHECK(MV_Barrier() == 0);
  // Traffic lands on the promoted joiner; exact values prove the
  // catch-up snapshot + forwarded deltas delivered the whole shard
  // (no torn read: 2 warm + 2 post-join + 2 post-promotion).
  if (wid >= 0) {
    CHECK(MV_AddArrayTable(h, ones.data(), kN) == 0);
  }
  CHECK(MV_Barrier() == 0);
  if (wid >= 0) {
    CHECK(MV_GetArrayTable(h, out.data(), kN) == 0);
    for (float v : out) CHECK(v == 6.0f);
  }
  CHECK(MV_Barrier() == 0);
  CHECK(MV_ShutDown() == 0);
  printf("JOIN_OK %s wid=%d sid=%d\n", role, wid, sid);
  return 0;
}

// masking the CHECK diagnostic — _exit skips teardown and keeps rc=1.
static int ScenarioExit(int rc) {
  fflush(stdout);
  fflush(stderr);
  if (rc) _exit(rc);
  return 0;
}

int main(int argc, char** argv) {
  if ((argc == 4 || argc == 5) && std::string(argv[1]) == "net_child")
    return ScenarioExit(
        NetChild(argv[2], argv[3], argc == 5 ? argv[4] : "epoll"));
  if (argc == 5 && std::string(argv[1]) == "net_updater")
    return ScenarioExit(NetUpdaterChild(argv[2], argv[3], argv[4]));
  if (argc == 7 && std::string(argv[1]) == "register")
    return ScenarioExit(
        RegisterChild(argv[2], argv[3], argv[4], argv[5], argv[6]));
  if (argc == 5 && std::string(argv[1]) == "ssp_child")
    return ScenarioExit(SspChild(argv[2], argv[3], argv[4]));
  if (argc == 5 && std::string(argv[1]) == "ssp_tput")
    return ScenarioExit(SspThroughputChild(argv[2], argv[3], argv[4]));
  if (argc == 5 && std::string(argv[1]) == "backup_child")
    return ScenarioExit(BackupChild(argv[2], argv[3], argv[4]));
  if (argc == 4 && std::string(argv[1]) == "ssp_dead")
    return ScenarioExit(SspDeadChild(argv[2], argv[3]));
  if (argc == 5 && std::string(argv[1]) == "wire_bench")
    return ScenarioExit(WireBenchChild(argv[2], argv[3], argv[4]));
  if (argc == 4 && std::string(argv[1]) == "async_overlap")
    return ScenarioExit(AsyncOverlapChild(argv[2], argv[3]));
  if (argc == 4 && std::string(argv[1]) == "codec_wire")
    return ScenarioExit(CodecWireChild(argv[2], argv[3]));
  if ((argc == 4 || argc == 5) && std::string(argv[1]) == "embed_child")
    return ScenarioExit(EmbedChild(argv[2], argv[3],
                                   argc == 5 ? argv[4] : "epoll"));
  if ((argc == 4 || argc == 5) && std::string(argv[1]) == "bridge_child")
    return ScenarioExit(BridgeChild(argv[2], argv[3],
                                    argc == 5 ? argv[4] : "epoll"));
  if ((argc == 4 || argc == 5) && std::string(argv[1]) == "agg_child")
    return ScenarioExit(AggChild(argv[2], argv[3],
                                 argc == 5 ? argv[4] : "epoll"));
  if (argc == 4 && std::string(argv[1]) == "agg_bench")
    return ScenarioExit(AggBenchChild(argv[2], argv[3]));
  if ((argc == 4 || argc == 5) && std::string(argv[1]) == "chaos_retry")
    return ScenarioExit(
        ChaosRetryChild(argv[2], argv[3], argc == 5 ? argv[4] : "epoll"));
  if (argc == 4 && std::string(argv[1]) == "chaos_dropdup")
    return ScenarioExit(ChaosDropDupChild(argv[2], argv[3]));
  if (argc == 4 && std::string(argv[1]) == "chaos_barrier")
    return ScenarioExit(ChaosBarrierTimeoutChild(argv[2], argv[3]));
  if (argc == 4 && std::string(argv[1]) == "chaos_heartbeat")
    return ScenarioExit(ChaosHeartbeatChild(argv[2], argv[3]));
  if (argc == 4 && std::string(argv[1]) == "chaos_quiet")
    return ScenarioExit(ChaosQuietChild(argv[2], argv[3]));
  if (argc == 4 && std::string(argv[1]) == "dead_peer")
    return ScenarioExit(DeadPeerChild(argv[2], argv[3]));
  if (argc == 4 && std::string(argv[1]) == "dead_server")
    return ScenarioExit(DeadServerChild(argv[2], argv[3]));
  if ((argc == 4 || argc == 5) && std::string(argv[1]) == "failover_child")
    return ScenarioExit(FailoverChild(argv[2], argv[3],
                                      argc == 5 ? argv[4] : "epoll"));
  if (argc == 7 && std::string(argv[1]) == "join_child")
    return ScenarioExit(
        JoinChild(argv[2], argv[3], argv[4], argv[5], argv[6]));
  if (argc == 2 && std::string(argv[1]) == "mpi_self")
    return ScenarioExit(MpiSelfScenario());
  if (argc == 2 && std::string(argv[1]) == "mpi_zoo")
    return ScenarioExit(MpiZooScenario());
  struct Case {
    const char* name;
    int (*fn)();
  };
  // array must run before the other C-API scenarios (it calls MV_Init).
  Case cases[] = {
      {"blob", TestBlob},         {"blob_borrow", TestBlobBorrow},
      {"arena", TestArena},       {"queue", TestQueue},
      {"configure", TestConfigure}, {"message", TestMessage},
      {"latency", TestLatencyTrail},
      {"audit", TestAudit},
      {"qos", TestQos},
      {"codec", TestCodec},
      {"dashboard", TestDashboard},
      {"updater", TestUpdater},   {"array", TestArray},
      {"matrix", TestMatrix},     {"bridge", TestBridge},
      {"sparse", TestSparseMatrix},
      {"checkpoint", TestCheckpoint},
      {"kv", TestKV},             {"threads", TestThreads},
      {"serve", TestServeVersions},
      {"workload", TestWorkload},
      {"capacity", TestCapacity},
      {"replica", TestReplica},
      {"repl", TestRepl},
      {"multiblob_add", TestMultiBlobAdd},
      {"watchdog", TestWatchdog},
  };
  int failures = 0;
  std::string only = argc > 1 ? argv[1] : "";
  for (const Case& c : cases) {
    if (!only.empty() && only != c.name) continue;
    int rc = c.fn();
    printf("%-12s %s\n", c.name, rc == 0 ? "OK" : "FAILED");
    failures += rc != 0;
  }
  MV_ShutDown();
  printf(failures ? "FAILURES: %d\n" : "ALL NATIVE TESTS PASSED\n", failures);
  return failures ? 1 : 0;
}
