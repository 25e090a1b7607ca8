// Wire conventions between worker stubs and server shards:
//   Array Get      req: no blobs                 reply: [float local-shard]
//   Array Add      req: [AddOption][float shard-slice]
//   Matrix GetAll  req: no blobs                 reply: [float row-block]
//   Matrix GetRows req: [int32 global ids]       reply: [float rows-packed]
//   Matrix AddAll  req: [AddOption][float row-block-slice]
//   Matrix AddRows req: [AddOption][int32 global ids][float rows-packed]
// The worker partitions every request across shard owners (ShardOf /
// OwnerOf are the partition contract) and reassembles replies by the
// reply's src rank.  msg_id >= 0 means the caller blocks until every
// contacted shard replied; msg_id < 0 is async.
#include "mvtpu/table.h"

#include <chrono>
#include <cmath>
#include <cstdlib>
#include <cstring>

#include "mvtpu/codec.h"
#include "mvtpu/configure.h"
#include "mvtpu/dashboard.h"
#include "mvtpu/latency.h"
#include "mvtpu/qos.h"
#include "mvtpu/log.h"
#include "mvtpu/ops.h"
#include "mvtpu/zoo.h"

namespace mvtpu {

// The capacity history ring's bucket arrays mirror the version-bucket
// map one to one (docs/observability.md "capacity plane").
static_assert(capacity::kLoadBuckets == ServerTable::kVersionBuckets,
              "capacity history buckets must match version buckets");

namespace {

// Flags may not be registered when tables are driven standalone.
int64_t TableFlagOr(const char* name, int64_t dflt) {
  return configure::Has(name) ? configure::GetInt(name) : dflt;
}

int64_t SteadyNowMs() {
  return std::chrono::duration_cast<std::chrono::milliseconds>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

}  // namespace

// ---------------- workload observability (docs/observability.md) -------

void ServerTable::NoteStaleness(int64_t request_version) {
  if (!workload::Armed() || request_version < 0) return;
  int64_t stale = version() - request_version;
  if (stale < 0) stale = 0;  // a racing reply can out-stamp us; clamp
  // Ride the µs-bucket Dashboard ladder at 1 unit = 1 version (the
  // serve.queue_depth trick): bucket i ≈ staleness 2^i, and the
  // bridged histogram reconstructs the distribution host-side.
  Dashboard::Record(
      "workload.staleness.t" + std::to_string(obs_table_id_),
      static_cast<double>(stale) * 1e-6);
}

void ServerTable::NoteAddHealth(const float* delta, size_t n) {
  if (!workload::Armed() || !delta || n == 0) return;
  double l2sq = 0.0, linf = 0.0;
  long long nans = 0, infs = 0;
  for (size_t i = 0; i < n; ++i) {
    float v = delta[i];
    if (std::isnan(v)) {
      ++nans;
      continue;
    }
    if (std::isinf(v)) {
      ++infs;
      continue;
    }
    double d = static_cast<double>(v);
    l2sq += d * d;
    if (std::fabs(d) > linf) linf = std::fabs(d);
  }
  {
    MutexLock lk(health_mu_);
    add_l2sq_ += l2sq;
    if (linf > add_linf_) add_linf_ = linf;
    nan_count_ += nans;
    inf_count_ += infs;
  }
  if (nans > 0) {
    Dashboard::Record("workload.nan.t" + std::to_string(obs_table_id_),
                      0.0);
    // First NaN per table trips the black box: a diverging update is a
    // failure whose post-mortem needs the recent event/span ring NOW,
    // not a silent shard poisoning discovered at eval time.
    if (!nan_triggered_.exchange(true))
      ops::BlackboxTrigger(
          "nan_update: table " + std::to_string(obs_table_id_) + " (" +
          std::to_string(nans) + " NaN element(s) in one add)");
  }
  if (infs > 0)
    Dashboard::Record("workload.inf.t" + std::to_string(obs_table_id_),
                      0.0);
}

ServerTable::LoadStats ServerTable::Load() const {
  LoadStats out;
  out.gets = total_gets_.load(std::memory_order_relaxed);
  out.adds = total_adds_.load(std::memory_order_relaxed);
  int64_t max_load = 0, sum = 0;
  for (int b = 0; b < kVersionBuckets; ++b) {
    int64_t load = bucket_gets_[b].load(std::memory_order_relaxed) +
                   bucket_adds_[b].load(std::memory_order_relaxed);
    sum += load;
    if (load > max_load) max_load = load;
  }
  out.bucket_load_max = max_load;
  out.bucket_load_mean =
      static_cast<double>(sum) / static_cast<double>(kVersionBuckets);
  out.skew_ratio = out.bucket_load_mean > 0
                       ? static_cast<double>(max_load) / out.bucket_load_mean
                       : 0.0;
  {
    MutexLock lk(health_mu_);
    out.add_l2 = std::sqrt(add_l2sq_);
    out.add_linf = add_linf_;
    out.nan_count = nan_count_;
    out.inf_count = inf_count_;
  }
  long long cnt = 0;
  double total = 0.0;
  if (Dashboard::Query(
          "workload.staleness.t" + std::to_string(obs_table_id_), &cnt,
          &total)) {
    out.staleness_count = cnt;
    // Recorded at 1e-6 per version (the µs ladder); undo the scale.
    out.staleness_mean = cnt ? total * 1e6 / static_cast<double>(cnt) : 0.0;
  }
  return out;
}

// ---------------------------------------------------------------- server

ArrayServerTable::ArrayServerTable(int64_t global_size, UpdaterType updater,
                                   int rank, int size)
    : range_(ShardOf(global_size, rank, size)),
      data_(static_cast<size_t>(range_.len()), 0.0f), updater_(updater) {
  if (NumSlots(updater_) > 0) slot0_.assign(data_.size(), 0.0f);
  RecomputeCapacity();
}

void ArrayServerTable::RecomputeCapacity() {
  // Arrays are whole-shard spans (whole-shard versioning, whole-shard
  // checksum): shard bytes only, no per-bucket attribution.
  MutexLock lk(mu_);
  ResetCapacity(
      static_cast<int64_t>((data_.size() + slot0_.size()) * sizeof(float)),
      static_cast<int64_t>(data_.size()));
}

void ArrayServerTable::ProcessGet(const Message& req, Message* reply) {
  Monitor mon("ArrayServer::ProcessGet");
  NoteGet(-1);                 // whole-array read: totals only
  NoteStaleness(req.version);  // requester stamped its last-seen version
  reply->version = version();  // serve-layer staleness stamp
  MutexLock lk(mu_);
  reply->data.emplace_back(data_.data(), data_.size() * sizeof(float));
}

void ArrayServerTable::ProcessAdd(const Message& req) {
  Monitor mon("ArrayServer::ProcessAdd");
  const AddOption* opt = req.data[0].As<AddOption>();
  const float* delta = req.data[1].As<float>();
  size_t n = req.data[1].count<float>();
  NoteAdd(-1);
  NoteAddHealth(delta, n);
  MutexLock lk(mu_);
  if (n != data_.size()) {
    Log::Error("ArrayServerTable: delta size %zu != %zu", n, data_.size());
    return;
  }
  ApplyUpdate(updater_, *opt, data_.data(),
              slot0_.empty() ? nullptr : slot0_.data(), delta, n);
  BumpVersion();  // whole-array add: every bucket advances
}

bool ArrayServerTable::Store(Stream* out) const {
  MutexLock lk(mu_);
  int64_t n = static_cast<int64_t>(data_.size());
  return out->Write(&n, sizeof(n)) == sizeof(n) &&
         out->Write(data_.data(), n * sizeof(float)) == n * sizeof(float) &&
         (slot0_.empty() ||
          out->Write(slot0_.data(), n * sizeof(float)) == n * sizeof(float));
}

bool ArrayServerTable::Load(Stream* in) {
  MutexLock lk(mu_);
  int64_t n = 0;
  if (in->Read(&n, sizeof(n)) != sizeof(n) ||
      n != static_cast<int64_t>(data_.size()))
    return false;
  if (in->Read(data_.data(), n * sizeof(float)) !=
      static_cast<size_t>(n) * sizeof(float))
    return false;
  if (!slot0_.empty() &&
      in->Read(slot0_.data(), n * sizeof(float)) !=
          static_cast<size_t>(n) * sizeof(float))
    return false;
  ResetCapacity(
      static_cast<int64_t>((data_.size() + slot0_.size()) * sizeof(float)),
      static_cast<int64_t>(data_.size()));
  return true;
}

std::vector<uint32_t> ArrayServerTable::BucketChecksums() const {
  // Arrays version whole-shard (BumpVersion(-1)), so one whole-shard
  // checksum is the matching granularity.
  MutexLock lk(mu_);
  return {audit::Crc32(data_.data(), data_.size() * sizeof(float))};
}

MatrixServerTable::MatrixServerTable(int64_t rows, int64_t cols,
                                     UpdaterType updater, int rank, int size)
    : global_rows_(rows), cols_(cols), range_(ShardOf(rows, rank, size)),
      data_(static_cast<size_t>(range_.len() * cols), 0.0f),
      updater_(updater) {
  if (NumSlots(updater_) > 0) slot0_.assign(data_.size(), 0.0f);
  RecomputeCapacity();
}

void MatrixServerTable::RecomputeCapacity() {
  // Dense row block: fixed bytes once constructed, attributed per
  // bucket on the SAME global-row->bucket map the version stamps and
  // CRC beacons use — a bucket's bytes are exactly what a bucket
  // migration would move (docs/observability.md "capacity plane").
  MutexLock lk(mu_);
  int64_t row_bytes =
      cols_ * static_cast<int64_t>(sizeof(float)) *
      (slot0_.empty() ? 1 : 2);
  ResetCapacity(range_.len() * row_bytes, range_.len());
  for (int64_t r = 0; r < range_.len(); ++r)
    ChargeBucketBytes(RowBucket(range_.begin + r), row_bytes);
}

void MatrixServerTable::ProcessGet(const Message& req, Message* reply) {
  Monitor mon("MatrixServer::ProcessGet");
  NoteGet(-1);  // totals; per-row bucket loads charge via NoteKey below
  NoteStaleness(req.version);
  MutexLock lk(mu_);
  if (req.data.empty()) {  // GetAll: reply with the local row block
    reply->version = version();
    reply->data.emplace_back(data_.data(), data_.size() * sizeof(float));
    return;
  }
  const int32_t* ids = req.data[0].As<int32_t>();
  size_t k = req.data[0].count<int32_t>();
  // Bucket-granular stamp: the max version over the TOUCHED row
  // buckets — adds to other rows don't invalidate this read's cache.
  int64_t stamp = 0;
  for (size_t i = 0; i < k; ++i)
    if (ids[i] >= 0)
      stamp = std::max(stamp, bucket_version(RowBucket(ids[i])));
  reply->version = stamp;
  if (workload::Armed())
    for (size_t i = 0; i < k; ++i)
      if (ids[i] >= 0 && ids[i] < global_rows_)
        NoteKey(workload::KeyHash(static_cast<int64_t>(ids[i])),
                std::to_string(ids[i]), RowBucket(ids[i]),
                /*is_add=*/false);
  Blob out(k * cols_ * sizeof(float));
  float* dst = out.As<float>();
  for (size_t i = 0; i < k; ++i) {
    int64_t r = ids[i] - range_.begin;  // global -> local row
    if (ids[i] < 0 || ids[i] >= global_rows_ || r < 0 || r >= range_.len()) {
      // out-of-range / mis-routed rows read as zeros
      std::memset(dst + i * cols_, 0, cols_ * sizeof(float));
      continue;
    }
    std::memcpy(dst + i * cols_, data_.data() + r * cols_,
                cols_ * sizeof(float));
  }
  reply->data.push_back(std::move(out));
}

namespace {

// AddRows delta rows may arrive split across SEVERAL blobs (the
// borrowed multi-shard path ships each contiguous caller-order run as
// its own zero-copy iovec, docs/embedding.md); blob boundaries are
// row-aligned by the sender contract.  This cursor walks rows across
// the blob sequence [first, req.data.size()).
struct RowBlobCursor {
  const Message& req;
  size_t blob;
  size_t off = 0;  // floats consumed inside the current blob
  RowBlobCursor(const Message& r, size_t first) : req(r), blob(first) {}
  const float* Next(int64_t cols) {
    while (blob < req.data.size() &&
           off + static_cast<size_t>(cols) > req.data[blob].count<float>()) {
      blob += 1;
      off = 0;
    }
    if (blob >= req.data.size()) return nullptr;
    const float* p = req.data[blob].As<float>() + off;
    off += static_cast<size_t>(cols);
    return p;
  }
};

}  // namespace

void MatrixServerTable::ProcessAdd(const Message& req) {
  Monitor mon("MatrixServer::ProcessAdd");
  const AddOption* opt = req.data[0].As<AddOption>();
  NoteAdd(-1);
  // Update-health scan over EVERY delta blob (a multi-shard borrowed
  // AddRows splits the payload across run blobs — scanning only
  // data.back() would miss NaNs in the earlier runs).
  for (size_t b = req.data.size() == 2 ? 1 : 2; b < req.data.size(); ++b)
    NoteAddHealth(req.data[b].As<float>(), req.data[b].count<float>());
  if (workload::Armed() && req.data.size() >= 3) {
    const int32_t* note_ids = req.data[1].As<int32_t>();
    size_t note_k = req.data[1].count<int32_t>();
    for (size_t i = 0; i < note_k; ++i)
      if (note_ids[i] >= 0 && note_ids[i] < global_rows_)
        NoteKey(workload::KeyHash(static_cast<int64_t>(note_ids[i])),
                std::to_string(note_ids[i]), RowBucket(note_ids[i]),
                /*is_add=*/true);
  }
  MutexLock lk(mu_);
  float* slots = slot0_.empty() ? nullptr : slot0_.data();
  if (req.data.size() == 2) {  // AddAll: the local row-block slice
    const float* delta = req.data[1].As<float>();
    if (req.data[1].count<float>() != data_.size()) {
      Log::Error("MatrixServerTable: AddAll size mismatch");
      return;
    }
    ApplyUpdate(updater_, *opt, data_.data(), slots, delta, data_.size());
    BumpVersion();
    return;
  }
  const int32_t* ids = req.data[1].As<int32_t>();
  size_t k = req.data[1].count<int32_t>();
  size_t delta_floats = 0;
  for (size_t b = 2; b < req.data.size(); ++b)
    delta_floats += req.data[b].count<float>();
  if (delta_floats != k * static_cast<size_t>(cols_)) {
    Log::Error("MatrixServerTable: AddRows size mismatch");
    return;
  }
  RowBlobCursor cur(req, 2);
  if (!slots) {
    // Stateless add: sequential application composes like consecutive
    // reference Adds (duplicates sum).
    for (size_t i = 0; i < k; ++i) {
      const float* row = cur.Next(cols_);
      if (!row) break;
      int64_t r = ids[i] - range_.begin;
      if (ids[i] < 0 || ids[i] >= global_rows_ || r < 0 || r >= range_.len())
        continue;
      ApplyUpdate(updater_, *opt, data_.data() + r * cols_, nullptr, row,
                  static_cast<size_t>(cols_));
      BumpVersion(RowBucket(ids[i]));
    }
    return;
  }
  // Stateful updaters (adagrad/momentum/...): pre-aggregate duplicate row
  // ids so the math matches the JAX plane, which segment-sums duplicates
  // before one updater call per row (tables/matrix_table.py).
  std::unordered_map<int64_t, std::vector<float>> agg;
  for (size_t i = 0; i < k; ++i) {
    const float* row = cur.Next(cols_);
    if (!row) break;
    int64_t r = ids[i] - range_.begin;
    if (ids[i] < 0 || ids[i] >= global_rows_ || r < 0 || r >= range_.len())
      continue;
    auto& acc = agg[r];
    if (acc.empty()) acc.assign(static_cast<size_t>(cols_), 0.0f);
    for (int64_t c = 0; c < cols_; ++c) acc[c] += row[c];
  }
  for (auto& kv : agg) {
    ApplyUpdate(updater_, *opt, data_.data() + kv.first * cols_,
                slots + kv.first * cols_, kv.second.data(),
                static_cast<size_t>(cols_));
    BumpVersion(RowBucket(kv.first + range_.begin));  // global row bucket
  }
}

void MatrixServerTable::BuildReplica(Message* reply) {
  Monitor mon("MatrixServer::BuildReplica");
  NoteReplicaPush();
  // The SERVER chooses what to replicate: its SpaceSaving top-K row
  // ids (docs/embedding.md).  Tracker disarmed or cold => empty push
  // (still three blobs — the wire shape is fixed).
  auto top = HotTopK();
  std::vector<int32_t> ids;
  ids.reserve(top.size());
  for (const auto& item : top) {
    char* end = nullptr;
    long v = std::strtol(item.label.c_str(), &end, 10);
    if (!end || *end != '\0' || item.label.empty()) continue;
    if (v < range_.begin || v >= range_.end) continue;  // not my shard
    ids.push_back(static_cast<int32_t>(v));
  }
  Blob id_blob(ids.size() * sizeof(int32_t));
  Blob ver_blob(ids.size() * sizeof(int64_t));
  Blob row_blob(ids.size() * static_cast<size_t>(cols_) * sizeof(float));
  int32_t* id_p = id_blob.As<int32_t>();
  int64_t* ver_p = ver_blob.As<int64_t>();
  float* row_p = row_blob.As<float>();
  {
    // One lock over versions AND data: ProcessAdd bumps versions under
    // mu_ too, so a pushed row can never carry a version newer than its
    // bytes (the stamp may be conservative, never optimistic — the same
    // pre-fetch discipline the client caches follow).
    MutexLock lk(mu_);
    for (size_t i = 0; i < ids.size(); ++i) {
      id_p[i] = ids[i];
      ver_p[i] = bucket_version(RowBucket(ids[i]));
      std::memcpy(row_p + i * cols_,
                  data_.data() + (ids[i] - range_.begin) * cols_,
                  static_cast<size_t>(cols_) * sizeof(float));
    }
    reply->version = version();
  }
  reply->data.push_back(std::move(id_blob));
  reply->data.push_back(std::move(ver_blob));
  reply->data.push_back(std::move(row_blob));
  Dashboard::Record("replica.push", static_cast<double>(ids.size()));
}

bool MatrixServerTable::Store(Stream* out) const {
  MutexLock lk(mu_);
  int64_t hdr[2] = {range_.len(), cols_};
  size_t bytes = data_.size() * sizeof(float);
  return out->Write(hdr, sizeof(hdr)) == sizeof(hdr) &&
         out->Write(data_.data(), bytes) == bytes &&
         (slot0_.empty() || out->Write(slot0_.data(), bytes) == bytes);
}

bool MatrixServerTable::Load(Stream* in) {
  MutexLock lk(mu_);
  int64_t hdr[2];
  if (in->Read(hdr, sizeof(hdr)) != sizeof(hdr) || hdr[0] != range_.len() ||
      hdr[1] != cols_)
    return false;
  size_t bytes = data_.size() * sizeof(float);
  if (in->Read(data_.data(), bytes) != bytes) return false;
  if (!slot0_.empty() && in->Read(slot0_.data(), bytes) != bytes) return false;
  int64_t row_bytes =
      cols_ * static_cast<int64_t>(sizeof(float)) *
      (slot0_.empty() ? 1 : 2);
  ResetCapacity(range_.len() * row_bytes, range_.len());
  for (int64_t r = 0; r < range_.len(); ++r)
    ChargeBucketBytes(RowBucket(range_.begin + r), row_bytes);
  return true;
}

std::vector<uint32_t> MatrixServerTable::BucketChecksums() const {
  // Per-bucket beacons on the SAME row->bucket map the version stamps
  // use: each row's CRC is seeded with its GLOBAL row id (identical
  // rows in different slots must not cancel) and XORed into its
  // bucket, so the value is independent of iteration order and of how
  // rows are distributed across replicas of the same shard.
  std::vector<uint32_t> out(kVersionBuckets, 0);
  MutexLock lk(mu_);
  for (int64_t r = 0; r < range_.len(); ++r) {
    int64_t gid = range_.begin + r;
    uint32_t seed = audit::Crc32(&gid, sizeof(gid));
    uint32_t c = audit::Crc32(data_.data() + r * cols_,
                              static_cast<size_t>(cols_) * sizeof(float),
                              seed);
    out[RowBucket(gid)] ^= c;
  }
  return out;
}

// -------------------------------------------------------------------- KV

Blob PackKeys(const std::vector<std::string>& keys) {
  size_t bytes = 0;
  for (const auto& k : keys) bytes += sizeof(uint32_t) + k.size();
  Blob out(bytes);
  char* p = out.As<char>();
  for (const auto& k : keys) {
    uint32_t n = static_cast<uint32_t>(k.size());
    std::memcpy(p, &n, sizeof(n));
    p += sizeof(n);
    std::memcpy(p, k.data(), k.size());
    p += k.size();
  }
  return out;
}

std::vector<std::string> UnpackKeys(const Blob& b) {
  std::vector<std::string> keys;
  const char* p = b.As<char>();
  size_t left = b.size();
  while (left >= sizeof(uint32_t)) {
    uint32_t n;
    std::memcpy(&n, p, sizeof(n));
    p += sizeof(n);
    left -= sizeof(n);
    if (n > left) break;  // truncated frame: stop, don't overread
    keys.emplace_back(p, n);
    p += n;
    left -= n;
  }
  return keys;
}

void KVServerTable::ProcessGet(const Message& req, Message* reply) {
  Monitor mon("KVServer::ProcessGet");
  if (req.data.empty()) return;
  auto keys = UnpackKeys(req.data[0]);
  NoteGet(-1);
  NoteStaleness(req.version);
  Blob out(keys.size() * sizeof(float));
  float* vals = out.As<float>();
  // Bucket-granular stamp: max version over the touched key buckets.
  int64_t stamp = 0;
  for (const auto& k : keys) {
    uint64_t h = KVHash(k.data(), k.size());
    stamp = std::max(stamp, bucket_version(
        static_cast<int>(h % kVersionBuckets)));
    NoteKey(h, k, static_cast<int>(h % kVersionBuckets),
            /*is_add=*/false);
  }
  reply->version = stamp;
  MutexLock lk(mu_);
  for (size_t i = 0; i < keys.size(); ++i) {
    auto it = data_.find(keys[i]);
    vals[i] = it == data_.end() ? 0.0f : it->second;
  }
  reply->data.push_back(std::move(out));
}

void KVServerTable::ProcessAdd(const Message& req) {
  Monitor mon("KVServer::ProcessAdd");
  if (req.data.size() < 3) return;
  const AddOption* opt = req.data[0].As<AddOption>();
  auto keys = UnpackKeys(req.data[1]);
  const float* deltas = req.data[2].As<float>();
  if (req.data[2].count<float>() < keys.size()) {
    Log::Error("KVServerTable: %zu keys but %zu deltas", keys.size(),
               req.data[2].count<float>());
    return;
  }
  NoteAdd(-1);
  NoteAddHealth(deltas, keys.size());
  if (workload::Armed())
    for (const auto& k : keys) {
      uint64_t h = KVHash(k.data(), k.size());
      NoteKey(h, k, static_cast<int>(h % kVersionBuckets),
              /*is_add=*/true);
    }
  bool stateful = NumSlots(updater_) > 0;
  auto bump_key = [this](const std::string& k) {
    BumpVersion(static_cast<int64_t>(KVHash(k.data(), k.size()) %
                                     kVersionBuckets));
  };
  // Capacity accounting (docs/observability.md "capacity plane"): a
  // NEW key grows the shard — one relaxed Armed() load per insert,
  // charging key + value + entry-overhead bytes to the key's bucket
  // (slot entries charge the same shape; Recompute uses one formula).
  auto note_insert = [this](const std::string& k, int64_t rows) {
    NoteEntryBytes(
        static_cast<int>(KVHash(k.data(), k.size()) % kVersionBuckets),
        static_cast<int64_t>(k.size()) +
            static_cast<int64_t>(sizeof(float)) +
            capacity::kKVEntryOverhead,
        rows);
  };
  MutexLock lk(mu_);
  if (!stateful) {
    for (size_t i = 0; i < keys.size(); ++i) {
      auto ins = data_.try_emplace(keys[i], 0.0f);
      if (ins.second) note_insert(keys[i], 1);
      ApplyUpdate(updater_, *opt, &ins.first->second, nullptr, deltas + i,
                  1);
      bump_key(keys[i]);
    }
    return;
  }
  // Pre-aggregate duplicate keys so stateful updaters see one delta per
  // key (the same contract as the matrix row path / the JAX plane).
  std::unordered_map<std::string, float> agg;
  for (size_t i = 0; i < keys.size(); ++i) agg[keys[i]] += deltas[i];
  for (auto& kv : agg) {
    auto ins = data_.try_emplace(kv.first, 0.0f);
    if (ins.second) note_insert(kv.first, 1);
    auto slot = slot0_.try_emplace(kv.first, 0.0f);
    if (slot.second) note_insert(kv.first, 0);  // slot bytes, no new entry
    ApplyUpdate(updater_, *opt, &ins.first->second, &slot.first->second,
                &kv.second, 1);
    bump_key(kv.first);
  }
}

size_t KVServerTable::size() const {
  MutexLock lk(mu_);
  return data_.size();
}

void KVServerTable::RecomputeCapacity() {
  MutexLock lk(mu_);
  RecomputeCapacityLocked();
}

void KVServerTable::RecomputeCapacityLocked() {
  // Exact walk under the shard lock — the resync entry (re-arm, Load):
  // the SAME per-entry formula the incremental insert path charges, so
  // armed counters and a ground-truth walk agree by construction.
  int64_t bytes = 0;
  std::vector<int64_t> per_bucket(kVersionBuckets, 0);
  auto walk = [&](const std::unordered_map<std::string, float>& m) {
    for (const auto& kv : m) {
      int64_t b = static_cast<int64_t>(kv.first.size()) +
                  static_cast<int64_t>(sizeof(float)) +
                  capacity::kKVEntryOverhead;
      bytes += b;
      per_bucket[KVHash(kv.first.data(), kv.first.size()) %
                 kVersionBuckets] += b;
    }
  };
  walk(data_);
  walk(slot0_);
  ResetCapacity(bytes, static_cast<int64_t>(data_.size()));
  for (int b = 0; b < kVersionBuckets; ++b)
    ChargeBucketBytes(b, per_bucket[b]);
}

std::vector<uint32_t> KVServerTable::BucketChecksums() const {
  // Order-independent by construction: unordered_map iteration order
  // is load-factor dependent, so each entry's CRC (value seeded by the
  // key's CRC) XORs into its KVHash bucket — two shards holding the
  // same pairs agree bit for bit.
  std::vector<uint32_t> out(kVersionBuckets, 0);
  MutexLock lk(mu_);
  for (const auto& kv : data_) {
    uint32_t seed = audit::Crc32(kv.first.data(), kv.first.size());
    uint32_t c = audit::Crc32(&kv.second, sizeof(float), seed);
    out[KVHash(kv.first.data(), kv.first.size()) % kVersionBuckets] ^= c;
  }
  return out;
}

bool KVServerTable::Store(Stream* out) const {
  MutexLock lk(mu_);
  int64_t n = static_cast<int64_t>(data_.size());
  int8_t has_slots = slot0_.empty() ? 0 : 1;
  if (out->Write(&n, sizeof(n)) != sizeof(n) ||
      out->Write(&has_slots, 1) != 1)
    return false;
  for (const auto& kv : data_) {
    uint32_t len = static_cast<uint32_t>(kv.first.size());
    float slot = 0.0f;
    if (has_slots) {
      auto it = slot0_.find(kv.first);
      if (it != slot0_.end()) slot = it->second;
    }
    if (out->Write(&len, sizeof(len)) != sizeof(len) ||
        out->Write(kv.first.data(), len) != len ||
        out->Write(&kv.second, sizeof(float)) != sizeof(float) ||
        (has_slots &&
         out->Write(&slot, sizeof(float)) != sizeof(float)))
      return false;
  }
  return true;
}

bool KVServerTable::Load(Stream* in) {
  MutexLock lk(mu_);
  int64_t n = 0;
  int8_t has_slots = 0;
  if (in->Read(&n, sizeof(n)) != sizeof(n) ||
      in->Read(&has_slots, 1) != 1 || n < 0)
    return false;
  data_.clear();
  slot0_.clear();
  for (int64_t i = 0; i < n; ++i) {
    uint32_t len = 0;
    if (in->Read(&len, sizeof(len)) != sizeof(len)) return false;
    std::string key(len, '\0');
    float val = 0.0f, slot = 0.0f;
    if (in->Read(&key[0], len) != len ||
        in->Read(&val, sizeof(float)) != sizeof(float) ||
        (has_slots && in->Read(&slot, sizeof(float)) != sizeof(float)))
      return false;
    data_[key] = val;
    if (has_slots) slot0_[key] = slot;
  }
  RecomputeCapacityLocked();
  return true;
}

// ---------------------------------------------------------------- worker

// Per-thread busy latch: RoundTrip/Wait run on the CALLER's thread, so
// this distinguishes "server shed it (retryable, rc -6)" from "dead
// shard / deadline (indeterminate, rc -3)" without widening the bool
// return every table op and binding already speaks.
namespace {
thread_local bool g_rt_busy = false;

// Delivery audit (docs/observability.md "audit plane"): while FlushAdds
// ships a collapsed aggregation window, every message it creates covers
// this many logical adds — the seq RANGE the wire stamp carries, so the
// auditor can account each absorbed add through the one message that
// carried it.  Thread-local because the flush runs on the caller's
// thread and a concurrent plain add on another thread must keep span 1.
thread_local int64_t g_audit_flush_span = 0;

// Active host-bridge borrow window (docs/host_bridge.md) — thread-local
// because the *Borrowed C API runs table ops on the caller's thread and
// the window must never leak into unrelated ops on other threads.
struct BorrowWindow {
  const char* base = nullptr;
  size_t len = 0;
  std::shared_ptr<void> hold;
};
thread_local BorrowWindow g_borrow;
}  // namespace

bool WorkerTable::last_call_busy() { return g_rt_busy; }

BorrowScope::BorrowScope(const void* base, size_t len,
                         std::shared_ptr<void> hold) {
  g_borrow.base = static_cast<const char*>(base);
  g_borrow.len = len;
  g_borrow.hold = std::move(hold);
}

BorrowScope::~BorrowScope() {
  // Blobs minted inside the scope keep their own keepalive copies; only
  // the thread-local template dies here.
  g_borrow = BorrowWindow{};
}

Blob WrapPayload(const void* p, size_t bytes) {
  const char* cp = static_cast<const char*>(p);
  if (g_borrow.base != nullptr && cp >= g_borrow.base &&
      cp + bytes <= g_borrow.base + g_borrow.len) {
    return Blob::Borrow(p, bytes, g_borrow.hold);
  }
  return Blob(p, bytes);
}

namespace {
// True when the active borrow scope covers [p, p+bytes) — the gate the
// multi-shard borrowed AddRows uses to pick run-iovec shipping over
// per-rank staging (docs/embedding.md).
bool BorrowCovers(const void* p, size_t bytes) {
  const char* cp = static_cast<const char*>(p);
  return g_borrow.base != nullptr && cp >= g_borrow.base &&
         cp + bytes <= g_borrow.base + g_borrow.len;
}
}  // namespace

// ---- delivery audit (docs/observability.md "audit plane") ------------

void WorkerTable::StampAuditAdd(Message* req, int shard) {
  if (!audit::Armed()) return;
  int64_t span = g_audit_flush_span > 0 ? g_audit_flush_span : 1;
  int64_t lo = 0, hi = 0;
  ack_ledger_.NextRange(shard, span, &lo, &hi);
  req->flags |= msgflag::kHasAudit;
  req->audit.seq_lo = lo;
  req->audit.seq_hi = hi;
}

// ---- wire codec + add aggregation (docs/wire_compression.md) ---------

void WorkerTable::AppendEncodedDelta(Message* req, const float* delta,
                                     int64_t n, int64_t elem_offset,
                                     int64_t table_elems) {
  Codec c = wire_codec();
  size_t raw_bytes = static_cast<size_t>(n) * sizeof(float);
  if (c == Codec::kOneBit) {
    float* res;
    Blob enc;
    {
      MutexLock lk(residual_mu_);
      if (residual_.size() < static_cast<size_t>(table_elems))
        residual_.resize(static_cast<size_t>(table_elems), 0.0f);
      res = residual_.data() + elem_offset;
      enc = codec::EncodeOneBit(delta, static_cast<size_t>(n), res);
    }
    req->codec = Codec::kOneBit;
    req->data.push_back(std::move(enc));
  } else if (c == Codec::kSparse) {
    Blob enc = codec::EncodeSparse(delta, static_cast<size_t>(n));
    if (enc.size() == 0) {  // denser than the sparse form: ship raw
      req->data.push_back(WrapPayload(delta, raw_bytes));
    } else {
      req->codec = Codec::kSparse;
      req->data.push_back(std::move(enc));
    }
  } else {
    // Raw payloads borrow the caller's bytes when a host-bridge borrow
    // scope covers them (docs/host_bridge.md) — no copy into the blob.
    req->data.push_back(WrapPayload(delta, raw_bytes));
    return;  // raw tables keep the encode path at zero cost — no ratio
  }
  // Per-table compression ledger: mean of (encoded / raw payload bytes)
  // — `codec.ratio.t<id>` count = encoded messages, total/count = mean.
  if (raw_bytes > 0)
    Dashboard::Record("codec.ratio.t" + std::to_string(table_id_),
                      static_cast<double>(req->data.back().size()) /
                          static_cast<double>(raw_bytes));
}

bool WorkerTable::MaybeAggregate(const float* delta, int64_t n,
                                 const AddOption& opt) {
  int64_t agg_ms = TableFlagOr("add_agg_ms", 0);
  int64_t agg_bytes = TableFlagOr("add_agg_bytes", 0);
  if (agg_ms <= 0 && agg_bytes <= 0) return false;
  bool flush_incompatible = false;
  bool flush_now = false;
  {
    MutexLock lk(agg_mu_);
    if (agg_count_ > 0 &&
        (static_cast<int64_t>(agg_sum_.size()) != n ||
         std::memcmp(&agg_opt_, &opt, sizeof(opt)) != 0))
      flush_incompatible = true;
    else {
      if (agg_count_ == 0) {
        agg_sum_.assign(static_cast<size_t>(n), 0.0f);
        agg_opt_ = opt;
        agg_first_ms_ = SteadyNowMs();
      }
      for (int64_t i = 0; i < n; ++i) agg_sum_[i] += delta[i];
      ++agg_count_;
      Dashboard::Record("agg.adds", 0.0);
      // Bounds: absorbed payload bytes (count × delta size — the wire
      // traffic this window is collapsing) and the lazy time window.
      if (agg_bytes > 0 && agg_count_ * n * 4 >= agg_bytes)
        flush_now = true;
      if (agg_ms > 0 && SteadyNowMs() - agg_first_ms_ >= agg_ms)
        flush_now = true;
    }
  }
  if (flush_incompatible) {
    // Different shape/option: FIFO order demands the buffered aggregate
    // ships first; the new add then starts a fresh window.
    FlushAdds();
    return MaybeAggregate(delta, n, opt);
  }
  if (flush_now) FlushAdds();
  return true;
}

void WorkerTable::FlushAdds() {
  std::vector<float> sum;
  AddOption opt;
  int64_t adds;
  {
    MutexLock lk(agg_mu_);
    if (agg_count_ == 0) return;
    sum.swap(agg_sum_);
    opt = agg_opt_;
    adds = agg_count_;
    agg_count_ = 0;
  }
  // count = flush windows, total = adds collapsed: total/count is the
  // adds-per-wire-message ratio the bench/demo report.
  Dashboard::Record("agg.flush", static_cast<double>(adds));
  // Audit accounting: every message this flush creates covers the whole
  // collapsed window's seq range (docs/observability.md "audit plane").
  g_audit_flush_span = adds;
  SendAggregate(sum.data(), static_cast<int64_t>(sum.size()), opt);
  g_audit_flush_span = 0;
}

void WorkerTable::Notify(int64_t msg_id, const Message& reply) {
  // Latency attribution: fold the reply's timing trail into the
  // per-stage histograms + the peer clock-offset estimator BEFORE the
  // pending lookup — an expired round trip's reply still carries a
  // complete (and perfectly valid) stage breakdown.  The reply's trace
  // id is adopted for the scope so the stage buckets capture it as
  // their EXEMPLAR: a p99 stage links straight into the merged
  // Chrome trace that explains it.
  {
    int64_t prev_tid = Dashboard::ThreadTraceId();
    bool adopt = reply.trace_id != 0 && Dashboard::TraceEnabled();
    if (adopt) Dashboard::SetThreadTraceId(reply.trace_id);
    latency::OnReply(reply, reply.src);
    if (adopt) Dashboard::SetThreadTraceId(prev_tid);
  }
  // Delivery audit: a ReplyAdd echoing its request's stamp advances
  // the acked watermark for that shard's stream — recorded BEFORE the
  // pending lookup, because an ack landing after the round trip's
  // deadline still proves the server applied those seqs (the very
  // distinction between "never acked" and "lost" the auditor draws).
  if (reply.type == MsgType::ReplyAdd && reply.has_audit() &&
      audit::Armed()) {
    // Shard hint first (docs/replication.md): a promoted rank acks for
    // a shard its src rank never owned at registration time.
    int shard = reply.shard >= 0 ? reply.shard
                                 : Zoo::Get()->server_index(reply.src);
    if (shard >= 0) ack_ledger_.Ack(shard, reply.audit.seq_hi);
  }
  // Serve layer: every reply's version stamp refreshes the free local
  // lower bound on the server version (max-merge; replies can race).
  if (reply.version > 0) {
    int64_t cur = last_version_.load(std::memory_order_relaxed);
    while (cur < reply.version &&
           !last_version_.compare_exchange_weak(cur, reply.version)) {
    }
  }
  // Everything — lookup, consume, waiter notify — runs under mu_ so it
  // serializes with RoundTrip's timeout path: once the timeout erases
  // the entry, a late reply finds nothing and cannot touch the (gone)
  // stack waiter or the caller's output buffers.
  MutexLock lk(mu_);
  auto it = pending_.find(msg_id);
  if (it == pending_.end()) {
    Log::Error("WorkerTable %d: reply for unknown/expired msg %lld",
               table_id_, static_cast<long long>(msg_id));
    return;
  }
  Pending& p = it->second;
  if (reply.type == MsgType::ReplyError) {
    *p.failed = true;                   // shard unreachable — no payload
  } else if (reply.type == MsgType::ReplyBusy) {
    *p.failed = true;                   // shed — retryable, no payload
    if (p.busy) *p.busy = true;
  } else if (p.consume) {
    p.consume(p.arg, reply);
  }
  std::shared_ptr<Waiter> waiter = p.waiter;  // keep alive across erase
  if (--p.remaining == 0) pending_.erase(it);
  waiter->Notify();
}

bool WorkerTable::RoundTrip(std::vector<MessagePtr> reqs,
                            void (*consume)(void*, const Message&),
                            void* arg) {
  g_rt_busy = false;
  if (reqs.empty()) return true;
  auto waiter = std::make_shared<Waiter>(static_cast<int>(reqs.size()));
  bool failed = false;
  bool busy = false;
  int64_t msg_id = reqs[0]->msg_id;
  {
    MutexLock lk(mu_);
    pending_[msg_id] = Pending{waiter, consume, arg,
                               static_cast<int>(reqs.size()), &failed,
                               &busy};
  }
  for (auto& req : reqs)
    Zoo::Get()->SendTo(actor::kWorker, std::move(req));
  int64_t timeout_ms = configure::GetInt("rpc_timeout_ms");
  if (waiter->WaitFor(timeout_ms)) {
    MutexLock lk(mu_);
    g_rt_busy = busy;
    return !failed;
  }
  // Deadline passed: withdraw the pending entry so late replies are
  // dropped at the door instead of touching dead stack frames.
  //
  // CONTRACT: a timed-out result (rc -3 at the C API) is INDETERMINATE,
  // not at-most-once.  The server may still apply an Add whose ack was
  // merely slow — a caller that blindly retries can double-apply the
  // delta — and a timed-out Get leaves the caller's buffer partially
  // filled (some shards landed, some did not).  Callers must treat -3
  // as "state unknown": re-Get before deciding to re-Add.  (Documented
  // at MV_* in c_api.h as well.)
  MutexLock lk(mu_);
  auto it = pending_.find(msg_id);
  if (it == pending_.end()) {           // raced: replies completed
    g_rt_busy = busy;
    return !failed;
  }
  pending_.erase(it);
  Log::Error("WorkerTable %d: request %lld timed out after %lld ms",
             table_id_, static_cast<long long>(msg_id),
             static_cast<long long>(timeout_ms));
  return false;
}

AsyncGetPtr WorkerTable::StartRoundTrip(std::vector<MessagePtr> reqs,
                                        void (*consume)(void*,
                                                        const Message&),
                                        void* arg,
                                        std::shared_ptr<void> state) {
  int64_t msg_id = reqs.empty() ? -1 : reqs[0]->msg_id;
  AsyncGetPtr h(new AsyncGetHandle(this, msg_id,
                                   static_cast<int>(reqs.size()),
                                   std::move(state)));
  if (reqs.empty()) return h;
  {
    MutexLock lk(mu_);
    pending_[msg_id] = Pending{h->waiter_, consume, arg,
                               static_cast<int>(reqs.size()), &h->failed_,
                               &h->busy_};
  }
  for (auto& req : reqs)
    Zoo::Get()->SendTo(actor::kWorker, std::move(req));
  return h;
}

bool AsyncGetHandle::Wait() {
  if (waited_) return ok_;
  waited_ = true;
  g_rt_busy = false;
  if (msg_id_ < 0) {      // empty request: nothing was on the wire
    ok_ = true;
    return ok_;
  }
  // Identical deadline + withdrawal discipline as the blocking
  // RoundTrip, including the INDETERMINATE -3 contract on timeout.
  int64_t timeout_ms = configure::GetInt("rpc_timeout_ms");
  if (waiter_->WaitFor(timeout_ms)) {
    MutexLock lk(table_->mu_);
    g_rt_busy = busy_;
    ok_ = !failed_;
    return ok_;
  }
  MutexLock lk(table_->mu_);
  auto it = table_->pending_.find(msg_id_);
  if (it == table_->pending_.end()) {  // raced: replies completed
    g_rt_busy = busy_;
    ok_ = !failed_;
    return ok_;
  }
  table_->pending_.erase(it);
  Log::Error("WorkerTable %d: async get %lld timed out after %lld ms",
             table_->table_id_, static_cast<long long>(msg_id_),
             static_cast<long long>(timeout_ms));
  ok_ = false;
  return false;
}

AsyncGetHandle::~AsyncGetHandle() {
  if (waited_ || msg_id_ < 0) return;
  // Un-awaited handle: withdraw the pending entry so late replies are
  // dropped at the door instead of touching the dying waiter or the
  // caller's (possibly gone) output buffer.  Notify holds the same
  // lock for its whole lookup-consume-notify sequence, so after this
  // erase no reply can be mid-flight into our state.
  MutexLock lk(table_->mu_);
  table_->pending_.erase(msg_id_);
}

namespace {

MessagePtr MakeReq(MsgType type, int32_t table_id, int64_t msg_id,
                   int shard_idx,
                   int32_t accept_flags = msgflag::kAcceptRaw) {
  // Requests address SHARD indices; the wire needs the owning global
  // rank (they differ when worker-only/server-only roles exist).
  auto req = std::make_unique<Message>();
  req->type = type;
  req->table_id = table_id;
  req->msg_id = msg_id;
  // Reply-codec negotiation: the server may sparse-encode its reply
  // payload only when this request advertises kAcceptSparse.
  req->flags = accept_flags;
  // Span propagation: the enclosing op's Monitor set the thread trace id
  // (0 when tracing is off), and the server actor adopts it before the
  // apply — worker op and server apply share one id across ranks.
  req->trace_id = Dashboard::ThreadTraceId();
  req->src = Zoo::Get()->rank();
  // Routed through the VERSIONED shard map (docs/replication.md): a
  // promotion or join re-points the shard, so a retry minted after the
  // epoch flip lands on the live owner.  The shard hint rides the wire
  // because the owning rank no longer names the shard uniquely — a
  // promoted rank serves two — and replies echo it for reassembly.
  req->shard = shard_idx;
  req->dst = Zoo::Get()->server_rank(shard_idx);
  // Latency trail (docs/observability.md): the enqueue stamp opens the
  // client queue stage; the reply's trail closes the whole breakdown.
  latency::StampEnqueue(req.get());
  // Tail plane (docs/serving.md "tail"): tenant class + remaining
  // deadline budget ride the same header so the server can drop a
  // request whose caller already gave up.
  qos::StampRequest(req.get());
  return req;
}

// Assemble contiguous-shard replies into the caller's buffer: the reply's
// src rank names the shard, ShardOf names its offsets.
struct GatherDest {
  float* dst;
  size_t cap;        // caller buffer length (floats)
  int64_t global;    // partitioned length (array elems or matrix rows)
  int servers;
  int64_t stride;    // floats per partitioned element (1 or cols)
};

// Reassembly key for a reply: its echoed shard hint when present (a
// post-failover rank serves two shards, so src alone is ambiguous),
// falling back to the registration-time src→shard map for replies
// from pre-hint peers.
int ReplyShard(const Message& reply) {
  return reply.shard >= 0 ? reply.shard
                          : Zoo::Get()->server_index(reply.src);
}

void GatherReply(void* arg, const Message& reply) {
  auto* d = static_cast<GatherDest*>(arg);
  if (reply.data.empty()) return;
  int shard = ReplyShard(reply);
  if (shard < 0) return;  // reply from a rank that owns no shard
  ShardRange rg = ShardOf(d->global, shard, d->servers);
  size_t off = static_cast<size_t>(rg.begin * d->stride);
  size_t n = reply.data[0].count<float>();
  if (off >= d->cap) return;
  n = std::min(n, d->cap - off);
  std::memcpy(d->dst + off, reply.data[0].As<float>(), n * sizeof(float));
}

// Scatter row-subset replies: positions[src] lists, per contacted rank,
// the caller-order slots its rows fill (in request order).
struct RowsDest {
  float* dst;
  int64_t cols;
  const std::vector<std::vector<int64_t>>* positions;
};

void ScatterRowsReply(void* arg, const Message& reply) {
  auto* d = static_cast<RowsDest*>(arg);
  if (reply.data.empty()) return;
  int shard = ReplyShard(reply);
  if (shard < 0) return;
  const auto& pos = (*d->positions)[static_cast<size_t>(shard)];
  const float* src = reply.data[0].As<float>();
  size_t have = reply.data[0].count<float>() / d->cols;
  for (size_t i = 0; i < pos.size() && i < have; ++i) {
    std::memcpy(d->dst + pos[i] * d->cols, src + i * d->cols,
                d->cols * sizeof(float));
  }
}

void DiscardReply(void*, const Message&) {}

// QueryVersion's consume: max-merge every shard's reply stamp.
void MaxVersionReply(void* arg, const Message& reply) {
  auto* out = static_cast<int64_t*>(arg);
  if (reply.version > *out) *out = reply.version;
}

}  // namespace

bool WorkerTable::QueryVersion(int64_t* version, int bucket) {
  Monitor mon("Worker::QueryVersion");
  FlushAdds();  // the probed version must cover our buffered adds
  *version = 0;
  int64_t msg_id = Zoo::Get()->NextMsgId();
  int servers = Zoo::Get()->num_servers();
  std::vector<MessagePtr> reqs;
  for (int r = 0; r < servers; ++r) {
    auto req = MakeReq(MsgType::RequestVersion, table_id_, msg_id, r);
    req->version = bucket;  // -1 = whole table (see message.h)
    reqs.push_back(std::move(req));
  }
  return RoundTrip(std::move(reqs), MaxVersionReply, version);
}

bool ArrayWorkerTable::Get(float* data, int64_t size) {
  Monitor mon("ArrayWorker::Get");
  FlushAdds();  // read-your-aggregated-writes: flush rides ahead (FIFO)
  int64_t msg_id = Zoo::Get()->NextMsgId();
  std::vector<MessagePtr> reqs;
  for (int r = 0; r < servers_; ++r) {
    auto req = MakeReq(MsgType::RequestGet, table_id_, msg_id, r,
                       accept_flags());
    req->version = last_version();  // observed-staleness stamp
    reqs.push_back(std::move(req));
  }
  GatherDest d{data, static_cast<size_t>(size), global_, servers_, 1};
  return RoundTrip(std::move(reqs), GatherReply, &d);
}

AsyncGetPtr ArrayWorkerTable::GetAsync(float* data, int64_t size) {
  Monitor mon("ArrayWorker::GetAsync");
  FlushAdds();
  int64_t msg_id = Zoo::Get()->NextMsgId();
  std::vector<MessagePtr> reqs;
  for (int r = 0; r < servers_; ++r) {
    auto req = MakeReq(MsgType::RequestGet, table_id_, msg_id, r,
                       accept_flags());
    req->version = last_version();  // observed-staleness stamp
    reqs.push_back(std::move(req));
  }
  auto d = std::make_shared<GatherDest>();
  *d = GatherDest{data, static_cast<size_t>(size), global_, servers_, 1};
  GatherDest* raw = d.get();
  return StartRoundTrip(std::move(reqs), GatherReply, raw, std::move(d));
}

bool ArrayWorkerTable::SendAdd(const float* delta, int64_t size,
                               const AddOption& opt, bool blocking) {
  int64_t msg_id = blocking ? Zoo::Get()->NextMsgId() : -1;
  std::vector<MessagePtr> reqs;
  for (int r = 0; r < servers_; ++r) {
    ShardRange rg = ShardOf(global_, r, servers_);
    if (rg.begin >= size) continue;
    auto req = MakeReq(MsgType::RequestAdd, table_id_, msg_id, r);
    StampAuditAdd(req.get(), r);
    req->data.emplace_back(&opt, sizeof(opt));
    AppendEncodedDelta(req.get(), delta + rg.begin,
                       std::min(rg.len(), size - rg.begin), rg.begin,
                       global_);
    reqs.push_back(std::move(req));
  }
  if (blocking)
    return RoundTrip(std::move(reqs), DiscardReply, nullptr);
  for (auto& req : reqs)
    Zoo::Get()->SendTo(actor::kWorker, std::move(req));
  return true;
}

void ArrayWorkerTable::SendAggregate(const float* sum, int64_t n,
                                     const AddOption& opt) {
  SendAdd(sum, n, opt, /*blocking=*/false);
}

bool ArrayWorkerTable::Add(const float* delta, int64_t size,
                           const AddOption& opt, bool blocking) {
  Monitor mon("ArrayWorker::Add");
  if (blocking) {
    // The ack must cover everything this caller pushed — earlier
    // aggregated adds included (FIFO keeps them ahead on the wire).
    FlushAdds();
  } else if (size == global_ && MaybeAggregate(delta, size, opt)) {
    return true;  // absorbed; ships with the next flush window
  }
  return SendAdd(delta, size, opt, blocking);
}

bool MatrixWorkerTable::GetAll(float* data) {
  Monitor mon("MatrixWorker::GetAll");
  FlushAdds();
  int64_t msg_id = Zoo::Get()->NextMsgId();
  std::vector<MessagePtr> reqs;
  for (int r = 0; r < servers_; ++r) {
    auto req = MakeReq(MsgType::RequestGet, table_id_, msg_id, r,
                       accept_flags());
    req->version = last_version();  // observed-staleness stamp
    reqs.push_back(std::move(req));
  }
  GatherDest d{data, static_cast<size_t>(rows_ * cols_), rows_, servers_,
               cols_};
  return RoundTrip(std::move(reqs), GatherReply, &d);
}

std::vector<MessagePtr> MatrixWorkerTable::PlanRowsGet(
    const int32_t* row_ids, int64_t k, float* data,
    std::vector<std::vector<int64_t>>* positions) {
  // Partition ids by owner; remember which caller slots each owner fills.
  positions->assign(static_cast<size_t>(servers_), {});
  std::vector<std::vector<int32_t>> per_rank_ids(servers_);
  for (int64_t i = 0; i < k; ++i) {
    int owner = (row_ids[i] >= 0 && row_ids[i] < rows_)
                    ? OwnerOf(row_ids[i], rows_, servers_)
                    : 0;  // out-of-range: any shard answers zeros
    per_rank_ids[owner].push_back(row_ids[i]);
    (*positions)[owner].push_back(i);
  }
  std::memset(data, 0, static_cast<size_t>(k * cols_) * sizeof(float));
  FlushAdds();  // planned reads must see our buffered adds (FIFO)
  int64_t msg_id = Zoo::Get()->NextMsgId();
  std::vector<MessagePtr> reqs;
  for (int r = 0; r < servers_; ++r) {
    if (per_rank_ids[r].empty()) continue;
    auto req = MakeReq(MsgType::RequestGet, table_id_, msg_id, r,
                       accept_flags());
    req->version = last_version();  // observed-staleness stamp
    req->data.emplace_back(per_rank_ids[r].data(),
                           per_rank_ids[r].size() * sizeof(int32_t));
    reqs.push_back(std::move(req));
  }
  return reqs;
}

bool MatrixWorkerTable::FetchRowsWire(const int32_t* row_ids, int64_t k,
                                      float* data) {
  std::vector<std::vector<int64_t>> positions;
  auto reqs = PlanRowsGet(row_ids, k, data, &positions);
  RowsDest d{data, cols_, &positions};
  return RoundTrip(std::move(reqs), ScatterRowsReply, &d);
}

bool MatrixWorkerTable::GetRows(const int32_t* row_ids, int64_t k,
                                float* data) {
  Monitor mon("MatrixWorker::GetRows");
  if (!workload::ReplicaArmed() || k <= 0)
    return FetchRowsWire(row_ids, k, data);
  // Hot-key read replica (docs/embedding.md): serve what the servers'
  // pushed top-K covers, wire-fetch only the remainder.  FIFO parity
  // with the wire path: buffered aggregates flush first, so a replica
  // hit is never *less* fresh than the wire read it replaces.
  FlushAdds();
  MaybeRefreshReplica();
  std::vector<int32_t> rem;
  std::vector<int64_t> rem_slot;
  // Version gating IS the invalidation: our own add acks (and every
  // reply stamp) advance last_version, so at -replica_max_staleness=0
  // any entry older than the last observed apply misses.
  int64_t min_v = last_version() - TableFlagOr("replica_max_staleness", 0);
  {
    int64_t lease = TableFlagOr("replica_lease_ms", 50);
    MutexLock lk(replica_mu_);
    bool fresh = replica_ts_ms_ >= 0 &&
                 SteadyNowMs() - replica_ts_ms_ <= lease;
    for (int64_t i = 0; i < k; ++i) {
      if (fresh) {
        auto it = replica_.find(row_ids[i]);
        if (it != replica_.end() && it->second.version >= min_v) {
          std::memcpy(data + i * cols_, it->second.data.data(),
                      static_cast<size_t>(cols_) * sizeof(float));
          replica_hits_.fetch_add(1, std::memory_order_relaxed);
          continue;
        }
      }
      rem.push_back(row_ids[i]);
      rem_slot.push_back(i);
    }
  }
  replica_misses_.fetch_add(static_cast<long long>(rem.size()),
                            std::memory_order_relaxed);
  if (rem.empty()) {
    Dashboard::Record("replica.serve", 0.0);  // zero-wire row get
    return true;
  }
  if (rem.size() == static_cast<size_t>(k))
    return FetchRowsWire(row_ids, k, data);
  std::vector<float> buf(rem.size() * static_cast<size_t>(cols_));
  if (!FetchRowsWire(rem.data(), static_cast<int64_t>(rem.size()),
                     buf.data()))
    return false;
  for (size_t j = 0; j < rem.size(); ++j)
    std::memcpy(data + rem_slot[j] * cols_,
                buf.data() + j * cols_,
                static_cast<size_t>(cols_) * sizeof(float));
  return true;
}

namespace {
// RefreshReplica's consume trampoline (runs under WorkerTable::mu_ on
// the worker actor thread; OnReplicaPush takes replica_mu_ after it —
// the one fixed order those two locks are ever taken in).
void ConsumeReplica(void* arg, const Message& reply) {
  static_cast<MatrixWorkerTable*>(arg)->OnReplicaPush(reply);
}
}  // namespace

void MatrixWorkerTable::MaybeRefreshReplica() {
  int64_t lease = TableFlagOr("replica_lease_ms", 50);
  {
    MutexLock lk(replica_mu_);
    if (replica_ts_ms_ >= 0 && SteadyNowMs() - replica_ts_ms_ <= lease)
      return;
    // Stamp the ATTEMPT, not the success: a shedding/dead shard must
    // not turn every GetRows into a failed refresh round trip — the
    // lease paces attempts either way.
    replica_ts_ms_ = SteadyNowMs();
  }
  RefreshReplica();
}

bool MatrixWorkerTable::RefreshReplica() {
  Monitor mon("MatrixWorker::RefreshReplica");
  replica_refreshes_.fetch_add(1, std::memory_order_relaxed);
  int64_t msg_id = Zoo::Get()->NextMsgId();
  std::vector<MessagePtr> reqs;
  for (int r = 0; r < servers_; ++r) {
    auto req = MakeReq(MsgType::RequestReplica, table_id_, msg_id, r);
    req->version = last_version();  // observed-staleness stamp
    reqs.push_back(std::move(req));
  }
  return RoundTrip(std::move(reqs), ConsumeReplica, this);
}

void MatrixWorkerTable::OnReplicaPush(const Message& reply) {
  if (reply.data.size() < 3) return;
  const int32_t* ids = reply.data[0].As<int32_t>();
  size_t k = reply.data[0].count<int32_t>();
  const int64_t* vers = reply.data[1].As<int64_t>();
  const float* rows = reply.data[2].As<float>();
  if (reply.data[1].count<int64_t>() < k ||
      reply.data[2].count<float>() < k * static_cast<size_t>(cols_))
    return;  // malformed push: drop, never install torn rows
  // Bound the historical hot set: the map holds at most a few pushes'
  // worth of rows (per-shard top-K); a workload whose head drifts
  // re-fills from scratch instead of growing without bound (MV007's
  // discipline, native edition).
  int64_t topk = TableFlagOr("hotkey_topk", 16);
  size_t cap = static_cast<size_t>(4 * std::max<int64_t>(topk, 1) *
                                   std::max(servers_, 1));
  MutexLock lk(replica_mu_);
  if (replica_.size() > cap) replica_.clear();
  for (size_t i = 0; i < k; ++i) {
    ReplicaRow& r = replica_[ids[i]];
    // Install at the SNAPSHOT's table version (reply.version), not the
    // row's bucket version: the push copied data and version under one
    // server lock, so every pushed row is current AS OF that version —
    // gating on the (older) bucket stamp would mark a row stale the
    // moment any OTHER row was ever added after it, starving the
    // replica at staleness 0.  The per-row bucket stamps still ride
    // the wire (blob 1) for clients that track per-bucket knowledge.
    int64_t v = std::max(reply.version, vers[i]);
    if (r.version > v) continue;  // never roll a fresher entry back
    r.version = v;
    r.data.assign(rows + i * cols_, rows + (i + 1) * cols_);
  }
  replica_ts_ms_ = SteadyNowMs();
}

int64_t MatrixWorkerTable::replica_bytes() const {
  MutexLock lk(replica_mu_);
  // rows x (cols floats + id/version/map-node overhead): the same
  // entry-overhead constant the KV books use, so fleet capacity math
  // speaks one unit.
  return static_cast<int64_t>(replica_.size()) *
         (cols_ * static_cast<int64_t>(sizeof(float)) +
          capacity::kKVEntryOverhead);
}

MatrixWorkerTable::ReplicaStats MatrixWorkerTable::replica_stats() const {
  ReplicaStats s;
  s.hits = replica_hits_.load(std::memory_order_relaxed);
  s.misses = replica_misses_.load(std::memory_order_relaxed);
  s.refreshes = replica_refreshes_.load(std::memory_order_relaxed);
  MutexLock lk(replica_mu_);
  s.rows = static_cast<long long>(replica_.size());
  return s;
}

void MatrixWorkerTable::InvalidateReplicaRows(const int32_t* row_ids,
                                              int64_t k) {
  MutexLock lk(replica_mu_);
  if (replica_.empty()) return;
  if (k < 0) {  // whole-table add: every replicated row changed
    replica_.clear();
    return;
  }
  for (int64_t i = 0; i < k; ++i) replica_.erase(row_ids[i]);
}

void MatrixWorkerTable::OnClockInvalidate() {
  // Clock closed: peers' adds are applied server-side — every pushed
  // row may be stale regardless of its version stamp's lease.
  MutexLock lk(replica_mu_);
  replica_.clear();
  replica_ts_ms_ = -1;
}

namespace {
// The async GetRows' scatter plan must outlive the starting call (the
// blocking path keeps it on the stack); the handle owns one of these.
struct RowsGetState {
  RowsDest d;
  std::vector<std::vector<int64_t>> positions;
};
}  // namespace

AsyncGetPtr MatrixWorkerTable::GetRowsAsync(const int32_t* row_ids,
                                            int64_t k, float* data) {
  Monitor mon("MatrixWorker::GetRowsAsync");
  auto state = std::make_shared<RowsGetState>();
  auto reqs = PlanRowsGet(row_ids, k, data, &state->positions);
  state->d = RowsDest{data, cols_, &state->positions};
  RowsGetState* raw = state.get();
  return StartRoundTrip(std::move(reqs), ScatterRowsReply, &raw->d,
                        std::move(state));
}

bool MatrixWorkerTable::SendAddAll(const float* delta, const AddOption& opt,
                                   bool blocking) {
  InvalidateReplicaRows(nullptr, -1);  // whole-table add: replica void
  int64_t msg_id = blocking ? Zoo::Get()->NextMsgId() : -1;
  std::vector<MessagePtr> reqs;
  for (int r = 0; r < servers_; ++r) {
    ShardRange rg = ShardOf(rows_, r, servers_);
    if (rg.len() == 0) continue;
    auto req = MakeReq(MsgType::RequestAdd, table_id_, msg_id, r);
    StampAuditAdd(req.get(), r);
    req->data.emplace_back(&opt, sizeof(opt));
    AppendEncodedDelta(req.get(), delta + rg.begin * cols_,
                       rg.len() * cols_, rg.begin * cols_, rows_ * cols_);
    reqs.push_back(std::move(req));
  }
  if (blocking)
    return RoundTrip(std::move(reqs), DiscardReply, nullptr);
  for (auto& req : reqs)
    Zoo::Get()->SendTo(actor::kWorker, std::move(req));
  return true;
}

void MatrixWorkerTable::SendAggregate(const float* sum, int64_t n,
                                      const AddOption& opt) {
  if (n != rows_ * cols_) return;  // only whole-table adds aggregate
  SendAddAll(sum, opt, /*blocking=*/false);
}

bool MatrixWorkerTable::AddAll(const float* delta, const AddOption& opt,
                               bool blocking) {
  Monitor mon("MatrixWorker::AddAll");
  if (blocking)
    FlushAdds();  // the ack must cover buffered aggregates too
  else if (MaybeAggregate(delta, rows_ * cols_, opt)) {
    InvalidateReplicaRows(nullptr, -1);  // whole table changed
    return true;
  }
  return SendAddAll(delta, opt, blocking);
}

bool MatrixWorkerTable::AddRows(const int32_t* row_ids, int64_t k,
                                const float* delta, const AddOption& opt,
                                bool blocking) {
  Monitor mon("MatrixWorker::AddRows");
  // FIFO with any buffered whole-table aggregate: it ships first so the
  // server applies adds in submission order.
  FlushAdds();
  bool ok = SendAddRows(row_ids, k, delta, opt, blocking);
  // Replica invalidation is belt to the version gate's braces: the ack
  // that would stale the touched entries may still be in flight when a
  // concurrent read consults the replica.
  InvalidateReplicaRows(row_ids, k);
  return ok;
}

bool MatrixWorkerTable::SendAddRows(const int32_t* row_ids, int64_t k,
                                    const float* delta,
                                    const AddOption& opt, bool blocking) {
  // Single-shard fast path (the offload bridge's embedding case,
  // docs/host_bridge.md): with one server and only in-range ids there
  // is nothing to partition — ship the id list once and let the packed
  // delta borrow the caller's bytes (WrapPayload) instead of staging
  // per-rank copies.  The sparse codec keeps the staging path: its
  // encode owns a fresh blob anyway.
  if (servers_ == 1 && k > 0 && wire_codec() != Codec::kSparse) {
    bool all_valid = true;
    for (int64_t i = 0; i < k; ++i)
      if (row_ids[i] < 0 || row_ids[i] >= rows_) {
        all_valid = false;
        break;
      }
    if (all_valid) {
      int64_t msg_id = blocking ? Zoo::Get()->NextMsgId() : -1;
      auto req = MakeReq(MsgType::RequestAdd, table_id_, msg_id, 0);
      StampAuditAdd(req.get(), 0);
      req->data.emplace_back(&opt, sizeof(opt));
      req->data.emplace_back(row_ids, static_cast<size_t>(k) *
                                          sizeof(int32_t));
      req->data.push_back(WrapPayload(
          delta, static_cast<size_t>(k * cols_) * sizeof(float)));
      std::vector<MessagePtr> reqs;
      reqs.push_back(std::move(req));
      if (blocking)
        return RoundTrip(std::move(reqs), DiscardReply, nullptr);
      for (auto& r : reqs)
        Zoo::Get()->SendTo(actor::kWorker, std::move(r));
      return true;
    }
  }
  // Multi-shard borrowed fast path (docs/embedding.md — the gap the
  // single-shard path left open): when the packed delta sits inside
  // the active host-bridge borrow window (an arena buffer), every
  // shard's rows ship as borrowed iovecs straight out of that ONE
  // buffer — contiguous caller-order runs owned by the same shard
  // collapse into one Blob::Borrow each, and the server re-walks rows
  // across the blob sequence (RowBlobCursor).  No per-rank staging
  // copies, no send-side Blob copy.  The sparse codec keeps staging
  // (its encode owns a fresh blob anyway); a pathological interleaving
  // whose run count would blow the sendmsg iovec budget falls back.
  if (servers_ > 1 && k > 0 && wire_codec() != Codec::kSparse &&
      BorrowCovers(delta, static_cast<size_t>(k * cols_) * sizeof(float))) {
    bool all_valid = true;
    for (int64_t i = 0; i < k; ++i)
      if (row_ids[i] < 0 || row_ids[i] >= rows_) {
        all_valid = false;
        break;
      }
    if (all_valid) {
      // One pass: per-shard id lists + caller-order (first_idx, nrows)
      // runs.  A run extends while consecutive caller rows share an
      // owner — its bytes are contiguous in the caller's buffer by
      // construction (row i sits at delta + i*cols).
      constexpr size_t kMaxRunsPerShard = 256;  // sendmsg IOV budget
      std::vector<std::vector<int32_t>> ids(servers_);
      std::vector<std::vector<std::pair<int64_t, int64_t>>> runs(servers_);
      bool runs_ok = true;
      int prev_owner = -1;
      for (int64_t i = 0; i < k; ++i) {
        int owner = OwnerOf(row_ids[i], rows_, servers_);
        ids[owner].push_back(row_ids[i]);
        if (i > 0 && owner == prev_owner) {
          runs[owner].back().second += 1;
        } else {
          runs[owner].emplace_back(i, 1);
          if (runs[owner].size() > kMaxRunsPerShard) {
            runs_ok = false;
            break;
          }
        }
        prev_owner = owner;
      }
      if (runs_ok) {
        int64_t msg_id = blocking ? Zoo::Get()->NextMsgId() : -1;
        std::vector<MessagePtr> reqs;
        for (int r = 0; r < servers_; ++r) {
          if (ids[r].empty()) continue;
          auto req = MakeReq(MsgType::RequestAdd, table_id_, msg_id, r);
          StampAuditAdd(req.get(), r);
          req->data.emplace_back(&opt, sizeof(opt));
          req->data.emplace_back(ids[r].data(),
                                 ids[r].size() * sizeof(int32_t));
          for (const auto& run : runs[r])
            req->data.push_back(WrapPayload(
                delta + run.first * cols_,
                static_cast<size_t>(run.second * cols_) * sizeof(float)));
          reqs.push_back(std::move(req));
        }
        Dashboard::Record("addrows.borrowed", 0.0);
        if (blocking)
          return RoundTrip(std::move(reqs), DiscardReply, nullptr);
        for (auto& req : reqs)
          Zoo::Get()->SendTo(actor::kWorker, std::move(req));
        return true;
      }
    }
  }
  std::vector<std::vector<int32_t>> per_rank_ids(servers_);
  std::vector<std::vector<float>> per_rank_delta(servers_);
  for (int64_t i = 0; i < k; ++i) {
    if (row_ids[i] < 0 || row_ids[i] >= rows_) continue;  // dropped
    int owner = OwnerOf(row_ids[i], rows_, servers_);
    per_rank_ids[owner].push_back(row_ids[i]);
    per_rank_delta[owner].insert(per_rank_delta[owner].end(),
                                 delta + i * cols_,
                                 delta + (i + 1) * cols_);
  }
  int64_t msg_id = blocking ? Zoo::Get()->NextMsgId() : -1;
  std::vector<MessagePtr> reqs;
  for (int r = 0; r < servers_; ++r) {
    if (per_rank_ids[r].empty()) continue;
    auto req = MakeReq(MsgType::RequestAdd, table_id_, msg_id, r);
    StampAuditAdd(req.get(), r);
    req->data.emplace_back(&opt, sizeof(opt));
    req->data.emplace_back(per_rank_ids[r].data(),
                           per_rank_ids[r].size() * sizeof(int32_t));
    if (wire_codec() == Codec::kSparse) {
      // Row-subset adds take the lossless sparse codec only: the 1-bit
      // error-feedback residual is indexed by STABLE element offsets,
      // which a varying packed row set does not have.
      AppendEncodedDelta(req.get(), per_rank_delta[r].data(),
                         static_cast<int64_t>(per_rank_delta[r].size()),
                         0, 0);
    } else {
      req->data.emplace_back(per_rank_delta[r].data(),
                             per_rank_delta[r].size() * sizeof(float));
    }
    reqs.push_back(std::move(req));
  }
  if (reqs.empty()) return true;
  if (blocking)
    return RoundTrip(std::move(reqs), DiscardReply, nullptr);
  for (auto& req : reqs)
    Zoo::Get()->SendTo(actor::kWorker, std::move(req));
  return true;
}

// ------------------------------------------------- sparse matrix worker

bool SparseMatrixWorkerTable::GetRows(const int32_t* row_ids, int64_t k,
                                      float* data) {
  Monitor mon("SparseMatrixWorker::GetRows");
  // Plan under the lock, fetch OUTSIDE it: a wire round-trip (up to
  // rpc_timeout_ms when SSP parks the get) must not serialize other
  // readers or stall a barrier's OnClockInvalidate.
  std::vector<int32_t> missing;
  std::unordered_map<int32_t, size_t> fetch_slot;
  uint64_t epoch;
  {
    MutexLock lk(cache_mu_);
    if (valid_.empty()) {
      valid_.assign(static_cast<size_t>(rows_), 0);
      mirror_.assign(static_cast<size_t>(rows_ * cols_), 0.0f);
    }
    epoch = cache_epoch_;
    for (int64_t i = 0; i < k; ++i) {
      int32_t r = row_ids[i];
      if (r >= 0 && r < rows_ && !valid_[r] && !fetch_slot.count(r)) {
        fetch_slot[r] = missing.size();
        missing.push_back(r);
      }
    }
  }
  // Serve-layer observability: one counter tick per call — all-hit
  // calls skip the wire entirely (MV_CacheStats reads these).
  Dashboard::Record(missing.empty() ? "serve.cache.hit"
                                    : "serve.cache.miss", 0.0);
  std::vector<float> fetched(missing.size() * cols_);
  if (!missing.empty() &&
      !MatrixWorkerTable::GetRows(missing.data(),
                                  static_cast<int64_t>(missing.size()),
                                  fetched.data()))
    return false;

  MutexLock lk(cache_mu_);
  // Install only if no invalidation ran while the wire was in flight —
  // caching a pre-add value after the add's invalidation would serve
  // stale reads forever.  The fetched values themselves are still fine
  // to RETURN: a get that races a concurrent add may see either side.
  if (!missing.empty() && cache_epoch_ == epoch) {
    for (size_t i = 0; i < missing.size(); ++i) {
      std::memcpy(mirror_.data() + missing[i] * cols_,
                  fetched.data() + i * cols_, cols_ * sizeof(float));
      valid_[missing[i]] = 1;
    }
  }
  for (int64_t i = 0; i < k; ++i) {
    int32_t r = row_ids[i];
    auto it = fetch_slot.find(r);
    if (it != fetch_slot.end())
      std::memcpy(data + i * cols_, fetched.data() + it->second * cols_,
                  cols_ * sizeof(float));
    else if (r >= 0 && r < rows_)
      std::memcpy(data + i * cols_, mirror_.data() + r * cols_,
                  cols_ * sizeof(float));
    else
      std::memset(data + i * cols_, 0, cols_ * sizeof(float));
  }
  return true;
}

bool SparseMatrixWorkerTable::AddAll(const float* delta,
                                     const AddOption& opt, bool blocking) {
  // Invalidate AFTER the base add: doing it first opens a window where
  // a concurrent GetRows re-caches the pre-add value and a blocking
  // adder's own next read is stale.  Invalidate even on failure — a
  // deadline rc is indeterminate (the server may still apply it).
  bool ok = MatrixWorkerTable::AddAll(delta, opt, blocking);
  MutexLock lk(cache_mu_);
  ++cache_epoch_;
  if (!valid_.empty()) std::fill(valid_.begin(), valid_.end(), 0);
  return ok;
}

bool SparseMatrixWorkerTable::AddRows(const int32_t* row_ids, int64_t k,
                                      const float* delta,
                                      const AddOption& opt, bool blocking) {
  bool ok = MatrixWorkerTable::AddRows(row_ids, k, delta, opt, blocking);
  MutexLock lk(cache_mu_);
  ++cache_epoch_;
  if (!valid_.empty())
    for (int64_t i = 0; i < k; ++i)
      if (row_ids[i] >= 0 && row_ids[i] < rows_) valid_[row_ids[i]] = 0;
  return ok;
}

void SparseMatrixWorkerTable::OnClockInvalidate() {
  // Clock closed: peers' adds are now applied server-side — every
  // cached row may be stale.  The base clears the hot-key replica for
  // the same reason.
  MatrixWorkerTable::OnClockInvalidate();
  MutexLock lk(cache_mu_);
  ++cache_epoch_;
  if (!valid_.empty()) std::fill(valid_.begin(), valid_.end(), 0);
}

// -------------------------------------------------------------- KV worker

namespace {

// Scatter KV get replies: positions[shard] lists the caller-order slots
// that shard's reply values fill (request order within the shard).
struct KVDest {
  float* vals;
  const std::vector<std::vector<int64_t>>* positions;
};

void ScatterKVReply(void* arg, const Message& reply) {
  auto* d = static_cast<KVDest*>(arg);
  if (reply.data.empty()) return;
  int shard = ReplyShard(reply);
  if (shard < 0) return;
  const auto& pos = (*d->positions)[static_cast<size_t>(shard)];
  const float* src = reply.data[0].As<float>();
  size_t have = reply.data[0].count<float>();
  for (size_t i = 0; i < pos.size() && i < have; ++i)
    d->vals[pos[i]] = src[i];
}

}  // namespace

bool KVWorkerTable::Get(const std::vector<std::string>& keys, float* vals) {
  Monitor mon("KVWorker::Get");
  FlushAdds();
  std::vector<std::vector<std::string>> per_rank(servers_);
  std::vector<std::vector<int64_t>> positions(servers_);
  for (size_t i = 0; i < keys.size(); ++i) {
    int owner = static_cast<int>(
        KVHash(keys[i].data(), keys[i].size()) %
        static_cast<uint64_t>(servers_));
    per_rank[owner].push_back(keys[i]);
    positions[owner].push_back(static_cast<int64_t>(i));
  }
  std::memset(vals, 0, keys.size() * sizeof(float));
  int64_t msg_id = Zoo::Get()->NextMsgId();
  std::vector<MessagePtr> reqs;
  for (int r = 0; r < servers_; ++r) {
    if (per_rank[r].empty()) continue;
    auto req = MakeReq(MsgType::RequestGet, table_id_, msg_id, r,
                       accept_flags());
    req->version = last_version();  // observed-staleness stamp
    req->data.push_back(PackKeys(per_rank[r]));
    reqs.push_back(std::move(req));
  }
  KVDest d{vals, &positions};
  bool ok = reqs.empty() || RoundTrip(std::move(reqs), ScatterKVReply, &d);
  if (ok) {
    // Refresh the worker-side dict (the reference KVWorkerTable `raw`).
    MutexLock lk(cache_mu_);
    for (size_t i = 0; i < keys.size(); ++i) cache_[keys[i]] = vals[i];
  }
  return ok;
}

bool KVWorkerTable::Add(const std::vector<std::string>& keys,
                        const float* deltas, const AddOption& opt,
                        bool blocking) {
  Monitor mon("KVWorker::Add");
  std::vector<std::vector<std::string>> per_rank(servers_);
  std::vector<std::vector<float>> per_vals(servers_);
  for (size_t i = 0; i < keys.size(); ++i) {
    int owner = static_cast<int>(
        KVHash(keys[i].data(), keys[i].size()) %
        static_cast<uint64_t>(servers_));
    per_rank[owner].push_back(keys[i]);
    per_vals[owner].push_back(deltas[i]);
  }
  int64_t msg_id = blocking ? Zoo::Get()->NextMsgId() : -1;
  std::vector<MessagePtr> reqs;
  for (int r = 0; r < servers_; ++r) {
    if (per_rank[r].empty()) continue;
    auto req = MakeReq(MsgType::RequestAdd, table_id_, msg_id, r);
    StampAuditAdd(req.get(), r);
    req->data.emplace_back(&opt, sizeof(opt));
    req->data.push_back(PackKeys(per_rank[r]));
    req->data.emplace_back(per_vals[r].data(),
                           per_vals[r].size() * sizeof(float));
    reqs.push_back(std::move(req));
  }
  if (reqs.empty()) return true;
  if (blocking)
    return RoundTrip(std::move(reqs), DiscardReply, nullptr);
  for (auto& req : reqs)
    Zoo::Get()->SendTo(actor::kWorker, std::move(req));
  return true;
}

}  // namespace mvtpu
