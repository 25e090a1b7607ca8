#include "mvtpu/codec.h"

#include <cmath>
#include <cstring>

namespace mvtpu {
namespace codec {

namespace {

// Both encoded layouts open with the element count.
struct OneBitHeader {
  int64_t n;
  float pos_scale;
  float neg_scale;
};

struct SparseHeader {
  int64_t n;
  int64_t k;
};

}  // namespace

Codec FromName(const std::string& name) {
  if (name == "1bit") return Codec::kOneBit;
  if (name == "sparse") return Codec::kSparse;
  return Codec::kRaw;
}

bool IsCodecName(const std::string& name) {
  return name == "raw" || name == "1bit" || name == "sparse";
}

const char* Name(Codec c) {
  switch (c) {
    case Codec::kOneBit: return "1bit";
    case Codec::kSparse: return "sparse";
    case Codec::kRaw: default: return "raw";
  }
}

int32_t AcceptFlag(Codec c) {
  switch (c) {
    case Codec::kOneBit: return msgflag::kAccept1Bit;
    case Codec::kSparse: return msgflag::kAcceptSparse;
    case Codec::kRaw: default: return msgflag::kAcceptRaw;
  }
}

Blob EncodeOneBit(const float* delta, size_t n, float* residual) {
  // Pass 1: fold in the residual, sanitize non-finite, bucket means.
  std::vector<float> v(n);
  double pos_sum = 0.0, neg_sum = 0.0;
  size_t pos_cnt = 0, neg_cnt = 0;
  for (size_t i = 0; i < n; ++i) {
    float x = delta[i] + (residual ? residual[i] : 0.0f);
    if (!std::isfinite(x)) x = 0.0f;
    v[i] = x;
    if (x >= 0.0f) {
      pos_sum += x;
      ++pos_cnt;
    } else {
      neg_sum += x;
      ++neg_cnt;
    }
  }
  OneBitHeader h;
  h.n = static_cast<int64_t>(n);
  h.pos_scale = pos_cnt ? static_cast<float>(pos_sum / pos_cnt) : 0.0f;
  h.neg_scale = neg_cnt ? static_cast<float>(neg_sum / neg_cnt) : 0.0f;
  // Pass 2: pack sign bits (LSB-first), write back the residual.
  size_t nbytes = (n + 7) / 8;
  Blob out(sizeof(OneBitHeader) + nbytes);
  std::memcpy(out.data(), &h, sizeof(h));
  uint8_t* bits = reinterpret_cast<uint8_t*>(out.data()) + sizeof(h);
  std::memset(bits, 0, nbytes);
  for (size_t i = 0; i < n; ++i) {
    bool pos = v[i] >= 0.0f;
    if (pos) bits[i / 8] = static_cast<uint8_t>(bits[i / 8] | (1u << (i % 8)));
    if (residual) {
      float recon = pos ? h.pos_scale : h.neg_scale;
      // A sanitized non-finite element must not re-inject -recon next
      // round: its residual resets instead of carrying the correction.
      residual[i] = std::isfinite(delta[i]) ? v[i] - recon : 0.0f;
    }
  }
  return out;
}

bool DecodeOneBit(const Blob& in, std::vector<float>* out) {
  if (in.size() < sizeof(OneBitHeader)) return false;
  OneBitHeader h;
  std::memcpy(&h, in.data(), sizeof(h));
  if (h.n < 0) return false;
  size_t n = static_cast<size_t>(h.n);
  if (in.size() != sizeof(OneBitHeader) + (n + 7) / 8) return false;
  const uint8_t* bits =
      reinterpret_cast<const uint8_t*>(in.data()) + sizeof(h);
  out->resize(n);
  for (size_t i = 0; i < n; ++i)
    (*out)[i] = (bits[i / 8] >> (i % 8)) & 1 ? h.pos_scale : h.neg_scale;
  return true;
}

Blob EncodeSparse(const float* delta, size_t n) {
  size_t k = 0;
  for (size_t i = 0; i < n; ++i)
    if (delta[i] != 0.0f) ++k;
  size_t enc = sizeof(SparseHeader) + k * (sizeof(int32_t) + sizeof(float));
  if (enc >= n * sizeof(float)) return Blob();  // not smaller: ship raw
  SparseHeader h{static_cast<int64_t>(n), static_cast<int64_t>(k)};
  Blob out(enc);
  char* p = out.data();
  std::memcpy(p, &h, sizeof(h));
  p += sizeof(h);
  int32_t* idx = reinterpret_cast<int32_t*>(p);
  float* val = reinterpret_cast<float*>(p + k * sizeof(int32_t));
  size_t j = 0;
  for (size_t i = 0; i < n; ++i) {
    if (delta[i] == 0.0f) continue;
    idx[j] = static_cast<int32_t>(i);
    val[j] = delta[i];  // bit-exact: NaN/Inf survive the round trip
    ++j;
  }
  return out;
}

bool DecodeSparse(const Blob& in, std::vector<float>* out) {
  if (in.size() < sizeof(SparseHeader)) return false;
  SparseHeader h;
  std::memcpy(&h, in.data(), sizeof(h));
  if (h.n < 0 || h.k < 0 || h.k > h.n) return false;
  size_t n = static_cast<size_t>(h.n), k = static_cast<size_t>(h.k);
  if (in.size() != sizeof(SparseHeader) + k * 8) return false;
  const char* p = in.data() + sizeof(h);
  const int32_t* idx = reinterpret_cast<const int32_t*>(p);
  const float* val =
      reinterpret_cast<const float*>(p + k * sizeof(int32_t));
  out->assign(n, 0.0f);
  for (size_t j = 0; j < k; ++j) {
    if (idx[j] < 0 || static_cast<size_t>(idx[j]) >= n) return false;
    (*out)[static_cast<size_t>(idx[j])] = val[j];
  }
  return true;
}

bool DecodeInPlace(Message* msg) {
  if (msg->codec == Codec::kRaw) return true;
  if (msg->data.empty()) return false;
  std::vector<float> out;
  bool ok = msg->codec == Codec::kOneBit
                ? DecodeOneBit(msg->data.back(), &out)
                : msg->codec == Codec::kSparse
                      ? DecodeSparse(msg->data.back(), &out)
                      : false;
  if (!ok) return false;
  msg->data.back() = Blob(out.data(), out.size() * sizeof(float));
  msg->codec = Codec::kRaw;
  return true;
}

void MaybeEncodeReply(Message* reply, int32_t accept_flags) {
  if (!(accept_flags & msgflag::kAcceptSparse)) return;
  if (reply->data.size() != 1 || reply->codec != Codec::kRaw) return;
  const Blob& raw = reply->data[0];
  size_t n = raw.count<float>();
  if (n == 0 || raw.size() != n * sizeof(float)) return;
  Blob enc = EncodeSparse(raw.As<float>(), n);
  if (enc.size() == 0) return;  // dense payload: raw is already smaller
  reply->data[0] = std::move(enc);
  reply->codec = Codec::kSparse;
}

}  // namespace codec
}  // namespace mvtpu
