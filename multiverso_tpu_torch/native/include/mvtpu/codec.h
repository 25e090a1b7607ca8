// Payload codecs for the native wire (docs/wire_compression.md).
//
// The reference parameter server ships every Add/Get payload as raw
// fp32 — 32 bits per element.  Its DMTK lineage made its name partly on
// 1-bit SGD gradient compression with error feedback (Seide et al.
// 2014); this module brings that wire format (plus a lossless sparse
// form) to the native transport:
//
// - kOneBit: sign bit per element + two per-message scales (mean of the
//   positive and of the negative bucket).  ~32x fewer payload bytes;
//   lossy per message, convergent under SGD because the WORKER keeps
//   the quantization error as a residual that re-enters the next add.
// - kSparse: (index, value) pairs of the nonzero elements — lossless,
//   used when it is actually smaller (the encoder falls back to kRaw
//   otherwise, so the per-MESSAGE codec stamp is authoritative).
//
// Encoding happens worker-side on the LAST blob of an Add request (the
// float delta; AddOption/row-id blobs stay raw); the server decodes
// before ProcessAdd, and Get replies may be sparse-encoded when the
// requester's accept flags allow it — so the table layer on both sides
// only ever sees raw float payloads.
#pragma once

#include <string>
#include <vector>

#include "mvtpu/blob.h"
#include "mvtpu/message.h"

namespace mvtpu {
namespace codec {

// raw | 1bit | sparse.  Unknown names map to kRaw (callers validate
// with IsCodecName first — the C API returns -1 on an unknown name).
Codec FromName(const std::string& name);
bool IsCodecName(const std::string& name);
const char* Name(Codec c);
// The msgflag:: accept bit advertising this codec (kAcceptRaw for kRaw).
int32_t AcceptFlag(Codec c);

// 1-bit encode of n floats.  Layout:
//   [int64 n][float pos_scale][float neg_scale][uint8 bits[(n+7)/8]]
// bit i (LSB-first within each byte) set means element i decodes to
// pos_scale, clear to neg_scale.  `residual` (may be null) is the
// caller's error-feedback buffer for these n elements: it is ADDED to
// the delta before quantization and overwritten with what the
// reconstruction lost — the sender must feed the same buffer to the
// next encode of the same elements or 1-bit SGD diverges.  Non-finite
// inputs are treated as 0 and their residual is reset to 0 (a NaN must
// not poison the scales or ride the feedback loop forever).
Blob EncodeOneBit(const float* delta, size_t n, float* residual);
bool DecodeOneBit(const Blob& in, std::vector<float>* out);

// Sparse encode of n floats.  Layout:
//   [int64 n][int64 k][int32 idx[k]][float val[k]]
// Lossless for every stored element (values copied bit-exact, so
// NaN/Inf survive); exact zeros are dropped (-0.0 decodes as +0.0).
// Returns an EMPTY blob when the sparse form would not be smaller than
// raw — the caller then ships kRaw.
Blob EncodeSparse(const float* delta, size_t n);
bool DecodeSparse(const Blob& in, std::vector<float>* out);

// Decode msg->data.back() in place per msg->codec (no-op for kRaw);
// resets the stamp to kRaw on success.  False on a malformed payload —
// the caller must drop the message rather than feed garbage to a table.
bool DecodeInPlace(Message* msg);

// Server-side reply hook: when the requester accepts kSparse and the
// reply's single payload blob is mostly zeros, swap it for the sparse
// form and stamp reply->codec.  No-op (and no scan) when the accept
// flags carry only kAcceptRaw — raw-codec tables pay nothing.
void MaybeEncodeReply(Message* reply, int32_t accept_flags);

}  // namespace codec
}  // namespace mvtpu
