// Skip-gram negative-sampling loss and gradients for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves word2vec's SGNS gradient
// to XLA (multiverso_tpu/apps/word2vec.py, jax.value_and_grad), and the
// port's first step took it from plain autograd over a float32 bmm, whose
// forward ran as a cuBLAS FFMA GEMM of [5, 300] x [300, 1] products, its
// backward as two gemvs, and a cat joined the context and negative
// gradients for the row scatter.  This kernel computes the same function
// in one pass and writes the gradients in the layout the scatter reads.
//
// Function (multiverso_tpu_torch/ops/sgns.py, sgns_plain): for pair i of
// B, with centre row vc[i], context row uo = out_emb[i] and negatives
// un_k = out_emb[B + i*K + k],
//   pos = vc.uo, neg_k = vc.un_k,
//   loss = -(sum_i logsigmoid(pos) + sum_{i,k} logsigmoid(-neg_k)) / B,
//   g_pos = -sigmoid(-pos)/B, g_k = sigmoid(neg_k)/B,
//   dvc[i] = g_pos*uo + sum_k g_k*un_k,
//   dout[i] = g_pos*vc, dout[B + i*K + k] = g_k*vc.
//
// Bound on an H100: bytes.  A pair reads 2 + K rows and writes 2 + K rows
// of D floats for 2·(1 + K)·D multiply-adds a side, under one flop a byte,
// so at [131,072 pairs, D 300, K 5] the least traffic is 2.2 GB, 0.657 ms
// at 3.35 TB/s, against 0.24 G multiply-adds.  The design moves each of
// those bytes once and nothing else:
// * one warp a pair, 8 pairs a block, many blocks on every SM, so the
//   loads of many pairs are in flight at once;
// * a lane holds N chunks of V floats of a row (V 4, 16-byte accesses,
//   where D % 4 == 0 and every pointer is 16-byte aligned; V 1 otherwise);
//   N is the least that covers D, chosen at launch, so the centre row, the
//   dvc sum and two streamed rows live in registers and nothing passes
//   through shared memory;
// * the negatives stream through the warp one row at a time, the next
//   row's loads issued before the current row's dot product is reduced
//   (butterfly shuffles, so every lane holds the sum), and each gradient
//   row is written as soon as its coefficient is known: a row is read once
//   and written once;
// * float32 throughout: FFMA, expf and log1pf in the stable logsigmoid
//   form min(x, 0) - log1p(exp(-|x|)), and sigmoid as sig_of forms it.
// The loss is summed per block in warp order into a partial per block,
// and the partials by a second launch in a fixed order, so it is the same
// from run to run.
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

// Return code for a row wider than the kernels were built for.
#define MVT_SGNS_TOO_WIDE (-1)
// Return code for a partials buffer shorter than the launch needs.
#define MVT_SGNS_SCRATCH_SHORT (-2)

namespace mvt {

constexpr int kWarps = 8;                 // pairs a block
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxChunks = 8;             // D <= 32·V·kMaxChunks
constexpr int kSumThreads = 1024;

// One chunk of V floats: a 16-byte access at V 4, a 4-byte one at V 1.
// Loads stream (evict first): every row is read once.
__device__ __forceinline__ void load_chunk(float (&x)[4], const float* p) {
  const float4 t = __ldcs(reinterpret_cast<const float4*>(p));
  x[0] = t.x;
  x[1] = t.y;
  x[2] = t.z;
  x[3] = t.w;
}
__device__ __forceinline__ void load_chunk(float (&x)[1], const float* p) {
  x[0] = __ldcs(p);
}
__device__ __forceinline__ void store_chunk(float* p, float a,
                                            const float (&x)[4]) {
  *reinterpret_cast<float4*>(p) =
      make_float4(a * x[0], a * x[1], a * x[2], a * x[3]);
}
__device__ __forceinline__ void store_chunk(float* p, float a,
                                            const float (&x)[1]) {
  *p = a * x[0];
}

// A lane's part of one row: chunk j holds the V floats from column
// (32·j + lane)·V; chunks past D hold zeros and are never stored.
template <int V, int N>
struct Row {
  float x[N][V];
};

template <int V, int N>
__device__ __forceinline__ void load_row(Row<V, N>& r, const float* row,
                                         int lane, int d) {
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const int col = (32 * j + lane) * V;
    if (col < d) {
      load_chunk(r.x[j], row + col);
    } else {
#pragma unroll
      for (int v = 0; v < V; ++v) r.x[j][v] = 0.f;
    }
  }
}

// row = a·r, the lane's chunks inside D.
template <int V, int N>
__device__ __forceinline__ void store_row(float* row, float a,
                                          const Row<V, N>& r, int lane,
                                          int d) {
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const int col = (32 * j + lane) * V;
    if (col < d) store_chunk(row + col, a, r.x[j]);
  }
}

// The dot product of two rows, summed across the warp: every lane gets it.
template <int V, int N>
__device__ __forceinline__ float warp_dot(const Row<V, N>& a,
                                          const Row<V, N>& b) {
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < N; ++j) {
#pragma unroll
    for (int v = 0; v < V; ++v) s = fmaf(a.x[j][v], b.x[j][v], s);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, off);
  }
  return s;
}

// acc += a·r
template <int V, int N>
__device__ __forceinline__ void axpy(Row<V, N>& acc, float a,
                                     const Row<V, N>& r) {
#pragma unroll
  for (int j = 0; j < N; ++j) {
#pragma unroll
    for (int v = 0; v < V; ++v) acc.x[j][v] = fmaf(a, r.x[j][v], acc.x[j][v]);
  }
}

// logsigmoid(-t) and sigmoid(t), both from one exp(-|t|).  sigmoid(t)
// is q = z / (1 + z) below 0.5 and 1 - q above it, as autograd's
// logsigmoid backward forms it.  Near t = 0, where word2vec's scores
// start, 1 / (1 + z) lands on the midpoints of the grid above 0.5 and
// always rounds up, +7e-9 of itself on average; this form comes out
// unbiased there, and stays accurate in both tails.
struct Sig {
  float log_sig_neg;
  float sig;
};
__device__ __forceinline__ Sig sig_of(float t) {
  const float z = expf(-fabsf(t));
  const float q = z / (1.f + z);
  Sig s;
  s.log_sig_neg = fminf(-t, 0.f) - log1pf(z);
  s.sig = t > 0.f ? 1.f - q : q;
  return s;
}

template <int V, int N>
__global__ void __launch_bounds__(kThreads)
    sgns_pairs(const float* __restrict__ vc, const float* __restrict__ out_emb,
               float* __restrict__ dvc, float* __restrict__ dout,
               float* __restrict__ partial, int b, int k, int d,
               float inv_b) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
  float pair_sum = 0.f;  // logsigmoid(pos) + sum_k logsigmoid(-neg_k)
  if (i < b) {
    const int64_t neg0 = static_cast<int64_t>(b) + i * k;  // first negative
    Row<V, N> c, cur, nxt, g;
    load_row(c, vc + i * d, lane, d);
    load_row(cur, out_emb + i * d, lane, d);
    if (k > 0) load_row(nxt, out_emb + neg0 * d, lane, d);

    Sig s = sig_of(-warp_dot(c, cur));
    pair_sum = s.log_sig_neg;
    const float g_pos = -inv_b * s.sig;
#pragma unroll
    for (int j = 0; j < N; ++j) {
#pragma unroll
      for (int v = 0; v < V; ++v) g.x[j][v] = g_pos * cur.x[j][v];
    }
    store_row(dout + i * d, g_pos, c, lane, d);

    for (int n = 0; n < k; ++n) {
      cur = nxt;
      if (n + 1 < k) load_row(nxt, out_emb + (neg0 + n + 1) * d, lane, d);
      s = sig_of(warp_dot(c, cur));
      pair_sum += s.log_sig_neg;
      const float g_neg = inv_b * s.sig;
      axpy(g, g_neg, cur);
      store_row(dout + (neg0 + n) * d, g_neg, c, lane, d);
    }
    store_row(dvc + i * d, 1.f, g, lane, d);
  }
  __shared__ float per_warp[kWarps];
  if (lane == 0) per_warp[warp] = pair_sum;
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) t += per_warp[w];
    partial[blockIdx.x] = t;
  }
}

// loss = -(sum of the partials) / b, summed in a fixed order.
__global__ void __launch_bounds__(kSumThreads)
    sgns_loss_sum(const float* __restrict__ partial, int n, int b,
                  float* __restrict__ loss) {
  __shared__ float s[kSumThreads];
  float t = 0.f;
  for (int j = threadIdx.x; j < n; j += kSumThreads) t += partial[j];
  s[threadIdx.x] = t;
  __syncthreads();
  for (int w = kSumThreads / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) s[threadIdx.x] += s[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) *loss = -(s[0] / static_cast<float>(b));
}

inline int blocks_for(int b) { return (b + kWarps - 1) / kWarps; }

template <int V, int N>
cudaError_t launch(const float* vc, const float* out_emb, float* dvc,
                   float* dout, float* partial, float* loss, int b, int k,
                   int d, cudaStream_t s) {
  const int blocks = blocks_for(b);
  sgns_pairs<V, N><<<blocks, kThreads, 0, s>>>(vc, out_emb, dvc, dout,
                                                partial, b, k, d,
                                                1.f / static_cast<float>(b));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  sgns_loss_sum<<<1, kSumThreads, 0, s>>>(partial, blocks, b, loss);
  return cudaGetLastError();
}

template <int V>
cudaError_t launch_for_chunks(int n, const float* vc, const float* out_emb,
                              float* dvc, float* dout, float* partial,
                              float* loss, int b, int k, int d,
                              cudaStream_t s) {
  switch (n) {
    case 1: return launch<V, 1>(vc, out_emb, dvc, dout, partial, loss, b, k, d, s);
    case 2: return launch<V, 2>(vc, out_emb, dvc, dout, partial, loss, b, k, d, s);
    case 3: return launch<V, 3>(vc, out_emb, dvc, dout, partial, loss, b, k, d, s);
    case 4: return launch<V, 4>(vc, out_emb, dvc, dout, partial, loss, b, k, d, s);
    case 5: return launch<V, 5>(vc, out_emb, dvc, dout, partial, loss, b, k, d, s);
    case 6: return launch<V, 6>(vc, out_emb, dvc, dout, partial, loss, b, k, d, s);
    case 7: return launch<V, 7>(vc, out_emb, dvc, dout, partial, loss, b, k, d, s);
    default: return launch<V, 8>(vc, out_emb, dvc, dout, partial, loss, b, k, d, s);
  }
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace mvt

extern "C" const char* mvt_error_string(int code) {
  if (code == MVT_SGNS_TOO_WIDE) {
    return "row too wide: the SGNS kernel takes D up to 1024 where D % 4 "
           "== 0 and the rows are 16-byte aligned, else up to 256";
  }
  if (code == MVT_SGNS_SCRATCH_SHORT) {
    return "SGNS launch given fewer partials than it has blocks";
  }
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The number of per-block loss partials a launch over b pairs writes.
extern "C" int mvt_sgns_partials(int b) { return mvt::blocks_for(b); }

// vc: [b, d] float32; out_emb: [b·(1 + k), d] float32, contexts first,
// then pair i's k negatives at rows b + i·k ...; dvc and dout the same
// shapes; partial: partial_n floats of scratch (mvt_sgns_partials(b));
// loss: one float.  Every tensor contiguous, b >= 1.
extern "C" int mvt_sgns(const void* vc, const void* out_emb, void* dvc,
                        void* dout, void* partial, int partial_n, void* loss,
                        int b, int k, int d, void* stream) {
  using namespace mvt;
  if (partial_n < blocks_for(b)) return MVT_SGNS_SCRATCH_SHORT;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* x = static_cast<const float*>(vc);
  const float* u = static_cast<const float*>(out_emb);
  float* gx = static_cast<float*>(dvc);
  float* gu = static_cast<float*>(dout);
  float* p = static_cast<float*>(partial);
  float* l = static_cast<float*>(loss);
  const bool vec = d % 4 == 0 && aligned16(vc) && aligned16(out_emb) &&
                   aligned16(dvc) && aligned16(dout);
  const int per_lane = vec ? (d / 4 + 31) / 32 : (d + 31) / 32;
  if (per_lane > kMaxChunks) return MVT_SGNS_TOO_WIDE;
  cudaError_t err =
      vec ? launch_for_chunks<4>(per_lane, x, u, gx, gu, p, l, b, k, d, s)
          : launch_for_chunks<1>(per_lane, x, u, gx, gu, p, l, b, k, d, s);
  return static_cast<int>(err);
}
