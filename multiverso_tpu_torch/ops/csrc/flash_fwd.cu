// Flash-attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_fwd_kernel`
// (multiverso_tpu/ops/flash_attention.py:83-135, launched by `_fwd_impl`
// through pl.pallas_call at :248).  For one (bh, 64-row q block) it walks
// the k blocks with an online softmax — running max m, running sum l and
// a float32 output accumulator — and writes o = acc / max(l, 1e-30) and
// lse = m + log(max(l, 1e-30)).  Where the TPU grid carried m, l and acc
// in VMEM scratch across sequential grid steps, here one thread block
// loops over the k blocks itself.
//
// Causal schedule, as the TPU kernel: blocks above the diagonal are never
// visited, blocks fully below it run unmasked, and only blocks that
// straddle it (or the ragged ends of T) pay for the mask.
//
// Bound on an H100: at head_dim 128 and T 2048 the work is about 64
// flops per byte moved, far below the ~295 the card needs to be limited
// by memory, so the bound is the tensor-core rate; this first kernel
// reaches only a fraction of it (operands re-read from shared memory per
// WMMA fragment, accumulator round trips through shared memory).
#include "flash_common.cuh"

namespace mvt {

template <typename T, int D, int BQ, int BK>
struct FwdSmem {
  static constexpr int kLdT = Ld<T, D>::value;       // q, k, v tiles
  static constexpr int kLdS = Ld<float, BK>::value;  // scores
  static constexpr int kLdP = Ld<T, BK>::value;      // probabilities
  static constexpr int kLdO = Ld<float, D>::value;   // accumulator
  static constexpr size_t q = 0;
  static constexpr size_t k = q + align128(sizeof(T) * BQ * kLdT);
  static constexpr size_t v = k + align128(sizeof(T) * BK * kLdT);
  static constexpr size_t s = v + align128(sizeof(T) * BK * kLdT);
  static constexpr size_t p = s + align128(sizeof(float) * BQ * kLdS);
  static constexpr size_t o = p + align128(sizeof(T) * BQ * kLdP);
  static constexpr size_t l = o + align128(sizeof(float) * BQ * kLdO);
  static constexpr size_t bytes = l + align128(sizeof(float) * BQ);
  static_assert(bytes <= kMaxSmem, "forward tiles exceed shared memory");
};

template <typename T, int D, int BQ, int BK>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int tq, int tk, int causal) {
  using L = FwdSmem<T, D, BQ, BK>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem + L::q);
  T* ks = reinterpret_cast<T*>(smem + L::k);
  T* vs = reinterpret_cast<T*>(smem + L::v);
  float* ss = reinterpret_cast<float*>(smem + L::s);
  T* ps = reinterpret_cast<T*>(smem + L::p);
  float* os = reinterpret_cast<float*>(smem + L::o);
  float* ls = reinterpret_cast<float*>(smem + L::l);

  // Heaviest causal q blocks (the last ones) start first.
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const size_t bh = blockIdx.y;
  const T* qg = q + bh * tq * D;
  const T* kg = k + bh * tk * D;
  const T* vg = v + bh * tk * D;

  load_rows<T, BQ, D, L::kLdT>(qs, qg, q0, tq);
  zero_acc<BQ, D, L::kLdO>(os);

  // Each row of the block belongs to TPR consecutive lanes of one warp;
  // they keep the row's m and l in registers for the whole kernel.
  constexpr int TPR = kThreads / BQ;
  const int r = threadIdx.x / TPR;
  const int sub = threadIdx.x % TPR;
  float m = kNeg, l = 0.f;

  const int nk = (tk + BK - 1) / BK;
  const int kend = causal ? min(nk, (q0 + BQ - 1) / BK + 1) : nk;
  for (int kb = 0; kb < kend; ++kb) {
    const int k0 = kb * BK;
    __syncthreads();  // the previous p.v product is done with k, v, p
    load_rows<T, BK, D, L::kLdT>(ks, kg, k0, tk);
    load_rows<T, BK, D, L::kLdT>(vs, vg, k0, tk);
    __syncthreads();
    mm_abt<T, BQ, BK, D, false>(ss, L::kLdS, qs, L::kLdT, ks, L::kLdT);
    __syncthreads();

    const bool need_mask = (causal && q0 < k0 + BK - 1) || k0 + BK > tk ||
                           q0 + BQ > tq;
    float* srow = ss + r * L::kLdS;
    float mx = kNeg;
    for (int j = sub; j < BK; j += TPR) {
      float sv = srow[j];
      if (need_mask && masked_out(q0 + r, k0 + j, tq, tk, causal)) {
        sv = kNeg;
        srow[j] = sv;
      }
      mx = fmaxf(mx, sv);
    }
    mx = group_max<TPR>(mx);
    const float m_new = fmaxf(m, mx);
    float sum = 0.f;
    for (int j = sub; j < BK; j += TPR) {
      const float pv = expf(srow[j] - m_new);
      sum += pv;
      ps[r * L::kLdP + j] = from_f<T>(pv);
    }
    sum = group_sum<TPR>(sum);
    const float corr = expf(m - m_new);
    l = l * corr + sum;
    m = m_new;
    for (int c = sub; c < D; c += TPR) os[r * L::kLdO + c] *= corr;
    __syncthreads();
    mm_ab<T, BQ, D, BK, true>(os, L::kLdO, ps, L::kLdP, vs, L::kLdT);
  }
  __syncthreads();

  if (sub == 0) {
    const float lc = fmaxf(l, 1e-30f);
    ls[r] = lc;
    if (q0 + r < tq) lse[bh * tq + q0 + r] = m + logf(lc);
  }
  __syncthreads();
  T* og = o + bh * tq * D;
  for (int i = threadIdx.x; i < BQ * D; i += kThreads) {
    const int rr = i / D, c = i % D;
    if (q0 + rr < tq) {
      og[static_cast<size_t>(q0 + rr) * D + c] =
          from_f<T>(os[rr * L::kLdO + c] / ls[rr]);
    }
  }
}

template <typename T, int D, int BQ, int BK>
int launch_fwd(const void* q, const void* k, const void* v, void* o,
               void* lse, int bh, int tq, int tk, int causal,
               cudaStream_t stream) {
  using L = FwdSmem<T, D, BQ, BK>;
  auto kernel = flash_fwd_kernel<T, D, BQ, BK>;
  static bool smem_set = false;
  cudaError_t err = allow_smem(kernel, L::bytes, &smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((tq + BQ - 1) / BQ, bh);
  kernel<<<grid, kThreads, L::bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o),
      static_cast<float*>(lse), tq, tk, causal);
  return static_cast<int>(cudaGetLastError());
}

// Block sizes from Hopper's shared memory: 64 x 64 tiles everywhere but
// float32 at head dim 256, whose k block halves to fit 227 KB.
template <typename T>
int fwd_for_dim(int d, const void* q, const void* k, const void* v,
                void* o, void* lse, int bh, int tq, int tk, int causal,
                cudaStream_t s) {
  constexpr bool f32 = std::is_same<T, float>::value;
  switch (d) {
    case 32: return launch_fwd<T, 32, 64, 64>(q, k, v, o, lse, bh, tq, tk, causal, s);
    case 64: return launch_fwd<T, 64, 64, 64>(q, k, v, o, lse, bh, tq, tk, causal, s);
    case 128: return launch_fwd<T, 128, 64, 64>(q, k, v, o, lse, bh, tq, tk, causal, s);
    case 256: return launch_fwd<T, 256, 64, f32 ? 32 : 64>(q, k, v, o, lse, bh, tq, tk, causal, s);
    default: return MVT_UNSUPPORTED;
  }
}

}  // namespace mvt

// q (pre-scaled), k, v: [bh, T, d]; o: [bh, tq, d]; lse: [bh, tq] float.
extern "C" int mvt_flash_fwd(const void* q, const void* k, const void* v,
                             void* o, void* lse, int bh, int tq, int tk,
                             int d, int dtype, int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == MVT_DTYPE_F32) {
    return mvt::fwd_for_dim<float>(d, q, k, v, o, lse, bh, tq, tk, causal, s);
  }
  if (dtype == MVT_DTYPE_BF16) {
    return mvt::fwd_for_dim<__nv_bfloat16>(d, q, k, v, o, lse, bh, tq, tk,
                                           causal, s);
  }
  return MVT_UNSUPPORTED;
}
