// Flash-attention backward, dk and dv, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_dkv_kernel`
// (multiverso_tpu/ops/flash_attention.py:184-233, pl.pallas_call at
// :340).  For one (bh, k block) it loops over the q blocks, recomputes
// p = exp(s - lse), and accumulates dv += p^T do and dk += ds^T q with
// ds = p (dp - delta), dp = do v^T.  q arrives pre-scaled, so dk needs
// no further factor (dk = scale ds^T q_unscaled = ds^T q_scaled).
//
// Causal schedule as the TPU kernel: q blocks entirely above the
// diagonal for this k block are never visited (the loop starts at the
// first q block that reaches it), and only straddling or ragged blocks
// are masked.
//
// Bound on an H100: four tile products per visited block, tensor-core
// bound at the trainer's shapes; this first kernel keeps operands and
// both accumulators in shared memory and reaches a fraction of it.
#include "flash_common.cuh"

namespace mvt {

template <typename T, int D, int BQ, int BK>
struct DkvSmem {
  static constexpr int kLdT = Ld<T, D>::value;
  static constexpr int kLdS = Ld<float, BK>::value;
  static constexpr int kLdP = Ld<T, BK>::value;
  static constexpr int kLdO = Ld<float, D>::value;
  static constexpr size_t k = 0;
  static constexpr size_t v = k + align128(sizeof(T) * BK * kLdT);
  static constexpr size_t q = v + align128(sizeof(T) * BK * kLdT);
  static constexpr size_t dout = q + align128(sizeof(T) * BQ * kLdT);
  static constexpr size_t s = dout + align128(sizeof(T) * BQ * kLdT);
  static constexpr size_t dp = s + align128(sizeof(float) * BQ * kLdS);
  static constexpr size_t p = dp + align128(sizeof(float) * BQ * kLdS);
  static constexpr size_t ds = p + align128(sizeof(T) * BQ * kLdP);
  static constexpr size_t dk = ds + align128(sizeof(T) * BQ * kLdP);
  static constexpr size_t dv = dk + align128(sizeof(float) * BK * kLdO);
  static constexpr size_t lse = dv + align128(sizeof(float) * BK * kLdO);
  static constexpr size_t delta = lse + align128(sizeof(float) * BQ);
  static constexpr size_t bytes = delta + align128(sizeof(float) * BQ);
  static_assert(bytes <= kMaxSmem, "dkv tiles exceed shared memory");
};

template <typename T, int D, int BQ, int BK>
__global__ void __launch_bounds__(kThreads)
    flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int tq, int tk, int causal) {
  using L = DkvSmem<T, D, BQ, BK>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem + L::k);
  T* vs = reinterpret_cast<T*>(smem + L::v);
  T* qs = reinterpret_cast<T*>(smem + L::q);
  T* dos = reinterpret_cast<T*>(smem + L::dout);
  float* ss = reinterpret_cast<float*>(smem + L::s);
  float* dps = reinterpret_cast<float*>(smem + L::dp);
  T* pts = reinterpret_cast<T*>(smem + L::p);
  T* dss = reinterpret_cast<T*>(smem + L::ds);
  float* dks = reinterpret_cast<float*>(smem + L::dk);
  float* dvs = reinterpret_cast<float*>(smem + L::dv);
  float* lses = reinterpret_cast<float*>(smem + L::lse);
  float* dls = reinterpret_cast<float*>(smem + L::delta);

  // Early k blocks see the most causal q blocks: natural order runs the
  // heaviest first.
  const int k0 = blockIdx.x * BK;
  const size_t bh = blockIdx.y;
  const T* qg = q + bh * tq * D;
  const T* dog = dout + bh * tq * D;

  load_rows<T, BK, D, L::kLdT>(ks, k + bh * tk * D, k0, tk);
  load_rows<T, BK, D, L::kLdT>(vs, v + bh * tk * D, k0, tk);
  zero_acc<BK, D, L::kLdO>(dks);
  zero_acc<BK, D, L::kLdO>(dvs);

  const int nq = (tq + BQ - 1) / BQ;
  const int qstart = causal ? k0 / BQ : 0;
  for (int qb = qstart; qb < nq; ++qb) {
    const int q0 = qb * BQ;
    __syncthreads();  // the previous products are done with q, do, p, ds
    load_rows<T, BQ, D, L::kLdT>(qs, qg, q0, tq);
    load_rows<T, BQ, D, L::kLdT>(dos, dog, q0, tq);
    load_vec<BQ>(lses, lse + bh * tq, q0, tq);
    load_vec<BQ>(dls, delta + bh * tq, q0, tq);
    __syncthreads();
    mm_abt<T, BQ, BK, D, false>(ss, L::kLdS, qs, L::kLdT, ks, L::kLdT);
    mm_abt<T, BQ, BK, D, false>(dps, L::kLdS, dos, L::kLdT, vs, L::kLdT);
    __syncthreads();

    const bool need_mask = (causal && q0 < k0 + BK - 1) || k0 + BK > tk ||
                           q0 + BQ > tq;
    for (int idx = threadIdx.x; idx < BQ * BK; idx += kThreads) {
      const int i = idx / BK, j = idx % BK;
      float sv = ss[i * L::kLdS + j];
      if (need_mask && masked_out(q0 + i, k0 + j, tq, tk, causal)) sv = kNeg;
      const float pv = expf(sv - lses[i]);
      const float dsv = pv * (dps[i * L::kLdS + j] - dls[i]);
      pts[i * L::kLdP + j] = from_f<T>(pv);
      dss[i * L::kLdP + j] = from_f<T>(dsv);
    }
    __syncthreads();
    mm_atb<T, BK, D, BQ, true>(dvs, L::kLdO, pts, L::kLdP, dos, L::kLdT);
    mm_atb<T, BK, D, BQ, true>(dks, L::kLdO, dss, L::kLdP, qs, L::kLdT);
  }
  __syncthreads();

  T* dkg = dk + bh * tk * D;
  T* dvg = dv + bh * tk * D;
  for (int i = threadIdx.x; i < BK * D; i += kThreads) {
    const int rr = i / D, c = i % D;
    if (k0 + rr < tk) {
      const size_t at = static_cast<size_t>(k0 + rr) * D + c;
      dkg[at] = from_f<T>(dks[rr * L::kLdO + c]);
      dvg[at] = from_f<T>(dvs[rr * L::kLdO + c]);
    }
  }
}

template <typename T, int D, int BQ, int BK>
int launch_dkv(const void* q, const void* k, const void* v,
               const void* dout, const void* lse, const void* delta,
               void* dk, void* dv, int bh, int tq, int tk, int causal,
               cudaStream_t stream) {
  using L = DkvSmem<T, D, BQ, BK>;
  auto kernel = flash_dkv_kernel<T, D, BQ, BK>;
  static bool smem_set = false;
  cudaError_t err = allow_smem(kernel, L::bytes, &smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((tk + BK - 1) / BK, bh);
  kernel<<<grid, kThreads, L::bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), tq, tk, causal);
  return static_cast<int>(cudaGetLastError());
}

// 64-row k blocks over 64-row q blocks, except where two float32
// accumulators and six operand tiles outgrow 227 KB: float32 at head dim
// 128 halves the q block, and head dim 256 runs 32 x 32.
template <typename T>
int dkv_for_dim(int d, const void* q, const void* k, const void* v,
                const void* dout, const void* lse, const void* delta,
                void* dk, void* dv, int bh, int tq, int tk, int causal,
                cudaStream_t s) {
  constexpr bool f32 = std::is_same<T, float>::value;
  switch (d) {
    case 32: return launch_dkv<T, 32, 64, 64>(q, k, v, dout, lse, delta, dk, dv, bh, tq, tk, causal, s);
    case 64: return launch_dkv<T, 64, 64, 64>(q, k, v, dout, lse, delta, dk, dv, bh, tq, tk, causal, s);
    case 128: return launch_dkv<T, 128, f32 ? 32 : 64, 64>(q, k, v, dout, lse, delta, dk, dv, bh, tq, tk, causal, s);
    case 256: return launch_dkv<T, 256, 32, 32>(q, k, v, dout, lse, delta, dk, dv, bh, tq, tk, causal, s);
    default: return MVT_UNSUPPORTED;
  }
}

}  // namespace mvt

// q (pre-scaled), k, v, dout: [bh, T, d]; lse, delta: [bh, tq] float;
// dk, dv: [bh, tk, d].
extern "C" int mvt_flash_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, void* dk, void* dv, int bh,
                             int tq, int tk, int d, int dtype, int causal,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == MVT_DTYPE_F32) {
    return mvt::dkv_for_dim<float>(d, q, k, v, dout, lse, delta, dk, dv, bh,
                                   tq, tk, causal, s);
  }
  if (dtype == MVT_DTYPE_BF16) {
    return mvt::dkv_for_dim<__nv_bfloat16>(d, q, k, v, dout, lse, delta, dk,
                                           dv, bh, tq, tk, causal, s);
  }
  return MVT_UNSUPPORTED;
}
