// Flash-attention backward, dq, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_dq_kernel`
// (multiverso_tpu/ops/flash_attention.py:138-181, pl.pallas_call at
// :321).  For one (bh, q block) it loops over the k blocks and
// recomputes p = exp(s - lse) from the saved row logsumexp, then
// dp = do v^T, ds = p (dp - delta) and dq += ds k.  q arrives pre-scaled,
// so s and ds carry no per-element scale; the factor lands once on the
// float32 accumulator when dq is written, as on the TPU.
//
// Causal schedule as the forward: blocks above the diagonal are skipped,
// only straddling (or ragged) blocks are masked.
//
// Bound on an H100: three tile products per visited block against four
// tiles read, so tensor-core bound at the shapes the trainer uses; this
// first kernel keeps its operands and accumulator in shared memory and
// reaches a fraction of that bound.
#include "flash_common.cuh"

namespace mvt {

template <typename T, int D, int BQ, int BK>
struct DqSmem {
  static constexpr int kLdT = Ld<T, D>::value;
  static constexpr int kLdS = Ld<float, BK>::value;
  static constexpr int kLdP = Ld<T, BK>::value;
  static constexpr int kLdO = Ld<float, D>::value;
  static constexpr size_t q = 0;
  static constexpr size_t dout = q + align128(sizeof(T) * BQ * kLdT);
  static constexpr size_t k = dout + align128(sizeof(T) * BQ * kLdT);
  static constexpr size_t v = k + align128(sizeof(T) * BK * kLdT);
  static constexpr size_t s = v + align128(sizeof(T) * BK * kLdT);
  static constexpr size_t dp = s + align128(sizeof(float) * BQ * kLdS);
  static constexpr size_t ds = dp + align128(sizeof(float) * BQ * kLdS);
  static constexpr size_t dq = ds + align128(sizeof(T) * BQ * kLdP);
  static constexpr size_t lse = dq + align128(sizeof(float) * BQ * kLdO);
  static constexpr size_t delta = lse + align128(sizeof(float) * BQ);
  static constexpr size_t bytes = delta + align128(sizeof(float) * BQ);
  static_assert(bytes <= kMaxSmem, "dq tiles exceed shared memory");
};

template <typename T, int D, int BQ, int BK>
__global__ void __launch_bounds__(kThreads)
    flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int tq, int tk, int causal, float scale) {
  using L = DqSmem<T, D, BQ, BK>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem + L::q);
  T* dos = reinterpret_cast<T*>(smem + L::dout);
  T* ks = reinterpret_cast<T*>(smem + L::k);
  T* vs = reinterpret_cast<T*>(smem + L::v);
  float* ss = reinterpret_cast<float*>(smem + L::s);
  float* dps = reinterpret_cast<float*>(smem + L::dp);
  T* dss = reinterpret_cast<T*>(smem + L::ds);
  float* dqs = reinterpret_cast<float*>(smem + L::dq);
  float* lses = reinterpret_cast<float*>(smem + L::lse);
  float* dls = reinterpret_cast<float*>(smem + L::delta);

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const size_t bh = blockIdx.y;
  const T* kg = k + bh * tk * D;
  const T* vg = v + bh * tk * D;

  load_rows<T, BQ, D, L::kLdT>(qs, q + bh * tq * D, q0, tq);
  load_rows<T, BQ, D, L::kLdT>(dos, dout + bh * tq * D, q0, tq);
  load_vec<BQ>(lses, lse + bh * tq, q0, tq);
  load_vec<BQ>(dls, delta + bh * tq, q0, tq);
  zero_acc<BQ, D, L::kLdO>(dqs);

  const int nk = (tk + BK - 1) / BK;
  const int kend = causal ? min(nk, (q0 + BQ - 1) / BK + 1) : nk;
  for (int kb = 0; kb < kend; ++kb) {
    const int k0 = kb * BK;
    __syncthreads();  // the previous ds.k product is done with k and ds
    load_rows<T, BK, D, L::kLdT>(ks, kg, k0, tk);
    load_rows<T, BK, D, L::kLdT>(vs, vg, k0, tk);
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
      dss[i * L::kLdP + j] = from_f<T>(dsv);
    }
    __syncthreads();
    mm_ab<T, BQ, D, BK, true>(dqs, L::kLdO, dss, L::kLdP, ks, L::kLdT);
  }
  __syncthreads();

  T* dqg = dq + bh * tq * D;
  for (int i = threadIdx.x; i < BQ * D; i += kThreads) {
    const int rr = i / D, c = i % D;
    if (q0 + rr < tq) {
      dqg[static_cast<size_t>(q0 + rr) * D + c] =
          from_f<T>(dqs[rr * L::kLdO + c] * scale);
    }
  }
}

template <typename T, int D, int BQ, int BK>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, int bh, int tq,
              int tk, int causal, float scale, cudaStream_t stream) {
  using L = DqSmem<T, D, BQ, BK>;
  auto kernel = flash_dq_kernel<T, D, BQ, BK>;
  static bool smem_set = false;
  cudaError_t err = allow_smem(kernel, L::bytes, &smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((tq + BQ - 1) / BQ, bh);
  kernel<<<grid, kThreads, L::bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), tq, tk, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

// 64 x 64 tiles, except at head dim 256: the k block halves in bf16 and
// both blocks halve in float32 so the six tiles fit 227 KB.
template <typename T>
int dq_for_dim(int d, const void* q, const void* k, const void* v,
               const void* dout, const void* lse, const void* delta,
               void* dq, int bh, int tq, int tk, int causal, float scale,
               cudaStream_t s) {
  constexpr bool f32 = std::is_same<T, float>::value;
  switch (d) {
    case 32: return launch_dq<T, 32, 64, 64>(q, k, v, dout, lse, delta, dq, bh, tq, tk, causal, scale, s);
    case 64: return launch_dq<T, 64, 64, 64>(q, k, v, dout, lse, delta, dq, bh, tq, tk, causal, scale, s);
    case 128: return launch_dq<T, 128, 64, 64>(q, k, v, dout, lse, delta, dq, bh, tq, tk, causal, scale, s);
    case 256: return launch_dq<T, 256, f32 ? 32 : 64, 32>(q, k, v, dout, lse, delta, dq, bh, tq, tk, causal, scale, s);
    default: return MVT_UNSUPPORTED;
  }
}

}  // namespace mvt

// q (pre-scaled), k, v, dout: [bh, T, d]; lse, delta: [bh, tq] float;
// dq: [bh, tq, d], written as scale * ds k.
extern "C" int mvt_flash_dq(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, void* dq, int bh, int tq,
                            int tk, int d, int dtype, int causal,
                            float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == MVT_DTYPE_F32) {
    return mvt::dq_for_dim<float>(d, q, k, v, dout, lse, delta, dq, bh, tq,
                                  tk, causal, scale, s);
  }
  if (dtype == MVT_DTYPE_BF16) {
    return mvt::dq_for_dim<__nv_bfloat16>(d, q, k, v, dout, lse, delta, dq,
                                          bh, tq, tk, causal, scale, s);
  }
  return MVT_UNSUPPORTED;
}
