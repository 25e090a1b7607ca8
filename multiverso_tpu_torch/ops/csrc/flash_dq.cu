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
// tiles read, so tensor-core bound at the shapes the trainer uses.  Two
// designs, chosen at compile time by (dtype, D) in dq_for_dim:
//
// * bf16 at D 64 and 128 (flash_dq_hopper): q-stationary, the forward's
//   shape with dk/dv's products, accumulators in registers.  One block
//   of two warpgroups per (bh, 128-row q tile) (hopper.cuh).  Warp 0
//   loads q and do once by TMA, then k and v blocks of 128 rows into a
//   ring of kStages stages, refilling a stage once both warpgroups have
//   released it.  Each warpgroup owns 64 q rows, keeps their lse and
//   delta in registers (two rows a thread) and their float32 dq in
//   registers for the whole k loop.  Per k block it forms s = q·kᵀ and
//   dp = do·vᵀ by wgmma (both operands K-major in shared memory), then
//   p = exp(s - lse) and ds = p (dp - delta) in registers, rounds ds to
//   bf16 in registers and feeds it as the register A operand of
//   dq += ds·k (k MN-major: the same bytes as s's K-major B).  No score
//   tile is ever written to shared memory.  The 128-key block needs
//   three 64-float accumulators at D 128, so the block runs 8 warps and
//   no producer warp (a ninth warp caps ptxas at 168 registers); 64-key
//   blocks under a producer warp spilled there and ran slower.
// * float32 at every D, and bf16 at D 32 and 256 (flash_dq_kernel): the
//   first port's design, operands and the accumulator in shared memory,
//   bf16 products through WMMA.
#include "flash_common.cuh"
#include "hopper.cuh"

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

  // bh on grid x (no 65,535 cap), q tiles on y: the heaviest causal q
  // tiles (the last ones) start first, over all heads.
  const size_t bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
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
  dim3 grid(bh, (tq + BQ - 1) / BQ);
  kernel<<<grid, kThreads, L::bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), tq, tk, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------ bf16 Hopper design
template <int D>
struct HopDq {
  static constexpr int BQ = 128, BK = 128, kBoxes = D / 64;
  static constexpr uint32_t kBoxQ = BQ * hop::kRowBytes;  // one 64-col box
  static constexpr uint32_t kBoxK = BK * hop::kRowBytes;
  static constexpr uint32_t kQBytes = kBoxes * kBoxQ;
  static constexpr uint32_t kKBytes = kBoxes * kBoxK;
  static constexpr size_t q = 0;
  static constexpr size_t dout = kQBytes;
  static constexpr size_t kv = 2 * kQBytes;  // stage s: k, then v
  // As many k/v stages as fit beside q and do, at most 4.
  static constexpr int kStages = D == 128 ? 2 : 4;
  static constexpr size_t bars = kv + kStages * 2 * kKBytes;
  static constexpr size_t bytes = bars + 8 * (2 * kStages + 1) + hop::kAtomBytes;
  static_assert(D == 64 || D == 128, "the Hopper dq covers D 64, 128");
  static_assert(bytes <= kMaxSmem, "dq tiles exceed shared memory");
};

template <int D>
__global__ void __launch_bounds__(hop::kThreads, 1)
    flash_dq_hopper(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const __grid_constant__ CUtensorMap tm_do,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dq,
                    int tq, int tk, int causal, float scale) {
  using C = HopDq<D>;
  constexpr int BK = C::BK;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = hop::align_atom(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::bars);
  uint64_t* empty = full + C::kStages;
  uint64_t* qbar = empty + C::kStages;

  const int bh = blockIdx.x;
  // Heaviest causal q tiles (the last ones) start first, over all heads.
  // With BK == BQ the causal end block starts at q0, so every visited
  // block reaches both warpgroups' rows: none is skipped.
  const int q0 = (gridDim.y - 1 - blockIdx.y) * C::BQ;
  const int nk = (tk + BK - 1) / BK;
  const int kend = causal ? min(nk, q0 / BK + 1) : nk;

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      hop::mbar_init(&full[s], 1);
      hop::mbar_init(&empty[s], hop::kWarps);
    }
    hop::mbar_init(qbar, 1);
    hop::fence_barrier_init();
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // Warp 0 loads q and do once, then k block j into stage j % kStages:
  // the first kStages blocks at once, each later one as soon as both
  // warpgroups have released the block kStages before it.
  auto load_kv = [&](int j) {
    const int s = j % C::kStages;
    hop::mbar_wait(&empty[s], ((j / C::kStages) & 1) ^ 1);
    if (lane == 0) {
      hop::mbar_expect_tx(&full[s], 2 * C::kKBytes);
      unsigned char* ks = smem + C::kv + s * 2 * C::kKBytes;
      for (int b = 0; b < C::kBoxes; ++b) {
        hop::tma_load(ks + b * C::kBoxK, &tm_k, &full[s], b * 64, j * BK, bh);
        hop::tma_load(ks + C::kKBytes + b * C::kBoxK, &tm_v, &full[s], b * 64,
                      j * BK, bh);
      }
    }
    __syncwarp();
  };
  if (warp == 0) {
    if (lane == 0) {
      hop::mbar_expect_tx(qbar, 2 * C::kQBytes);
      for (int b = 0; b < C::kBoxes; ++b) {
        hop::tma_load(smem + C::q + b * C::kBoxQ, &tm_q, qbar, b * 64, q0, bh);
        hop::tma_load(smem + C::dout + b * C::kBoxQ, &tm_do, qbar, b * 64, q0,
                      bh);
      }
    }
    __syncwarp();
    for (int j = 0; j < C::kStages && j < kend; ++j) load_kv(j);
  }

  // Warpgroup g owns q rows [q0 + 64g, q0 + 64g + 64).  In the m64nNk16
  // accumulator layout each thread holds rows r0 and r0 + 8, columns
  // 8j + cq and 8j + cq + 1 of every 8-column slice j, so its lse and
  // delta are two floats each.  Rows past tq read lse and delta as 0:
  // their q and do rows are TMA zeros, so their ds is 0, and their dq is
  // never stored.
  const int g = warp / 4;
  const int r0 = (warp % 4) * 16 + lane / 4;
  const int cq = 2 * (lane % 4);
  const int qw = q0 + 64 * g;
  const int row0 = qw + r0, row1 = row0 + 8;
  const uint32_t q_addr = hop::smem_u32(smem + C::q) + 64 * g * hop::kRowBytes;
  const uint32_t do_addr =
      hop::smem_u32(smem + C::dout) + 64 * g * hop::kRowBytes;
  const float* lg = lse + static_cast<size_t>(bh) * tq;
  const float* dg = delta + static_cast<size_t>(bh) * tq;
  const float ls0 = row0 < tq ? lg[row0] * hop::kLog2e : 0.f;
  const float ls1 = row1 < tq ? lg[row1] * hop::kLog2e : 0.f;
  const float dl0 = row0 < tq ? dg[row0] : 0.f;
  const float dl1 = row1 < tq ? dg[row1] : 0.f;

  float acc[D / 2];  // dq, unscaled
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  hop::mbar_wait(qbar, 0);

  for (int kb = 0; kb < kend; ++kb) {
    const int s = kb % C::kStages;
    const int k0 = kb * BK;
    hop::mbar_wait(&full[s], (kb / C::kStages) & 1);
    const uint32_t k_addr = hop::smem_u32(smem + C::kv + s * 2 * C::kKBytes);
    const uint32_t v_addr = k_addr + C::kKBytes;

    // s = q·kᵀ and dp = do·vᵀ over D in steps of 16, all K-major.
    float sc[BK / 2], dp[BK / 2];
    hop::wgmma_fence();
#pragma unroll
    for (int x = 0; x < D / 16; ++x) {
      const uint32_t qcol = (x / 4) * C::kBoxQ + (x % 4) * 32;
      const uint32_t kcol = (x / 4) * C::kBoxK + (x % 4) * 32;
      const uint64_t a = hop::desc_sw128(q_addr + qcol, 16, 1024);
      const uint64_t b = hop::desc_sw128(k_addr + kcol, 16, 1024);
      if (x == 0) {
        hop::wgmma_ss_first(sc, a, b);
      } else {
        hop::wgmma_ss(sc, a, b);
      }
    }
#pragma unroll
    for (int x = 0; x < D / 16; ++x) {
      const uint32_t qcol = (x / 4) * C::kBoxQ + (x % 4) * 32;
      const uint32_t kcol = (x / 4) * C::kBoxK + (x % 4) * 32;
      const uint64_t a = hop::desc_sw128(do_addr + qcol, 16, 1024);
      const uint64_t b = hop::desc_sw128(v_addr + kcol, 16, 1024);
      if (x == 0) {
        hop::wgmma_ss_first(dp, a, b);
      } else {
        hop::wgmma_ss(dp, a, b);
      }
    }
    hop::wgmma_commit();
    hop::wgmma_wait<0>();
    hop::fence_regs(sc);
    hop::fence_regs(dp);

    if ((causal && k0 + BK - 1 > qw) || k0 + BK > tk) {
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kc = k0 + 8 * j + cq + e;
          if (masked_out(row0, kc, tq, tk, causal)) sc[4 * j + e] = kNeg;
          if (masked_out(row1, kc, tq, tk, causal)) sc[4 * j + 2 + e] = kNeg;
        }
      }
    }
    // p = exp(s - lse), then ds = p (dp - delta), in place of dp.
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float p0 =
            hop::exp2_approx(fmaf(sc[4 * j + e], hop::kLog2e, -ls0));
        const float p1 =
            hop::exp2_approx(fmaf(sc[4 * j + 2 + e], hop::kLog2e, -ls1));
        dp[4 * j + e] = p0 * (dp[4 * j + e] - dl0);
        dp[4 * j + 2 + e] = p1 * (dp[4 * j + 2 + e] - dl1);
      }
    }

    // dq += ds·k over the k block in steps of 16 keys: ds from registers,
    // k MN-major (the next 16 keys are 2048 bytes further).
    uint32_t dsa[BK / 4];
    hop::acc_to_a(dp, dsa);
    hop::wgmma_fence();
#pragma unroll
    for (int x = 0; x < BK / 16; ++x) {
      hop::wgmma_rs(acc, dsa[4 * x], dsa[4 * x + 1], dsa[4 * x + 2],
                    dsa[4 * x + 3],
                    hop::desc_sw128(k_addr + x * 16 * hop::kRowBytes, C::kBoxK,
                                    1024));
    }
    hop::wgmma_commit();
    hop::wgmma_wait<0>();
    hop::fence_regs(acc);

    // The stage is free once this warp's products that read it are done;
    // warp 0 then refills it kStages blocks ahead.
    __syncwarp();
    if (lane == 0) hop::mbar_arrive(&empty[s]);
    if (warp == 0 && kb + C::kStages < kend) load_kv(kb + C::kStages);
  }

  bf16* dqg = dq + static_cast<size_t>(bh) * tq * D;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = h ? row1 : row0;
    if (row < tq) {
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<uint32_t*>(dqg + static_cast<size_t>(row) * D +
                                     8 * j + cq) =
            hop::pack_bf16(acc[4 * j + 2 * h] * scale,
                           acc[4 * j + 2 * h + 1] * scale);
      }
    }
  }
}

template <int D>
int launch_dq_hopper(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* delta,
                     void* dq, int bh, int tq, int tk, int causal, float scale,
                     cudaStream_t stream) {
  using C = HopDq<D>;
  // The maps hold the tensors' addresses, so they are made on every call.
  CUtensorMap mq, mk, mv, mdo;
  if (!hop::make_map(&mq, q, D, tq, bh, C::BQ) ||
      !hop::make_map(&mk, k, D, tk, bh, C::BK) ||
      !hop::make_map(&mv, v, D, tk, bh, C::BK) ||
      !hop::make_map(&mdo, dout, D, tq, bh, C::BQ)) {
    return MVT_TMA_REFUSED;
  }
  auto kernel = flash_dq_hopper<D>;
  static bool smem_set = false;
  cudaError_t err = allow_smem(kernel, C::bytes, &smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(bh, (tq + C::BQ - 1) / C::BQ);
  kernel<<<grid, hop::kThreads, C::bytes, stream>>>(
      mq, mk, mv, mdo, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dq), tq, tk,
      causal, scale);
  return static_cast<int>(cudaGetLastError());
}

// The design is fixed by (dtype, D) at compile time: bf16 at D 64 and 128
// runs the Hopper design above; the rest runs the first port's kernel,
// 64 x 64 tiles except at head dim 256, where the k block halves in bf16
// and both blocks halve in float32 so the six tiles fit 227 KB.
template <typename T>
int dq_for_dim(int d, const void* q, const void* k, const void* v,
               const void* dout, const void* lse, const void* delta,
               void* dq, int bh, int tq, int tk, int causal, float scale,
               cudaStream_t s) {
  constexpr bool f32 = std::is_same<T, float>::value;
  switch (d) {
    case 32: return launch_dq<T, 32, 64, 64>(q, k, v, dout, lse, delta, dq, bh, tq, tk, causal, scale, s);
    case 64:
      if constexpr (f32) return launch_dq<T, 64, 64, 64>(q, k, v, dout, lse, delta, dq, bh, tq, tk, causal, scale, s);
      else return launch_dq_hopper<64>(q, k, v, dout, lse, delta, dq, bh, tq, tk, causal, scale, s);
    case 128:
      if constexpr (f32) return launch_dq<T, 128, 64, 64>(q, k, v, dout, lse, delta, dq, bh, tq, tk, causal, scale, s);
      else return launch_dq_hopper<128>(q, k, v, dout, lse, delta, dq, bh, tq, tk, causal, scale, s);
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
