// Flash-attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_fwd_kernel`
// (multiverso_tpu/ops/flash_attention.py:83-135, launched by `_fwd_impl`
// through pl.pallas_call at :248).  For one (bh, q tile) it walks the k
// blocks with an online softmax — running max m, running sum l and a
// float32 output accumulator — and writes o = acc / max(l, 1e-30) and
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
// by memory, so the bound is the tensor-core rate.  Two designs, chosen
// at compile time by (dtype, D) in fwd_for_dim:
//
// * bf16 at D 64 and 128 (flash_fwd_hopper): the tensor cores are fed
//   without shared-memory round trips.  One block per (bh, 128-row q
//   tile) of two consumer warpgroups and a producer warp (hopper.cuh).
//   The producer's TMA loads bring the q tile once, then k and v tiles of
//   128 rows into a ring of kStages stages guarded by full and empty
//   mbarriers.  Each consumer warpgroup owns 64 q rows: s = q·kᵀ
//   by wgmma from shared memory into registers, the softmax in registers
//   (row max and sum across the 4 lanes that share a row), p rounded to
//   bf16 in registers and fed back as the register A operand of o += p·v
//   (v MN-major), o in registers for the whole loop.  The two warpgroups
//   run independently, so one's softmax overlaps the other's products.
// * float32 at every D, and bf16 at D 32 and 256 (flash_fwd_kernel): the
//   first port's design.  Every tile staged in shared memory, bf16
//   products through WMMA 16x16x16 with float32 accumulators in shared
//   memory, float32 products as plain FMAs (no TF32).
#include "flash_common.cuh"
#include "hopper.cuh"

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

// ------------------------------------------------ bf16 Hopper design
template <int D>
struct HopFwd {
  static constexpr int BQ = 128, BK = 128, kStages = 3, kBoxes = D / 64;
  static constexpr uint32_t kBoxQ = BQ * hop::kRowBytes;  // one 64-col box
  static constexpr uint32_t kBoxK = BK * hop::kRowBytes;
  static constexpr uint32_t kQBytes = kBoxes * kBoxQ;
  static constexpr uint32_t kKBytes = kBoxes * kBoxK;
  static constexpr size_t q = 0;
  static constexpr size_t kv = kQBytes;  // stage s: k, then v
  static constexpr size_t bars = kv + kStages * 2 * kKBytes;
  static constexpr size_t bytes = bars + 8 * (2 * kStages + 1) + hop::kAtomBytes;
  static_assert(D == 64 || D == 128, "the Hopper forward covers D 64, 128");
  static_assert(bytes <= kMaxSmem, "forward tiles exceed shared memory");
};

constexpr int kFwdThreads = hop::kThreads + 32;  // + the producer warp

template <int D>
__global__ void __launch_bounds__(kFwdThreads, 1)
    flash_fwd_hopper(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     bf16* __restrict__ o, float* __restrict__ lse, int tq,
                     int tk, int causal) {
  using C = HopFwd<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = hop::align_atom(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::bars);
  uint64_t* empty = full + C::kStages;
  uint64_t* qbar = empty + C::kStages;

  const int bh = blockIdx.x;
  // Heaviest causal q tiles (the last ones) start first, over all heads.
  const int q0 = (gridDim.y - 1 - blockIdx.y) * C::BQ;
  const int nk = (tk + C::BK - 1) / C::BK;
  const int kend = causal ? min(nk, (q0 + C::BQ - 1) / C::BK + 1) : nk;

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
  if (warp == hop::kWarps) {
    // The producer: one thread loads the q tile, then k block j into
    // stage j % kStages once both warpgroups have released the block
    // kStages before it.
    if (lane == 0) {
      hop::mbar_expect_tx(qbar, C::kQBytes);
      for (int b = 0; b < C::kBoxes; ++b) {
        hop::tma_load(smem + C::q + b * C::kBoxQ, &tm_q, qbar, b * 64, q0, bh);
      }
      for (int j = 0; j < kend; ++j) {
        const int s = j % C::kStages;
        hop::mbar_wait(&empty[s], ((j / C::kStages) & 1) ^ 1);
        hop::mbar_expect_tx(&full[s], 2 * C::kKBytes);
        unsigned char* ks = smem + C::kv + s * 2 * C::kKBytes;
        for (int b = 0; b < C::kBoxes; ++b) {
          hop::tma_load(ks + b * C::kBoxK, &tm_k, &full[s], b * 64,
                        j * C::BK, bh);
          hop::tma_load(ks + C::kKBytes + b * C::kBoxK, &tm_v, &full[s],
                        b * 64, j * C::BK, bh);
        }
      }
    }
    return;
  }

  // Warpgroup g owns q rows [q0 + 64g, q0 + 64g + 64).  In the m64nNk16
  // accumulator layout each thread holds rows r0 and r0 + 8, columns
  // 8j + cq and 8j + cq + 1 of every 8-column slice j.
  const int g = warp / 4;
  const int r0 = (warp % 4) * 16 + lane / 4;
  const int cq = 2 * (lane % 4);
  const int qw = q0 + 64 * g;
  const int row0 = qw + r0, row1 = row0 + 8;
  const uint32_t q_addr = hop::smem_u32(smem + C::q) + 64 * g * hop::kRowBytes;

  float acc[D / 2];  // o, unnormalised
  float sc[64];      // s, then p, of the current k block
  uint32_t pa[32];   // p as bf16 A fragments
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m0 = kNeg, m1 = kNeg, l0 = 0.f, l1 = 0.f;
  hop::mbar_wait(qbar, 0);

  for (int kb = 0; kb < kend; ++kb) {
    const int s = kb % C::kStages;
    const uint32_t k_addr = hop::smem_u32(smem + C::kv + s * 2 * C::kKBytes);
    const uint32_t v_addr = k_addr + C::kKBytes;
    hop::mbar_wait(&full[s], (kb / C::kStages) & 1);

    // s = q·kᵀ over D in steps of 16: both operands K-major.
    hop::wgmma_fence();
#pragma unroll
    for (int x = 0; x < D / 16; ++x) {
      const uint64_t da = hop::desc_sw128(
          q_addr + (x / 4) * C::kBoxQ + (x % 4) * 32, 16, 1024);
      const uint64_t db = hop::desc_sw128(
          k_addr + (x / 4) * C::kBoxK + (x % 4) * 32, 16, 1024);
      if (x == 0) {
        hop::wgmma_ss_first(sc, da, db);
      } else {
        hop::wgmma_ss(sc, da, db);
      }
    }
    hop::wgmma_commit();
    hop::wgmma_wait<0>();
    hop::fence_regs(sc);

    // The online softmax in registers: sc becomes p, m and l move on.  l
    // stays a per-thread partial sum; the 4 lanes of a row add theirs
    // once, in the epilogue.
    const int k0 = kb * C::BK;
    if ((causal && k0 + C::BK - 1 > qw) || k0 + C::BK > tk) {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kc = k0 + 8 * j + cq + e;
          if (kc >= tk || (causal && kc > row0)) sc[4 * j + e] = kNeg;
          if (kc >= tk || (causal && kc > row1)) sc[4 * j + 2 + e] = kNeg;
        }
      }
    }
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
    }
    mx0 = group_max<4>(mx0);
    mx1 = group_max<4>(mx1);
    const float corr0 = hop::exp2_approx((m0 - mx0) * hop::kLog2e);
    const float corr1 = hop::exp2_approx((m1 - mx1) * hop::kLog2e);
    m0 = mx0;
    m1 = mx1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        sc[4 * j + e] = hop::exp2_approx((sc[4 * j + e] - mx0) * hop::kLog2e);
        sc[4 * j + 2 + e] =
            hop::exp2_approx((sc[4 * j + 2 + e] - mx1) * hop::kLog2e);
        sum0 += sc[4 * j + e];
        sum1 += sc[4 * j + 2 + e];
      }
    }
    l0 = l0 * corr0 + sum0;
    l1 = l1 * corr1 + sum1;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      acc[4 * j] *= corr0;
      acc[4 * j + 1] *= corr0;
      acc[4 * j + 2] *= corr1;
      acc[4 * j + 3] *= corr1;
    }

    // o += p·v over the k block in steps of 16 keys: p from registers, v
    // MN-major (the next 16 keys are 2048 bytes further).
    hop::acc_to_a(sc, pa);
    hop::wgmma_fence();
#pragma unroll
    for (int x = 0; x < C::BK / 16; ++x) {
      hop::wgmma_rs(acc, pa[4 * x], pa[4 * x + 1], pa[4 * x + 2],
                    pa[4 * x + 3],
                    hop::desc_sw128(v_addr + x * 16 * hop::kRowBytes, C::kBoxK,
                                    1024));
    }
    hop::wgmma_commit();
    hop::wgmma_wait<0>();
    hop::fence_regs(acc);

    // The stage is free once this warp's products that read it are done.
    __syncwarp();
    if (lane == 0) hop::mbar_arrive(&empty[s]);
  }

  l0 = group_sum<4>(l0);
  l1 = group_sum<4>(l1);
  const float lc0 = fmaxf(l0, 1e-30f), lc1 = fmaxf(l1, 1e-30f);
  bf16* og = o + static_cast<size_t>(bh) * tq * D;
  if (row0 < tq) {
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<uint32_t*>(og + static_cast<size_t>(row0) * D +
                                   8 * j + cq) =
          hop::pack_bf16(acc[4 * j] / lc0, acc[4 * j + 1] / lc0);
    }
    if (lane % 4 == 0) lse[static_cast<size_t>(bh) * tq + row0] = m0 + logf(lc0);
  }
  if (row1 < tq) {
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<uint32_t*>(og + static_cast<size_t>(row1) * D +
                                   8 * j + cq) =
          hop::pack_bf16(acc[4 * j + 2] / lc1, acc[4 * j + 3] / lc1);
    }
    if (lane % 4 == 0) lse[static_cast<size_t>(bh) * tq + row1] = m1 + logf(lc1);
  }
}

template <int D>
int launch_fwd_hopper(const void* q, const void* k, const void* v, void* o,
                      void* lse, int bh, int tq, int tk, int causal,
                      cudaStream_t stream) {
  using C = HopFwd<D>;
  // The maps hold the tensors' addresses, so they are made on every call.
  CUtensorMap mq, mk, mv;
  if (!hop::make_map(&mq, q, D, tq, bh, C::BQ) ||
      !hop::make_map(&mk, k, D, tk, bh, C::BK) ||
      !hop::make_map(&mv, v, D, tk, bh, C::BK)) {
    return MVT_TMA_REFUSED;
  }
  auto kernel = flash_fwd_hopper<D>;
  static bool smem_set = false;
  cudaError_t err = allow_smem(kernel, C::bytes, &smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(bh, (tq + C::BQ - 1) / C::BQ);
  kernel<<<grid, kFwdThreads, C::bytes, stream>>>(
      mq, mk, mv, static_cast<bf16*>(o), static_cast<float*>(lse), tq, tk,
      causal);
  return static_cast<int>(cudaGetLastError());
}

// The design is fixed by (dtype, D) at compile time: bf16 at D 64 and 128
// runs the Hopper design above; the rest runs the first port's kernel,
// with 64 x 64 tiles everywhere but float32 at head dim 256, whose k block
// halves to fit 227 KB.
template <typename T>
int fwd_for_dim(int d, const void* q, const void* k, const void* v,
                void* o, void* lse, int bh, int tq, int tk, int causal,
                cudaStream_t s) {
  constexpr bool f32 = std::is_same<T, float>::value;
  switch (d) {
    case 32: return launch_fwd<T, 32, 64, 64>(q, k, v, o, lse, bh, tq, tk, causal, s);
    case 64:
      if constexpr (f32) return launch_fwd<T, 64, 64, 64>(q, k, v, o, lse, bh, tq, tk, causal, s);
      else return launch_fwd_hopper<64>(q, k, v, o, lse, bh, tq, tk, causal, s);
    case 128:
      if constexpr (f32) return launch_fwd<T, 128, 64, 64>(q, k, v, o, lse, bh, tq, tk, causal, s);
      else return launch_fwd_hopper<128>(q, k, v, o, lse, bh, tq, tk, causal, s);
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
