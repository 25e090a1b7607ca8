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
// bound at the trainer's shapes.  Two designs, chosen at compile time by
// (dtype, D) in dkv_for_dim:
//
// * bf16 at D 64 and 128 (flash_dkv_hopper): k-stationary with
//   transposed scores, accumulators in registers.  One block of two
//   warpgroups per (bh, 128-row k block) (hopper.cuh).  Thread 0 loads k
//   and v once; q and do tiles of 64 rows stream through a ring of
//   kStages stages by TMA, with the matching lse and delta rows beside
//   them by cp.async from warp 0, kStages blocks ahead.  Each
//   warpgroup owns 64 k rows and keeps its dk and dv float32
//   accumulators in registers for the whole q loop.  Per q block it forms
//   sᵀ = k·qᵀ and dpᵀ = v·doᵀ by wgmma (both operands from shared
//   memory), then pᵀ = exp(sᵀ - lse) and dsᵀ = pᵀ (dpᵀ - delta) in
//   registers (lse and delta broadcast along columns), rounds both to
//   bf16 in registers, and feeds them as the register A operand of
//   dv += pᵀ·do and dk += dsᵀ·q (do and q MN-major).  No score tile is
//   ever written to shared memory.
// * float32 at every D, and bf16 at D 32 and 256 (flash_dkv_kernel): the
//   first port's design, operands and both accumulators in shared
//   memory, bf16 products through WMMA.
#include "flash_common.cuh"
#include "hopper.cuh"

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

// ------------------------------------------------ bf16 Hopper design
template <int D>
struct HopDkv {
  static constexpr int BK = 128, BQ = 64, kStages = 3, kBoxes = D / 64;
  static constexpr uint32_t kBoxK = BK * hop::kRowBytes;  // one 64-col box
  static constexpr uint32_t kBoxQ = BQ * hop::kRowBytes;
  static constexpr uint32_t kKBytes = kBoxes * kBoxK;
  static constexpr uint32_t kQBytes = kBoxes * kBoxQ;
  static constexpr size_t k = 0;
  static constexpr size_t v = kKBytes;
  static constexpr size_t qdo = 2 * kKBytes;  // stage s: q, then do
  static constexpr size_t rows = qdo + kStages * 2 * kQBytes;  // lse, delta
  static constexpr size_t bars = rows + kStages * 2 * BQ * sizeof(float);
  static constexpr size_t bytes = bars + 8 * (2 * kStages + 1) + hop::kAtomBytes;
  static_assert(D == 64 || D == 128, "the Hopper dk/dv covers D 64, 128");
  static_assert(bytes <= kMaxSmem, "dkv tiles exceed shared memory");
};

template <int D>
__global__ void __launch_bounds__(hop::kThreads, 1)
    flash_dkv_hopper(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     const __grid_constant__ CUtensorMap tm_do,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, int tq, int tk, int causal) {
  using C = HopDkv<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = hop::align_atom(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::bars);
  uint64_t* empty = full + C::kStages;
  uint64_t* kvbar = empty + C::kStages;

  const int bh = blockIdx.x;
  // Early k blocks see the most causal q blocks: natural order runs the
  // heaviest first, over all heads.
  const int k0 = blockIdx.y * C::BK;
  const int nq = (tq + C::BQ - 1) / C::BQ;
  const int qstart = causal ? k0 / C::BQ : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      hop::mbar_init(&full[s], 1 + 32);  // the TMA's bytes + warp 0's rows
      hop::mbar_init(&empty[s], hop::kWarps);
    }
    hop::mbar_init(kvbar, 1);
    hop::fence_barrier_init();
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // Warp 0 loads the j-th q block of the loop into stage j % kStages: the
  // first kStages blocks at once, each later one as soon as both
  // warpgroups have released the block kStages before it.  q and do by TMA
  // from lane 0, the lse and delta rows by cp.async from every lane (rows
  // past tq read as 0: their q and do rows are TMA zeros, and the mask
  // drops them).
  const float* lg = lse + static_cast<size_t>(bh) * tq;
  const float* dg = delta + static_cast<size_t>(bh) * tq;
  auto load_q = [&](int j) {
    const int s = j % C::kStages;
    const int qb = qstart + j;
    hop::mbar_wait(&empty[s], ((j / C::kStages) & 1) ^ 1);
    if (lane == 0) {
      hop::mbar_expect_tx(&full[s], 2 * C::kQBytes);
      unsigned char* qs = smem + C::qdo + s * 2 * C::kQBytes;
      for (int b = 0; b < C::kBoxes; ++b) {
        hop::tma_load(qs + b * C::kBoxQ, &tm_q, &full[s], b * 64, qb * C::BQ,
                      bh);
        hop::tma_load(qs + C::kQBytes + b * C::kBoxQ, &tm_do, &full[s],
                      b * 64, qb * C::BQ, bh);
      }
    }
    float* rows = reinterpret_cast<float*>(smem + C::rows) + s * 2 * C::BQ;
    for (int c = lane; c < C::BQ; c += 32) {
      const int qi = qb * C::BQ + c;
      const uint32_t n = qi < tq ? 4 : 0;
      hop::cp_async_4(rows + c, lg + (n ? qi : 0), n);
      hop::cp_async_4(rows + C::BQ + c, dg + (n ? qi : 0), n);
    }
    hop::cp_async_arrive(&full[s]);
  };
  const int nblocks = nq - qstart;
  if (warp == 0) {
    if (lane == 0) {
      hop::mbar_expect_tx(kvbar, 2 * C::kKBytes);
      for (int b = 0; b < C::kBoxes; ++b) {
        hop::tma_load(smem + C::k + b * C::kBoxK, &tm_k, kvbar, b * 64, k0, bh);
        hop::tma_load(smem + C::v + b * C::kBoxK, &tm_v, kvbar, b * 64, k0, bh);
      }
    }
    for (int j = 0; j < C::kStages && j < nblocks; ++j) load_q(j);
  }

  // Warpgroup g owns k rows [k0 + 64g, k0 + 64g + 64).  In the m64nNk16
  // accumulator layout each thread holds rows r0 and r0 + 8, columns
  // 8j + cq and 8j + cq + 1 of every 8-column slice j.
  const int g = warp / 4;
  const int r0 = (warp % 4) * 16 + lane / 4;
  const int cq = 2 * (lane % 4);
  const int kw = k0 + 64 * g;
  const int row0 = kw + r0, row1 = row0 + 8;
  const uint32_t k_addr = hop::smem_u32(smem + C::k) + 64 * g * hop::kRowBytes;
  const uint32_t v_addr = hop::smem_u32(smem + C::v) + 64 * g * hop::kRowBytes;

  float dka[D / 2], dva[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) {
    dka[i] = 0.f;
    dva[i] = 0.f;
  }
  hop::mbar_wait(kvbar, 0);

  // The i-th block's stage is free once this warp's products that read
  // it are done; warp 0 then refills it kStages blocks ahead.
  auto release = [&](int i) {
    __syncwarp();
    if (lane == 0) hop::mbar_arrive(&empty[i % C::kStages]);
    if (warp == 0 && i + C::kStages < nblocks) load_q(i + C::kStages);
  };
  for (int i = 0; i < nblocks; ++i) {
    const int s = i % C::kStages;
    const int q0 = (qstart + i) * C::BQ;
    hop::mbar_wait(&full[s], (i / C::kStages) & 1);
    if (causal && q0 + C::BQ - 1 < kw) {
      // Every q of this block is before every k of this warpgroup.
      release(i);
      continue;
    }
    const uint32_t q_addr = hop::smem_u32(smem + C::qdo + s * 2 * C::kQBytes);
    const uint32_t do_addr = q_addr + C::kQBytes;
    const float* lse_s = reinterpret_cast<const float*>(smem + C::rows) + s * 2 * C::BQ;
    const float* dl_s = lse_s + C::BQ;

    // sᵀ = k·qᵀ and dpᵀ = v·doᵀ over D in steps of 16, K-major.
    float st[C::BQ / 2], dpt[C::BQ / 2];
    hop::wgmma_fence();
#pragma unroll
    for (int t = 0; t < D / 16; ++t) {
      const uint32_t kcol = (t / 4) * C::kBoxK + (t % 4) * 32;
      const uint32_t qcol = (t / 4) * C::kBoxQ + (t % 4) * 32;
      const uint64_t a = hop::desc_sw128(k_addr + kcol, 16, 1024);
      const uint64_t b = hop::desc_sw128(q_addr + qcol, 16, 1024);
      if (t == 0) {
        hop::wgmma_ss_first(st, a, b);
      } else {
        hop::wgmma_ss(st, a, b);
      }
    }
#pragma unroll
    for (int t = 0; t < D / 16; ++t) {
      const uint32_t kcol = (t / 4) * C::kBoxK + (t % 4) * 32;
      const uint32_t qcol = (t / 4) * C::kBoxQ + (t % 4) * 32;
      const uint64_t a = hop::desc_sw128(v_addr + kcol, 16, 1024);
      const uint64_t b = hop::desc_sw128(do_addr + qcol, 16, 1024);
      if (t == 0) {
        hop::wgmma_ss_first(dpt, a, b);
      } else {
        hop::wgmma_ss(dpt, a, b);
      }
    }
    hop::wgmma_commit();
    hop::wgmma_wait<0>();
    hop::fence_regs(st);
    hop::fence_regs(dpt);

    if ((causal && q0 < kw + 63) || kw + 64 > tk || q0 + C::BQ > tq) {
#pragma unroll
      for (int j = 0; j < C::BQ / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int qc = q0 + 8 * j + cq + e;
          if (masked_out(qc, row0, tq, tk, causal)) st[4 * j + e] = kNeg;
          if (masked_out(qc, row1, tq, tk, causal)) st[4 * j + 2 + e] = kNeg;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < C::BQ / 8; ++j) {
      const float2 l2 = *reinterpret_cast<const float2*>(lse_s + 8 * j + cq);
      const float2 d2 = *reinterpret_cast<const float2*>(dl_s + 8 * j + cq);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float lv = e ? l2.y : l2.x, dl = e ? d2.y : d2.x;
        const float p0 = hop::exp2_approx((st[4 * j + e] - lv) * hop::kLog2e);
        const float p1 =
            hop::exp2_approx((st[4 * j + 2 + e] - lv) * hop::kLog2e);
        st[4 * j + e] = p0;
        st[4 * j + 2 + e] = p1;
        dpt[4 * j + e] = p0 * (dpt[4 * j + e] - dl);
        dpt[4 * j + 2 + e] = p1 * (dpt[4 * j + 2 + e] - dl);
      }
    }

    // dv += pᵀ·do and dk += dsᵀ·q over the q block in steps of 16 rows:
    // pᵀ and dsᵀ from registers, do and q MN-major.
    uint32_t pa[C::BQ / 4], dsa[C::BQ / 4];
    hop::acc_to_a(st, pa);
    hop::acc_to_a(dpt, dsa);
    hop::wgmma_fence();
#pragma unroll
    for (int t = 0; t < C::BQ / 16; ++t) {
      const uint32_t row = t * 16 * hop::kRowBytes;
      const uint64_t b_do = hop::desc_sw128(do_addr + row, C::kBoxQ, 1024);
      const uint64_t b_q = hop::desc_sw128(q_addr + row, C::kBoxQ, 1024);
      hop::wgmma_rs(dva, pa[4 * t], pa[4 * t + 1], pa[4 * t + 2],
                    pa[4 * t + 3], b_do);
      hop::wgmma_rs(dka, dsa[4 * t], dsa[4 * t + 1], dsa[4 * t + 2],
                    dsa[4 * t + 3], b_q);
    }
    hop::wgmma_commit();
    hop::wgmma_wait<0>();
    hop::fence_regs(dva);
    hop::fence_regs(dka);
    release(i);
  }

  bf16* dkg = dk + static_cast<size_t>(bh) * tk * D;
  bf16* dvg = dv + static_cast<size_t>(bh) * tk * D;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = h ? row1 : row0;
    if (row < tk) {
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const size_t at = static_cast<size_t>(row) * D + 8 * j + cq;
        *reinterpret_cast<uint32_t*>(dkg + at) =
            hop::pack_bf16(dka[4 * j + 2 * h], dka[4 * j + 2 * h + 1]);
        *reinterpret_cast<uint32_t*>(dvg + at) =
            hop::pack_bf16(dva[4 * j + 2 * h], dva[4 * j + 2 * h + 1]);
      }
    }
  }
}

template <int D>
int launch_dkv_hopper(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dk, void* dv, int bh, int tq, int tk, int causal,
                      cudaStream_t stream) {
  using C = HopDkv<D>;
  // The maps hold the tensors' addresses, so they are made on every call.
  CUtensorMap mq, mk, mv, mdo;
  if (!hop::make_map(&mq, q, D, tq, bh, C::BQ) ||
      !hop::make_map(&mk, k, D, tk, bh, C::BK) ||
      !hop::make_map(&mv, v, D, tk, bh, C::BK) ||
      !hop::make_map(&mdo, dout, D, tq, bh, C::BQ)) {
    return MVT_TMA_REFUSED;
  }
  auto kernel = flash_dkv_hopper<D>;
  static bool smem_set = false;
  cudaError_t err = allow_smem(kernel, C::bytes, &smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(bh, (tk + C::BK - 1) / C::BK);
  kernel<<<grid, hop::kThreads, C::bytes, stream>>>(
      mq, mk, mv, mdo, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), tq, tk, causal);
  return static_cast<int>(cudaGetLastError());
}

// The design is fixed by (dtype, D) at compile time: bf16 at D 64 and 128
// runs the Hopper design above; the rest runs the first port's kernel,
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
    case 64:
      if constexpr (f32) return launch_dkv<T, 64, 64, 64>(q, k, v, dout, lse, delta, dk, dv, bh, tq, tk, causal, s);
      else return launch_dkv_hopper<64>(q, k, v, dout, lse, delta, dk, dv, bh, tq, tk, causal, s);
    case 128:
      if constexpr (f32) return launch_dkv<T, 128, 32, 64>(q, k, v, dout, lse, delta, dk, dv, bh, tq, tk, causal, s);
      else return launch_dkv_hopper<128>(q, k, v, dout, lse, delta, dk, dv, bh, tq, tk, causal, s);
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
