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
// by memory, so the bound is the tensor-core rate; at head dim 32 a score
// costs 4·32 flops and one exp, and the exp unit (16 a clock an SM, a
// 256th of the bf16 tensor rate) is the tighter bound in bf16.  Two
// designs, chosen at compile time by (dtype, D) in fwd_for_dim:
//
// * bf16 at D 32, 64, 128 and 256 (flash_fwd_hopper): the tensor cores
//   are fed without shared-memory round trips.  One block per (bh,
//   128-row q tile) of two consumer warpgroups and a producer warp
//   (hopper.cuh; at D 256 warp 0 loads instead).  TMA loads bring the q
//   tile once, then k and v tiles into a ring of kStages stages guarded
//   by full and empty mbarriers.  Each consumer warpgroup owns 64 q rows:
//   s = q·kᵀ by wgmma from shared memory into registers, the softmax in
//   registers (row max and sum across the 4 lanes that share a row), p
//   rounded to bf16 in registers and fed back as the register A operand
//   of o += p·v (v MN-major), o in registers for the whole loop.  The two
//   warpgroups run independently, so one's softmax overlaps the other's
//   products.  Tile sizes, swizzle and producer by D: HopFwd.
// * float32 at D 32, 64, 128 and 256 (flash_fwd_hopper_f32): the bf16
//   design's block with k and v as three bf16 planes each and every
//   product as six wgmma products (hopper_f32.cuh), bound by six times the
//   flops at the bf16 rate (0.2086 ms at [8, 16, 2048, 32], where the exp
//   bound is 0.0695).  q is planes too at D 32, 64 and 128; at D 256 it
//   stays float32 and each thread splits its fragment in registers.
//   Tiles: F32Fwd.
#include "flash_common.cuh"
#include "hopper_f32.cuh"

namespace mvt {

// ------------------------------------------------ bf16 Hopper design
// One block per (bh, 128-row q tile): two consumer warpgroups of 64 q rows
// and, but at D 256, a producer warp.  Tiles by head dim (Box<D> in
// hopper.cuh):
// * D 64, 128: 128-row k blocks in three stages, 128-byte swizzle.
// * D 32: 64-byte rows with the 64-byte swizzle, and 64-row k blocks.
//   The exp unit, not the tensor cores, bounds this dim (4·32 flops a
//   score); half the k block halves s and p in registers (83 a thread
//   against 134 at 128 rows), so two blocks share an SM and four
//   warpgroups keep the exp unit busier: faster on the card than 128-row
//   blocks, and than 32-row blocks three to an SM (PERF.md).
// * D 256: q alone is 64 KB, so 64-row k blocks in two stages (q + 2 x (k
//   + v) = 192 KB).  o is 128 registers a thread, run as two 128-column
//   halves.  Beside a producer, ptxas budgets every thread at 168
//   registers, whatever setmaxnreg asks (with a producer warpgroup lending
//   its registers this design spilled 412 bytes), so here, as in dq and
//   dk/dv, warp 0 issues the loads and every thread may hold 255.
template <int D>
struct HopFwd {
  using B = hop::Box<D>;
  static constexpr int BQ = 128;
  static constexpr int BK = D == 256 || D == 32 ? 64 : 128;
  static constexpr int kStages = D == 256 ? 2 : 3;
  static constexpr int kNC = D > 128 ? 128 : D;  // o's columns a product
  static constexpr int kChunks = D / kNC;
  static constexpr int kProducers = D == 256 ? 0 : 32;  // a warp, or none
  static constexpr int kAllThreads = hop::kThreads + kProducers;
  static constexpr uint32_t kBoxQ = BQ * B::kRow;  // one box of columns
  static constexpr uint32_t kBoxK = BK * B::kRow;
  static constexpr uint32_t kQBytes = B::kBoxes * kBoxQ;
  static constexpr uint32_t kKBytes = B::kBoxes * kBoxK;
  static constexpr size_t q = 0;
  static constexpr size_t kv = kQBytes;  // stage s: k, then v
  static constexpr size_t bars = kv + kStages * 2 * kKBytes;
  static constexpr size_t bytes = bars + 8 * (2 * kStages + 1) + hop::kAtomBytes;
  static_assert(bytes <= kMaxSmem, "forward tiles exceed shared memory");
};

template <int D>
__global__ void __launch_bounds__(HopFwd<D>::kAllThreads, 1)
    flash_fwd_hopper(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     bf16* __restrict__ o, float* __restrict__ lse, int tq,
                     int tk, int causal) {
  using C = HopFwd<D>;
  using B = typename C::B;
  constexpr int BK = C::BK;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = hop::align_atom(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::bars);
  uint64_t* empty = full + C::kStages;
  uint64_t* qbar = empty + C::kStages;

  const int bh = blockIdx.x;
  // Heaviest causal q tiles (the last ones) start first, over all heads.
  const int q0 = (gridDim.y - 1 - blockIdx.y) * C::BQ;
  const int nk = (tk + BK - 1) / BK;
  const int kend = causal ? min(nk, (q0 + C::BQ - 1) / BK + 1) : nk;

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
  // One thread loads the q tile, then k block j into stage j % kStages
  // once both warpgroups have released the block kStages before it: the
  // producer warp all of them, or without one warp 0 the first kStages
  // blocks at once and each later one as it releases a stage.
  auto load_kv = [&](int j) {
    const int s = j % C::kStages;
    hop::mbar_wait(&empty[s], ((j / C::kStages) & 1) ^ 1);
    if (lane == 0) {
      hop::mbar_expect_tx(&full[s], 2 * C::kKBytes);
      unsigned char* ks = smem + C::kv + s * 2 * C::kKBytes;
      for (int b = 0; b < B::kBoxes; ++b) {
        hop::tma_load(ks + b * C::kBoxK, &tm_k, &full[s], b * B::kCols,
                      j * BK, bh);
        hop::tma_load(ks + C::kKBytes + b * C::kBoxK, &tm_v, &full[s],
                      b * B::kCols, j * BK, bh);
      }
    }
    __syncwarp();
  };
  const int loader = C::kProducers ? hop::kWarps : 0;
  if (warp == loader) {
    if (lane == 0) {
      hop::mbar_expect_tx(qbar, C::kQBytes);
      for (int b = 0; b < B::kBoxes; ++b) {
        hop::tma_load(smem + C::q + b * C::kBoxQ, &tm_q, qbar, b * B::kCols,
                      q0, bh);
      }
    }
    __syncwarp();
    for (int j = 0; j < (C::kProducers ? kend : min(C::kStages, kend)); ++j) {
      load_kv(j);
    }
  }
  if (warp >= hop::kWarps) return;

  // Warpgroup g owns q rows [q0 + 64g, q0 + 64g + 64).  In the m64nNk16
  // accumulator layout each thread holds rows r0 and r0 + 8, columns
  // 8j + cq and 8j + cq + 1 of every 8-column slice j.
  const int g = warp / 4;
  const int r0 = (warp % 4) * 16 + lane / 4;
  const int cq = 2 * (lane % 4);
  const int qw = q0 + 64 * g;
  const int row0 = qw + r0, row1 = row0 + 8;
  const uint32_t q_addr = hop::smem_u32(smem + C::q) + 64 * g * B::kRow;

  float acc[C::kChunks][C::kNC / 2];  // o, unnormalised, by column half
  float sc[BK / 2];                   // s, then p, of the current k block
  uint32_t pa[BK / 4];                // p as bf16 A fragments
#pragma unroll
  for (int c = 0; c < C::kChunks; ++c) {
#pragma unroll
    for (int i = 0; i < C::kNC / 2; ++i) acc[c][i] = 0.f;
  }
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
      const uint32_t at = (x % B::kSteps) * 32;
      const uint64_t da = hop::desc_box<D>(
          q_addr + (x / B::kSteps) * C::kBoxQ + at, 16);
      const uint64_t db = hop::desc_box<D>(
          k_addr + (x / B::kSteps) * C::kBoxK + at, 16);
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
    const int k0 = kb * BK;
    if ((causal && k0 + BK - 1 > qw) || k0 + BK > tk) {
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
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
    for (int j = 0; j < BK / 8; ++j) {
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
    for (int j = 0; j < BK / 8; ++j) {
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
    for (int c = 0; c < C::kChunks; ++c) {
#pragma unroll
      for (int j = 0; j < C::kNC / 8; ++j) {
        acc[c][4 * j] *= corr0;
        acc[c][4 * j + 1] *= corr0;
        acc[c][4 * j + 2] *= corr1;
        acc[c][4 * j + 3] *= corr1;
      }
    }

    // o += p·v over the k block in steps of 16 keys: p from registers, v
    // MN-major (the next 16 keys are 16 box rows further), one product
    // per column half.
    hop::acc_to_a(sc, pa);
    hop::wgmma_fence();
#pragma unroll
    for (int c = 0; c < C::kChunks; ++c) {
      const uint32_t half = v_addr + c * (C::kNC / B::kCols) * C::kBoxK;
#pragma unroll
      for (int x = 0; x < BK / 16; ++x) {
        hop::wgmma_rs(acc[c], pa[4 * x], pa[4 * x + 1], pa[4 * x + 2],
                      pa[4 * x + 3],
                      hop::desc_box<D>(half + x * 16 * B::kRow, C::kBoxK));
      }
    }
    hop::wgmma_commit();
    hop::wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < C::kChunks; ++c) hop::fence_regs(acc[c]);

    // The stage is free once this warp's products that read it are done.
    __syncwarp();
    if (lane == 0) hop::mbar_arrive(&empty[s]);
    if (C::kProducers == 0 && warp == 0 && kb + C::kStages < kend) {
      load_kv(kb + C::kStages);
    }
  }

  l0 = group_sum<4>(l0);
  l1 = group_sum<4>(l1);
  const float lc0 = fmaxf(l0, 1e-30f), lc1 = fmaxf(l1, 1e-30f);
  bf16* og = o + static_cast<size_t>(bh) * tq * D;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = h ? row1 : row0;
    const float lc = h ? lc1 : lc0;
    if (row >= tq) continue;
#pragma unroll
    for (int c = 0; c < C::kChunks; ++c) {
#pragma unroll
      for (int j = 0; j < C::kNC / 8; ++j) {
        const int col = c * C::kNC + 8 * j + cq;
        *reinterpret_cast<uint32_t*>(og + static_cast<size_t>(row) * D +
                                     col) =
            hop::pack_bf16(acc[c][4 * j + 2 * h] / lc,
                           acc[c][4 * j + 2 * h + 1] / lc);
      }
    }
    if (lane % 4 == 0) {
      lse[static_cast<size_t>(bh) * tq + row] = (h ? m1 : m0) + logf(lc);
    }
  }
}

template <int D>
int launch_fwd_hopper(const void* q, const void* k, const void* v, void* o,
                      void* lse, int bh, int tq, int tk, int causal,
                      cudaStream_t stream) {
  using C = HopFwd<D>;
  constexpr int kCols = C::B::kCols;
  // The maps hold the tensors' addresses, so they are made on every call.
  CUtensorMap mq, mk, mv;
  if (!hop::make_map(&mq, q, D, tq, bh, C::BQ, kCols) ||
      !hop::make_map(&mk, k, D, tk, bh, C::BK, kCols) ||
      !hop::make_map(&mv, v, D, tk, bh, C::BK, kCols)) {
    return MVT_TMA_REFUSED;
  }
  auto kernel = flash_fwd_hopper<D>;
  static bool smem_set = false;
  cudaError_t err = allow_smem(kernel, C::bytes, &smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(bh, (tq + C::BQ - 1) / C::BQ);
  kernel<<<grid, C::kAllThreads, C::bytes, stream>>>(
      mq, mk, mv, static_cast<bf16*>(o), static_cast<float*>(lse), tq, tk,
      causal);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------- float32 Hopper design
// k and v split into three bf16 planes before the launch (Planes, in the
// wrapper's scratch), every product six wgmma products.  The bf16
// design's block: one 128-row q tile a block, each consumer warpgroup
// owning 64 of its rows, k's and v's planes streamed through a ring of
// stages that both warpgroups share.  Per k block, s = q·kᵀ, the online
// softmax on float32 s in registers with expf as the plain version takes
// it, p split into three register planes (acc_to_a3) as o += p·v's A
// operand (planes_rs, v MN-major); o stays float32 in registers for the
// whole loop.  Planes take 6 bytes an element, so the k blocks shrink:
// * D 128: q's planes too (96 KB, planes_ss), 32-key blocks of 48 KB (k
//   and v) in two stages; s an m64n32 product, o 64 registers a thread.
// * D 64: q's planes (48 KB), 64-key blocks of 48 KB in three stages.
// * D 32: a row of planes is 64 bytes (the 64-byte swizzle), so q's
//   planes take 24 KB and a stage of 64 keys 24 KB: three stages, 96 KB.
//   o is 16 registers a thread, so hi·hi of o += p·v sums in an
//   accumulator of its own (kHiApart): the tensor cores drop the bits
//   below a sum's last place, and o sums all of T in one warpgroup's
//   registers, unflushed (o 7.0x the plain version's error against
//   float64 at T 8,192 with one accumulator, 2.3x with two, at no
//   measured cost; hi·hi apart in the score product too bought nothing
//   and cost 2-3%).  One block an SM: two, as the bf16 D 32 forward runs,
//   cap every thread at 96 registers beside a producer warp (five warps
//   on one of the SM's four register files) or 128 without one, and
//   spilled in every variant tried (PERF.md).
//   At D 32, 64 and 128 a producer warp loads q once and k and v stage
//   by stage.
// * D 256 (kRowsF32): q's planes would take 192 KB, so q stays float32,
//   a 64-row F32Tile a warpgroup (128 KB), and each thread splits its
//   fragment in registers at every 16-column step (f32_rs_products, k
//   K-major).  o takes 128 registers a thread, so warp 0 loads and no
//   producer caps the registers (hopper.cuh).  32-key blocks in one stage
//   of 96 KB (m64n32 score products; 224 KB in all).  k and v have a
//   barrier pair each: after its o += p·v, warp 0 refills k once both
//   warpgroups' scores are done, then v once both o += p·v are, so k's
//   load overlaps the other warpgroup's last products and the next scores
//   start before v lands.  (Refilling v right after the scores, or from
//   the other warpgroup, was slower on the card: PERF.md.)
template <int D>
struct F32Fwd {
  using B = hop::Box<D>;
  static constexpr bool kRowsF32 = D == 256;
  static constexpr bool kHiApart = D == 32;  // o's hi·hi apart
  static constexpr int BQ = 128, BK = D <= 64 ? 64 : 32;
  static constexpr int kStages = D <= 64 ? 3 : D == 128 ? 2 : 1;
  static constexpr int kProducers = kRowsF32 ? 0 : 32;  // a warp, or none
  static constexpr int kAllThreads = hop::kThreads + kProducers;
  using Tile = hop::F32Tile<D, 64>;  // kRowsF32: one warpgroup's q rows
  static constexpr uint32_t kBoxQ = BQ * B::kRow;  // one box, one plane
  static constexpr uint32_t kBoxK = BK * B::kRow;
  static constexpr uint32_t kQPlane = B::kBoxes * kBoxQ;
  static constexpr uint32_t kKPlane = B::kBoxes * kBoxK;
  // q's three planes, or its float32 rows.
  static constexpr uint32_t kQBytes = kRowsF32 ? 2 * Tile::kBytes : 3 * kQPlane;
  static constexpr uint32_t kKBytes = 3 * kKPlane;
  static constexpr size_t q = 0;
  static constexpr size_t kv = kQBytes;  // stage s: k's planes, then v's
  static constexpr size_t bars = kv + kStages * 2 * kKBytes;
  // full and empty a stage (kRowsF32: of k, then as many of v), q's.
  static constexpr int kBars = (kRowsF32 ? 4 : 2) * kStages + 1;
  static constexpr size_t bytes = bars + 8 * kBars + hop::kAtomBytes;
  static_assert(D == 32 || D == 64 || D == 128 || D == 256,
                "float32 D 32, 64, 128, 256");
  static_assert(bytes <= kMaxSmem, "forward tiles exceed shared memory");
};

template <int D>
__global__ void __launch_bounds__(F32Fwd<D>::kAllThreads, 1)
    flash_fwd_hopper_f32(const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v,
                         float* __restrict__ o, float* __restrict__ lse,
                         int tq, int tk, int causal) {
  using C = F32Fwd<D>;
  using B = typename C::B;
  constexpr int BK = C::BK, S = C::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = hop::align_atom(smem_raw);
  // full[s] and empty[s] guard stage s (k and v, or k alone at kRowsF32,
  // where vfull[s] and vempty[s] guard v).
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::bars);
  uint64_t* empty = full + S;
  uint64_t* qbar = empty + S;
  uint64_t* vfull = qbar + 1;
  uint64_t* vempty = vfull + S;

  // Plane p of head bh is head bh + p·nbh of the k and v maps.
  const int bh = blockIdx.x, nbh = gridDim.x;
  // Heaviest causal q tiles (the last ones) start first, over all heads.
  const int q0 = (gridDim.y - 1 - blockIdx.y) * C::BQ;
  const int nk = (tk + BK - 1) / BK;
  const int kend = causal ? min(nk, (q0 + C::BQ - 1) / BK + 1) : nk;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      hop::mbar_init(&full[s], 1);
      hop::mbar_init(&empty[s], hop::kWarps);
      if (C::kRowsF32) {
        hop::mbar_init(&vfull[s], 1);
        hop::mbar_init(&vempty[s], hop::kWarps);
      }
    }
    hop::mbar_init(qbar, 1);
    hop::fence_barrier_init();
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // k block j's planes (with_k) and v block j's (with_v) into stage j % S
  // once every consumer warp has released the block S before it: counted
  // on full[s], released on empty[s], but v on vfull[s] and vempty[s] at
  // kRowsF32, where k and v load apart.  Lane 0 starts the copies; the
  // whole warp waits.
  auto load = [&](int j, bool with_k, bool with_v) {
    const int s = j % S;
    uint64_t* fb = with_k ? &full[s] : &vfull[s];
    hop::mbar_wait(with_k ? &empty[s] : &vempty[s], ((j / S) & 1) ^ 1);
    if (lane == 0) {
      hop::mbar_expect_tx(fb, (with_k + with_v) * C::kKBytes);
      unsigned char* ks = smem + C::kv + s * 2 * C::kKBytes;
      for (int p = 0; p < 3; ++p) {
        for (int b = 0; b < B::kBoxes; ++b) {
          const uint32_t at = p * C::kKPlane + b * C::kBoxK;
          if (with_k) {
            hop::tma_load(ks + at, &tm_k, fb, b * B::kCols, j * BK,
                          bh + p * nbh);
          }
          if (with_v) {
            hop::tma_load(ks + C::kKBytes + at, &tm_v, fb, b * B::kCols,
                          j * BK, bh + p * nbh);
          }
        }
      }
    }
    __syncwarp();
  };
  if constexpr (C::kRowsF32) {
    // Warp 0: q's float32 rows, then the first S blocks of k and of v.
    if (warp == 0) {
      if (lane == 0) {
        hop::mbar_expect_tx(qbar, C::kQBytes);
        for (int g = 0; g < 2; ++g) {
          hop::tma_load_f32<D, 64>(smem + C::q + g * C::Tile::kBytes, &tm_q,
                                   qbar, q0 + 64 * g, bh);
        }
      }
      __syncwarp();
      for (int j = 0; j < S && j < kend; ++j) {
        load(j, true, false);
        load(j, false, true);
      }
    }
  } else {
    // The producer: q's planes once, then k's and v's stage by stage.
    if (warp == hop::kWarps) {
      if (lane == 0) {
        hop::mbar_expect_tx(qbar, C::kQBytes);
        for (int p = 0; p < 3; ++p) {
          for (int b = 0; b < B::kBoxes; ++b) {
            hop::tma_load(smem + C::q + p * C::kQPlane + b * C::kBoxQ, &tm_q,
                          qbar, b * B::kCols, q0, bh + p * nbh);
          }
        }
      }
      __syncwarp();
      for (int j = 0; j < kend; ++j) load(j, true, true);
      return;
    }
  }

  // Warpgroup g owns q rows [q0 + 64g, q0 + 64g + 64): rows r0 and r0 + 8
  // of each thread in the m64nNk16 accumulator layout.
  const int g = warp / 4;
  const int r0 = (warp % 4) * 16 + lane / 4;
  const int cq = 2 * (lane % 4);
  const int qw = q0 + 64 * g;
  const int row0 = qw + r0, row1 = row0 + 8;
  const uint32_t q_addr = hop::smem_u32(smem + C::q) + 64 * g * B::kRow;
  const float* q_rows =
      reinterpret_cast<const float*>(smem + C::q + g * C::Tile::kBytes);

  // o, unnormalised (with kHiApart its hi·hi products in hacc).
  float acc[D / 2], hacc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) {
    acc[i] = 0.f;
    hacc[i] = 0.f;
  }
  float m0 = kNeg, m1 = kNeg, l0 = 0.f, l1 = 0.f;
  hop::mbar_wait(qbar, 0);

  for (int kb = 0; kb < kend; ++kb) {
    const int s = kb % S;
    const uint32_t k_addr = hop::smem_u32(smem + C::kv + s * 2 * C::kKBytes);
    const uint32_t v_addr = k_addr + C::kKBytes;
    hop::mbar_wait(&full[s], (kb / S) & 1);

    float s1[1][BK / 2];
    float (&sc)[BK / 2] = s1[0];  // s, then p, of the current k block
    if constexpr (C::kRowsF32) {
      // q's fragments split in registers at every step; then k's stage is
      // free.
      const float* const rows[1] = {q_rows};
      const uint32_t kb_addr[1] = {k_addr};
      hop::f32_rs_products<D>(s1, rows, r0, cq, kb_addr, C::kKPlane,
                              C::kBoxK);
      __syncwarp();
      if (lane == 0) hop::mbar_arrive(&empty[s]);
    } else {
      hop::wgmma_fence();
      hop::planes_ss<D>(sc, q_addr, C::kQPlane, C::kBoxQ, k_addr,
                        C::kKPlane, C::kBoxK);
      hop::wgmma_commit();
      hop::wgmma_wait<0>();
      hop::fence_regs(sc);
    }

    // The online softmax in registers, as the bf16 design runs it but
    // with expf: l stays a per-thread partial sum until the epilogue.
    const int k0 = kb * BK;
    if ((causal && k0 + BK - 1 > qw) || k0 + BK > tk) {
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
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
    for (int j = 0; j < BK / 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
    }
    mx0 = group_max<4>(mx0);
    mx1 = group_max<4>(mx1);
    const float corr0 = expf(m0 - mx0), corr1 = expf(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        sc[4 * j + e] = expf(sc[4 * j + e] - mx0);
        sc[4 * j + 2 + e] = expf(sc[4 * j + 2 + e] - mx1);
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
      if constexpr (C::kHiApart) {
        hacc[4 * j] *= corr0;
        hacc[4 * j + 1] *= corr0;
        hacc[4 * j + 2] *= corr1;
        hacc[4 * j + 3] *= corr1;
      }
    }

    // o += p·v: p's planes from registers, v's MN-major.
    uint32_t pa[3][BK / 4];
    hop::acc_to_a3(sc, pa);
    if constexpr (C::kRowsF32) hop::mbar_wait(&vfull[s], (kb / S) & 1);
    hop::wgmma_fence();
    if constexpr (C::kHiApart) {
      hop::planes_rs<D>(acc, hacc, pa, v_addr, C::kKPlane, C::kBoxK);
    } else {
      hop::planes_rs<D>(acc, pa, v_addr, C::kKPlane, C::kBoxK);
    }
    hop::wgmma_commit();
    hop::wgmma_wait<0>();
    hop::fence_regs(acc);
    if constexpr (C::kHiApart) hop::fence_regs(hacc);

    // The stage is free once this warp's products that read it are done;
    // at kRowsF32 warp 0 then refills it S blocks ahead, k, then v.
    __syncwarp();
    if (lane == 0) hop::mbar_arrive(C::kRowsF32 ? &vempty[s] : &empty[s]);
    if constexpr (C::kRowsF32) {
      if (warp == 0 && kb + S < kend) {
        load(kb + S, true, false);
        load(kb + S, false, true);
      }
    }
  }

  if constexpr (C::kHiApart) {
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] += hacc[i];
  }
  l0 = group_sum<4>(l0);
  l1 = group_sum<4>(l1);
  const float lc0 = fmaxf(l0, 1e-30f), lc1 = fmaxf(l1, 1e-30f);
  float* og = o + static_cast<size_t>(bh) * tq * D;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = h ? row1 : row0;
    const float lc = h ? lc1 : lc0;
    if (row >= tq) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<float2*>(og + static_cast<size_t>(row) * D + 8 * j +
                                 cq) =
          make_float2(acc[4 * j + 2 * h] / lc, acc[4 * j + 2 * h + 1] / lc);
    }
    if (lane % 4 == 0) {
      lse[static_cast<size_t>(bh) * tq + row] = (h ? m1 : m0) + logf(lc);
    }
  }
}

// The float32 launch's planes (q's too but at kRowsF32, where q's
// float32 rows get a map of their own) split on the stream into the
// scratch, and the maps over them in m.
template <int D>
int split_fwd_f32(Planes& m, const void* q, const void* k, const void* v,
                  void* planes, size_t planes_n, int bh, int tq, int tk,
                  cudaStream_t stream) {
  using C = F32Fwd<D>;
  if constexpr (C::kRowsF32) {
    const int rc = m.split(nullptr, k, v, nullptr, planes, planes_n, D, bh,
                           tq, tk, C::BQ, C::BK, stream);
    if (rc != 0) return rc;
    return make_map_f32(&m.q, q, D, tq, bh, 64) ? 0 : MVT_TMA_REFUSED;
  } else {
    return m.split(q, k, v, nullptr, planes, planes_n, D, bh, tq, tk, C::BQ,
                   C::BK, stream);
  }
}

template <int D>
int launch_fwd_f32(const void* q, const void* k, const void* v, void* o,
                   void* lse, void* planes, size_t planes_n, int bh, int tq,
                   int tk, int causal, cudaStream_t stream) {
  using C = F32Fwd<D>;
  Planes m;
  const int rc =
      split_fwd_f32<D>(m, q, k, v, planes, planes_n, bh, tq, tk, stream);
  if (rc != 0) return rc;
  auto kernel = flash_fwd_hopper_f32<D>;
  static bool smem_set = false;
  cudaError_t err = allow_smem(kernel, C::bytes, &smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(bh, (tq + C::BQ - 1) / C::BQ);
  kernel<<<grid, C::kAllThreads, C::bytes, stream>>>(
      m.q, m.k, m.v, static_cast<float*>(o), static_cast<float*>(lse), tq,
      tk, causal);
  return static_cast<int>(cudaGetLastError());
}

// The design is fixed by (dtype, D) at compile time: bf16 runs the Hopper
// design above at every D, float32 the plane design (q float32 at 256).
template <typename T>
int fwd_for_dim(int d, const void* q, const void* k, const void* v,
                void* o, void* lse, void* planes, size_t planes_n, int bh,
                int tq, int tk, int causal, cudaStream_t s) {
  if constexpr (std::is_same<T, float>::value) {
    switch (d) {
      case 32: return launch_fwd_f32<32>(q, k, v, o, lse, planes, planes_n, bh, tq, tk, causal, s);
      case 64: return launch_fwd_f32<64>(q, k, v, o, lse, planes, planes_n, bh, tq, tk, causal, s);
      case 128: return launch_fwd_f32<128>(q, k, v, o, lse, planes, planes_n, bh, tq, tk, causal, s);
      case 256: return launch_fwd_f32<256>(q, k, v, o, lse, planes, planes_n, bh, tq, tk, causal, s);
      default: return MVT_UNSUPPORTED;
    }
  } else {
    switch (d) {
      case 32: return launch_fwd_hopper<32>(q, k, v, o, lse, bh, tq, tk, causal, s);
      case 64: return launch_fwd_hopper<64>(q, k, v, o, lse, bh, tq, tk, causal, s);
      case 128: return launch_fwd_hopper<128>(q, k, v, o, lse, bh, tq, tk, causal, s);
      case 256: return launch_fwd_hopper<256>(q, k, v, o, lse, bh, tq, tk, causal, s);
      default: return MVT_UNSUPPORTED;
    }
  }
}

}  // namespace mvt

// q (pre-scaled), k, v: [bh, T, d]; o: [bh, tq, d]; lse: [bh, tq] float.
// planes: the float32 plane design's scratch, 3·bh·(tq + 2·tk)·d bf16 at
// D 32, 64 and 128, 6·bh·tk·d at D 256 (hopper_f32.cuh); null for a bf16
// launch.  planes_n: its size in bf16 elements (a smaller one than the
// launch needs: MVT_SCRATCH_SHORT).
extern "C" int mvt_flash_fwd(const void* q, const void* k, const void* v,
                             void* o, void* lse, void* planes,
                             size_t planes_n, int bh, int tq, int tk, int d,
                             int dtype, int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == MVT_DTYPE_F32) {
    return mvt::fwd_for_dim<float>(d, q, k, v, o, lse, planes, planes_n, bh,
                                   tq, tk, causal, s);
  }
  if (dtype == MVT_DTYPE_BF16) {
    return mvt::fwd_for_dim<__nv_bfloat16>(d, q, k, v, o, lse, planes,
                                           planes_n, bh, tq, tk, causal, s);
  }
  return MVT_UNSUPPORTED;
}

// The split of a float32 mvt_flash_fwd launch alone, on the same operands
// and scratch (dout unused), with no kernel after it: what the launch
// spends before its kernel starts, timed apart.
extern "C" int mvt_plane_split(const void* q, const void* k, const void* v,
                               const void* dout, void* planes,
                               size_t planes_n, int bh, int tq, int tk,
                               int d, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  mvt::Planes m;
  switch (d) {
    case 32: return mvt::split_fwd_f32<32>(m, q, k, v, planes, planes_n, bh, tq, tk, s);
    case 64: return mvt::split_fwd_f32<64>(m, q, k, v, planes, planes_n, bh, tq, tk, s);
    case 128: return mvt::split_fwd_f32<128>(m, q, k, v, planes, planes_n, bh, tq, tk, s);
    case 256: return mvt::split_fwd_f32<256>(m, q, k, v, planes, planes_n, bh, tq, tk, s);
    default: return MVT_UNSUPPORTED;
  }
}
