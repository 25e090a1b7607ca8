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
// tiles read, so tensor-core bound at the shapes the trainer uses (at
// head dim 32 the exp of each score costs more than its 6·32 flops); in
// float32 six bf16 products a product, so six times the flops at the
// bf16 rate (0.6257 ms at [4, 16, 2048, 128] and at [4, 8, 2048, 256],
// 0.3128 ms at [8, 16, 2048, 32], causal).  Two designs, chosen at compile
// time by (dtype, D) in dq_for_dim:
//
// * bf16 at every D (flash_dq_hopper): q-stationary, the forward's shape
//   with dk/dv's products, accumulators in registers (hopper.cuh).  Warp
//   0 loads q and do once by TMA, then k and v blocks into a ring of
//   kStages stages, refilling a stage once both warpgroups have released
//   it.  Per k block it forms s = q·kᵀ and dp = do·vᵀ by wgmma (both
//   operands K-major in shared memory), then p = exp(s - lse) and
//   ds = p (dp - delta) in registers from lse and delta held in
//   registers, rounds ds to bf16 and feeds it as wgmma's A operand of
//   dq += ds·k (k MN-major: the same bytes as s's K-major B).  The
//   accumulators need more registers than a ninth warp would leave, so
//   no producer warp (hopper.cuh).
//   - D 32, 64, 128 (dq_by_rows): one block of two warpgroups per (bh,
//     128-row q tile); each warpgroup owns 64 q rows, keeps their float32
//     dq in registers for the whole k loop, and feeds ds from registers.
//     No score tile is ever written to shared memory.  128-key blocks at
//     D 64 and 128; 64-key blocks at D 32 (HopDq).
//   - D 256 (dq_by_cols): dq of 64 rows would be 128 registers a thread
//     beside s and dp, and q and do of 128 rows leave no room for two k/v
//     stages, so one block per (bh, 64-row q tile) splits dq's columns
//     between the two warpgroups, each forming half the k block's ds and
//     sharing it through shared memory (HopDqCols).
// * float32 at every D (flash_dq_hopper_f32, hopper_f32.cuh): k and v
//   split into three bf16 planes (hi, mid, lo) by flash_split3, an
//   elementwise kernel that replaces no TPU kernel, into the wrapper's
//   scratch; every product runs as six bf16 wgmma products into float32
//   accumulators (a0b0 + a0b1 + a1b0 + a0b2 + a1b1 + a2b0; the terms left
//   out are of order 2^-24 of the product), ds split in registers as the
//   A operand of dq += ds·k.  Planes take 6 bytes an element, so at D 64,
//   128 and 256 one 64-row q tile is shared by both warpgroups, which
//   take every other k block from a ring of their own and sum their
//   partial dq once at the end (F32Dq).  At D 64 and 128 q and do are
//   planes too (192 KB of shared memory at D 128, 144 KB at D 64).  At D
//   256 their planes would take 192 KB alone, so they stay float32 (128
//   KB), and each thread splits its fragment of them in registers at
//   every 16-column step, as the register A of s = q·kᵀ and dp = do·vᵀ (k
//   and v K-major); 16-key blocks, 225 KB.  At D 32 a row of planes is 64
//   bytes, so the block keeps the bf16 design's 128 q rows, 64 a
//   warpgroup, as planes (144 KB with four 64-key stages), and hi·hi of
//   every product sums apart from the five smaller ones.
#include "flash_common.cuh"
#include "hopper.cuh"
#include "hopper_f32.cuh"

namespace mvt {

// ------------------------------------------------ bf16 Hopper design
// D 32, 64 and 128: one block of two warpgroups per (bh, 128-row q tile),
// each warpgroup owning 64 q rows with its dq in registers.  D 32 runs
// 64-byte box rows with the 64-byte swizzle and 64-key blocks: s and dp
// shrink to 32 registers a thread each, so two blocks share an SM, as in
// the D 32 forward.
template <int D>
struct HopDq {
  using B = hop::Box<D>;
  static constexpr int BQ = 128, BK = D == 32 ? 64 : 128;
  static constexpr uint32_t kBoxQ = BQ * B::kRow;  // one box of columns
  static constexpr uint32_t kBoxK = BK * B::kRow;
  static constexpr uint32_t kQBytes = B::kBoxes * kBoxQ;
  static constexpr uint32_t kKBytes = B::kBoxes * kBoxK;
  static constexpr size_t q = 0;
  static constexpr size_t dout = kQBytes;
  static constexpr size_t kv = 2 * kQBytes;  // stage s: k, then v
  // As many k/v stages as fit beside q and do, at most 4.
  static constexpr int kStages = D == 128 ? 2 : 4;
  static constexpr size_t bars = kv + kStages * 2 * kKBytes;
  static constexpr size_t bytes = bars + 8 * (2 * kStages + 1) + hop::kAtomBytes;
  static_assert(D <= 128, "D 256 splits columns: HopDqCols");
  static_assert(bytes <= kMaxSmem, "dq tiles exceed shared memory");
};

// D 256: both warpgroups share one block of 64 q rows and split dq's D
// columns (128 each: 64 registers).  Per 64-key block each warpgroup
// forms s and dp for half the block's keys, turns them into ds in
// registers and writes it, bf16 and swizzled, into shared memory, where
// both warpgroups read the whole [64, 64] tile as wgmma's A operand.  Two
// buffers of it, so one barrier a block keeps a buffer's writes after its
// last readers.  q 32 KB + do 32 KB + two stages of k and v (128 KB) + ds
// twice (16 KB) = 208 KB.
struct HopDqCols {
  using B = hop::Box<256>;
  static constexpr int D = 256, BQ = 64, BK = 64, kStages = 2;
  static constexpr int kHalf = D / 2;  // dq columns a warpgroup
  static constexpr int kKeys = BK / 2;  // s columns a warpgroup
  static constexpr uint32_t kBoxQ = BQ * B::kRow;
  static constexpr uint32_t kBoxK = BK * B::kRow;
  static constexpr uint32_t kQBytes = B::kBoxes * kBoxQ;
  static constexpr uint32_t kKBytes = B::kBoxes * kBoxK;
  static constexpr uint32_t kDsBytes = BQ * BK * 2;  // one [64, 64] bf16 box
  static constexpr size_t q = 0;
  static constexpr size_t dout = kQBytes;
  static constexpr size_t kv = 2 * kQBytes;  // stage s: k, then v
  static constexpr size_t ds = kv + kStages * 2 * kKBytes;  // ds x 2
  static constexpr size_t bars = ds + 2 * kDsBytes;
  static constexpr size_t bytes = bars + 8 * (2 * kStages + 1) + hop::kAtomBytes;
  static_assert(bytes <= kMaxSmem, "dq tiles exceed shared memory");
};

// The launch's layout for head dim D.
template <int D>
using HopDqFor =
    typename std::conditional<D == 256, HopDqCols, HopDq<D>>::type;

// A block's TMA loads: its barriers (full and empty a stage, then one for
// q and do) and warp 0's refill kv(j) of stage j % kStages with k block j,
// once both warpgroups have released the block kStages before it.
template <class C>
struct DqLoads {
  unsigned char* smem;
  uint64_t* full;
  uint64_t* empty;
  uint64_t* qbar;
  const CUtensorMap* tm_k;
  const CUtensorMap* tm_v;
  int bh, lane;

  __device__ __forceinline__ void kv(int j) const {
    using B = typename C::B;
    const int s = j % C::kStages;
    hop::mbar_wait(&empty[s], ((j / C::kStages) & 1) ^ 1);
    if (lane == 0) {
      hop::mbar_expect_tx(&full[s], 2 * C::kKBytes);
      unsigned char* ks = smem + C::kv + s * 2 * C::kKBytes;
      for (int b = 0; b < B::kBoxes; ++b) {
        hop::tma_load(ks + b * C::kBoxK, tm_k, &full[s], b * B::kCols,
                      j * C::BK, bh);
        hop::tma_load(ks + C::kKBytes + b * C::kBoxK, tm_v, &full[s],
                      b * B::kCols, j * C::BK, bh);
      }
    }
    __syncwarp();
  }
};

// Thread 0 sets up the barriers; then warp 0 loads q and do once and the
// first kStages k blocks.
template <class C>
__device__ __forceinline__ DqLoads<C> dq_start(
    unsigned char* smem, const CUtensorMap* tm_q, const CUtensorMap* tm_k,
    const CUtensorMap* tm_v, const CUtensorMap* tm_do, int q0, int kend) {
  using B = typename C::B;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::bars);
  uint64_t* empty = full + C::kStages;
  uint64_t* qbar = empty + C::kStages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      hop::mbar_init(&full[s], 1);
      hop::mbar_init(&empty[s], hop::kWarps);
    }
    hop::mbar_init(qbar, 1);
    hop::fence_barrier_init();
  }
  __syncthreads();
  const int bh = blockIdx.x;
  const DqLoads<C> ld{smem, full, empty, qbar, tm_k, tm_v, bh,
                      static_cast<int>(threadIdx.x % 32)};
  if (threadIdx.x / 32 == 0) {
    if (ld.lane == 0) {
      hop::mbar_expect_tx(qbar, 2 * C::kQBytes);
      for (int b = 0; b < B::kBoxes; ++b) {
        hop::tma_load(smem + C::q + b * C::kBoxQ, tm_q, qbar, b * B::kCols,
                      q0, bh);
        hop::tma_load(smem + C::dout + b * C::kBoxQ, tm_do, qbar,
                      b * B::kCols, q0, bh);
      }
    }
    __syncwarp();
    for (int j = 0; j < C::kStages && j < kend; ++j) ld.kv(j);
  }
  return ld;
}

// s = q·kᵀ and dp = do·vᵀ into sc and dp (m64nNk16 accumulators) over D
// in steps of 16, all four operands K-major Box<D> tiles: q and do from
// box stride qbox, k and v from box stride kbox.
template <int D, int N>
__device__ __forceinline__ void dq_scores(float (&sc)[N], float (&dp)[N],
                                          uint32_t q_addr, uint32_t do_addr,
                                          uint32_t k_addr, uint32_t v_addr,
                                          uint32_t qbox, uint32_t kbox) {
  using B = hop::Box<D>;
  hop::wgmma_fence();
#pragma unroll
  for (int x = 0; x < D / 16; ++x) {
    const uint32_t at = (x % B::kSteps) * 32;
    const uint64_t a = hop::desc_box<D>(q_addr + (x / B::kSteps) * qbox + at, 16);
    const uint64_t b = hop::desc_box<D>(k_addr + (x / B::kSteps) * kbox + at, 16);
    if (x == 0) {
      hop::wgmma_ss_first(sc, a, b);
    } else {
      hop::wgmma_ss(sc, a, b);
    }
  }
#pragma unroll
  for (int x = 0; x < D / 16; ++x) {
    const uint32_t at = (x % B::kSteps) * 32;
    const uint64_t a = hop::desc_box<D>(do_addr + (x / B::kSteps) * qbox + at, 16);
    const uint64_t b = hop::desc_box<D>(v_addr + (x / B::kSteps) * kbox + at, 16);
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
}

// ds = exp(s - lse) (dp - delta) in place of dp, for this thread's rows
// row0 and row1 = row0 + 8 over keys kc0 + [0, 2N) (N / 4 slices of 8,
// columns cq and cq + 1 of each); ls0/ls1 are the rows' lse·log2(e),
// dl0/dl1 their delta.  Masked where the block straddles the diagonal or
// an end.
template <int N>
__device__ __forceinline__ void dq_ds(float (&sc)[N], float (&dp)[N],
                                      bool mask, int row0, int kc0, int cq,
                                      float ls0, float ls1, float dl0,
                                      float dl1, int tq, int tk, int causal) {
  if (mask) {
#pragma unroll
    for (int j = 0; j < N / 4; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kc = kc0 + 8 * j + cq + e;
        if (masked_out(row0, kc, tq, tk, causal)) sc[4 * j + e] = kNeg;
        if (masked_out(row0 + 8, kc, tq, tk, causal)) sc[4 * j + 2 + e] = kNeg;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
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
}

// dq · scale as bf16, for this thread's rows (past tq: not stored) and its
// column pairs of columns [c0, c0 + 2N).
template <int N>
__device__ __forceinline__ void dq_store(bf16* dqg, const float (&acc)[N],
                                         int d, int row0, int c0, int cq,
                                         int tq, float scale) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    if (row < tq) {
#pragma unroll
      for (int j = 0; j < N / 4; ++j) {
        *reinterpret_cast<uint32_t*>(dqg + static_cast<size_t>(row) * d +
                                     c0 + 8 * j + cq) =
            hop::pack_bf16(acc[4 * j + 2 * h] * scale,
                           acc[4 * j + 2 * h + 1] * scale);
      }
    }
  }
}

// D 32, 64, 128: one block of two warpgroups per (bh, 128-row q tile).
template <int D>
__device__ __forceinline__ void dq_by_rows(
    const CUtensorMap* tm_q, const CUtensorMap* tm_k, const CUtensorMap* tm_v,
    const CUtensorMap* tm_do, const float* lse, const float* delta,
    bf16* dq, int tq, int tk, int causal, float scale) {
  using C = HopDq<D>;
  using B = typename C::B;
  constexpr int BK = C::BK;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = hop::align_atom(smem_raw);

  const int bh = blockIdx.x;
  // Heaviest causal q tiles (the last ones) start first, over all heads.
  // The causal end block holds the tile's last row.  With BK == BQ it
  // starts at q0, so every visited block reaches both warpgroups' rows;
  // with 64-key blocks (D 32) the last reaches warpgroup 1's rows only,
  // and warpgroup 0 skips it.
  const int q0 = (gridDim.y - 1 - blockIdx.y) * C::BQ;
  const int nk = (tk + BK - 1) / BK;
  const int kend = causal ? min(nk, (q0 + C::BQ - BK) / BK + 1) : nk;
  const DqLoads<C> ld = dq_start<C>(smem, tm_q, tm_k, tm_v, tm_do, q0, kend);

  // Warpgroup g owns q rows [q0 + 64g, q0 + 64g + 64).  In the m64nNk16
  // accumulator layout each thread holds rows r0 and r0 + 8, columns
  // 8j + cq and 8j + cq + 1 of every 8-column slice j, so its lse and
  // delta are two floats each.  Rows past tq read lse and delta as 0:
  // their q and do rows are TMA zeros, so their ds is 0, and their dq is
  // never stored.
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = warp / 4;
  const int r0 = (warp % 4) * 16 + lane / 4;
  const int cq = 2 * (lane % 4);
  const int qw = q0 + 64 * g;
  const int row0 = qw + r0, row1 = row0 + 8;
  const uint32_t q_addr = hop::smem_u32(smem + C::q) + 64 * g * B::kRow;
  const uint32_t do_addr = hop::smem_u32(smem + C::dout) + 64 * g * B::kRow;
  const float* lg = lse + static_cast<size_t>(bh) * tq;
  const float* dg = delta + static_cast<size_t>(bh) * tq;
  const float ls0 = row0 < tq ? lg[row0] * hop::kLog2e : 0.f;
  const float ls1 = row1 < tq ? lg[row1] * hop::kLog2e : 0.f;
  const float dl0 = row0 < tq ? dg[row0] : 0.f;
  const float dl1 = row1 < tq ? dg[row1] : 0.f;

  float acc[D / 2];  // dq, unscaled
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  hop::mbar_wait(ld.qbar, 0);

  // The block's stage is free once this warp's products that read it are
  // done; warp 0 then refills it kStages blocks ahead.
  auto release = [&](int kb) {
    __syncwarp();
    if (lane == 0) hop::mbar_arrive(&ld.empty[kb % C::kStages]);
    if (warp == 0 && kb + C::kStages < kend) ld.kv(kb + C::kStages);
  };
  for (int kb = 0; kb < kend; ++kb) {
    const int s = kb % C::kStages;
    const int k0 = kb * BK;
    hop::mbar_wait(&ld.full[s], (kb / C::kStages) & 1);
    if constexpr (BK < C::BQ) {
      if (causal && k0 > qw + 63) {
        // Every key of this block is after every row of this warpgroup.
        release(kb);
        continue;
      }
    }
    const uint32_t k_addr = hop::smem_u32(smem + C::kv + s * 2 * C::kKBytes);
    const uint32_t v_addr = k_addr + C::kKBytes;

    float sc[BK / 2], dp[BK / 2];
    dq_scores<D>(sc, dp, q_addr, do_addr, k_addr, v_addr, C::kBoxQ,
                 C::kBoxK);
    dq_ds(sc, dp, (causal && k0 + BK - 1 > qw) || k0 + BK > tk, row0, k0,
          cq, ls0, ls1, dl0, dl1, tq, tk, causal);

    // dq += ds·k over the k block in steps of 16 keys: ds from registers,
    // k MN-major (the next 16 keys are 16 box rows further).
    uint32_t dsa[BK / 4];
    hop::acc_to_a(dp, dsa);
    hop::wgmma_fence();
#pragma unroll
    for (int x = 0; x < BK / 16; ++x) {
      hop::wgmma_rs(acc, dsa[4 * x], dsa[4 * x + 1], dsa[4 * x + 2],
                    dsa[4 * x + 3],
                    hop::desc_box<D>(k_addr + x * 16 * B::kRow, C::kBoxK));
    }
    hop::wgmma_commit();
    hop::wgmma_wait<0>();
    hop::fence_regs(acc);
    release(kb);
  }

  dq_store(dq + static_cast<size_t>(bh) * tq * D, acc, D, row0, 0, cq, tq,
           scale);
}

// D 256: one block of two warpgroups per (bh, 64-row q tile), dq's
// columns split (HopDqCols).
__device__ __forceinline__ void dq_by_cols(
    const CUtensorMap* tm_q, const CUtensorMap* tm_k, const CUtensorMap* tm_v,
    const CUtensorMap* tm_do, const float* lse, const float* delta,
    bf16* dq, int tq, int tk, int causal, float scale) {
  using C = HopDqCols;
  using B = C::B;
  constexpr int D = C::D, BK = C::BK;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = hop::align_atom(smem_raw);

  const int bh = blockIdx.x;
  // Heaviest causal q tiles first.  BK == BQ: the causal end block is the
  // diagonal one, and every visited block reaches the tile's rows (no
  // block is skipped).
  const int q0 = (gridDim.y - 1 - blockIdx.y) * C::BQ;
  const int nk = (tk + BK - 1) / BK;
  const int kend = causal ? min(nk, q0 / BK + 1) : nk;
  const DqLoads<C> ld = dq_start<C>(smem, tm_q, tm_k, tm_v, tm_do, q0, kend);

  // Both warpgroups hold the tile's 64 q rows (r0 and r0 + 8 of each
  // thread, as in the m64nNk16 accumulator layout).  Warpgroup g forms s
  // and dp over keys [32g, 32g + 32) of each k block, and keeps dq over D
  // columns [128g, 128g + 128).
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = warp / 4;
  const int r0 = (warp % 4) * 16 + lane / 4;
  const int cq = 2 * (lane % 4);
  const int row0 = q0 + r0, row1 = row0 + 8;
  const uint32_t q_addr = hop::smem_u32(smem + C::q);
  const uint32_t do_addr = hop::smem_u32(smem + C::dout);
  const float* lg = lse + static_cast<size_t>(bh) * tq;
  const float* dg = delta + static_cast<size_t>(bh) * tq;
  const float ls0 = row0 < tq ? lg[row0] * hop::kLog2e : 0.f;
  const float ls1 = row1 < tq ? lg[row1] * hop::kLog2e : 0.f;
  const float dl0 = row0 < tq ? dg[row0] : 0.f;
  const float dl1 = row1 < tq ? dg[row1] : 0.f;

  float acc[C::kHalf / 2];  // dq over this warpgroup's columns, unscaled
#pragma unroll
  for (int i = 0; i < C::kHalf / 2; ++i) acc[i] = 0.f;
  hop::mbar_wait(ld.qbar, 0);

  for (int kb = 0; kb < kend; ++kb) {
    const int s = kb % C::kStages;
    const int k0 = kb * BK;
    hop::mbar_wait(&ld.full[s], (kb / C::kStages) & 1);
    const uint32_t k_addr = hop::smem_u32(smem + C::kv + s * 2 * C::kKBytes);
    const uint32_t v_addr = k_addr + C::kKBytes;

    // s and dp for this warpgroup's 32 keys (k and v rows [32g, 32g + 32)
    // as B).
    float sc[C::kKeys / 2], dp[C::kKeys / 2];
    dq_scores<D>(sc, dp, q_addr, do_addr, k_addr + C::kKeys * g * B::kRow,
                 v_addr + C::kKeys * g * B::kRow, C::kBoxQ, C::kBoxK);
    dq_ds(sc, dp, (causal && k0 + BK - 1 > q0) || k0 + BK > tk, row0,
          k0 + C::kKeys * g, cq, ls0, ls1, dl0, dl1, tq, tk, causal);

    // This block's ds tile: [64 q rows, 64 keys] bf16 rows of 128 bytes,
    // 16-byte chunk c of row r at chunk c ^ (r % 8) (the 128-byte swizzle
    // the A descriptors read).  This warpgroup writes its 32 keys.
    unsigned char* dsbuf = smem + C::ds + (kb % 2) * C::kDsBytes;
#pragma unroll
    for (int j = 0; j < C::kKeys / 8; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + 8 * h, c = C::kKeys * g + 8 * j + cq;
        const uint32_t at = r * 128 + (((c >> 3) ^ (r & 7)) << 4) + 2 * (c & 7);
        *reinterpret_cast<uint32_t*>(dsbuf + at) =
            hop::pack_bf16(dp[4 * j + 2 * h], dp[4 * j + 2 * h + 1]);
      }
    }
    hop::fence_async_shared();
    hop::named_sync(1, hop::kThreads);

    // dq += ds·k over this warpgroup's 128 columns, in steps of 16 keys:
    // ds from shared memory (K-major), k MN-major (boxes 2g and 2g + 1).
    const uint32_t ds_addr = hop::smem_u32(dsbuf);
    const uint32_t cols = 2 * g * C::kBoxK;
    hop::wgmma_fence();
#pragma unroll
    for (int t = 0; t < BK / 16; ++t) {
      hop::wgmma_ss<1>(acc, hop::desc_sw128(ds_addr + 32 * t, 16, 1024),
                       hop::desc_box<D>(k_addr + cols + t * 16 * B::kRow,
                                        C::kBoxK));
    }
    hop::wgmma_commit();
    hop::wgmma_wait<0>();
    hop::fence_regs(acc);

    // The stage is free once this warp's products that read it are done;
    // warp 0 then refills it kStages blocks ahead.
    __syncwarp();
    if (lane == 0) hop::mbar_arrive(&ld.empty[s]);
    if (warp == 0 && kb + C::kStages < kend) ld.kv(kb + C::kStages);
  }

  dq_store(dq + static_cast<size_t>(bh) * tq * D, acc, D, row0,
           C::kHalf * g, cq, tq, scale);
}

// At D 32 two blocks share an SM: ptxas holds the kernel to 128 registers
// a thread (left free, it takes 133, one block an SM).
template <int D>
__global__ void __launch_bounds__(hop::kThreads, D == 32 ? 2 : 1)
    flash_dq_hopper(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const __grid_constant__ CUtensorMap tm_do,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dq,
                    int tq, int tk, int causal, float scale) {
  if constexpr (D == 256) {
    dq_by_cols(&tm_q, &tm_k, &tm_v, &tm_do, lse, delta, dq, tq, tk, causal,
               scale);
  } else {
    dq_by_rows<D>(&tm_q, &tm_k, &tm_v, &tm_do, lse, delta, dq, tq, tk,
                  causal, scale);
  }
}

template <int D>
int launch_dq_hopper(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* delta,
                     void* dq, int bh, int tq, int tk, int causal, float scale,
                     cudaStream_t stream) {
  using C = HopDqFor<D>;
  constexpr int kCols = C::B::kCols;
  // The maps hold the tensors' addresses, so they are made on every call.
  CUtensorMap mq, mk, mv, mdo;
  if (!hop::make_map(&mq, q, D, tq, bh, C::BQ, kCols) ||
      !hop::make_map(&mk, k, D, tk, bh, C::BK, kCols) ||
      !hop::make_map(&mv, v, D, tk, bh, C::BK, kCols) ||
      !hop::make_map(&mdo, dout, D, tq, bh, C::BQ, kCols)) {
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

// ---------------------------------------------- float32 Hopper design
// Every D (hopper_f32.cuh): k and v as three bf16 planes, every product
// six wgmma products.  Per k block, s = q·kᵀ and dp = do·vᵀ by wgmma,
// ds = p (dp - delta) in registers, split into three planes as dq +=
// ds·k's register A (k MN-major).
// * D 64, 128 and 256: planes take 6 bytes an element, so a block keeps
//   one 64-row q tile and both warpgroups share it; they split the k
//   blocks instead, warpgroup g taking blocks g, g + 2, ... from a ring of
//   its own (kStages stages, refilled by its first warp), and each keeps a
//   partial dq of all 64 rows in registers.  Their sum meets once, after
//   the loop, in shared memory.  Shared memory, q and do plus each
//   warpgroup's stage of k and v planes: D 128, q and do planes, 32-key
//   blocks: 96 KB + 2 x 48 KB = 192 KB; D 64, 64-key blocks: 48 KB + 2 x
//   48 KB = 144 KB; D 256 (kRowsF32), q and do float32 split in registers
//   (F32Tile), 16-key blocks: 128 KB + 2 x 48 KB = 224 KB (232,448 the
//   cap).  At D 256 dq's 128 registers a thread leave room for s and dp of
//   16 keys (8 each) and two steps' fragment planes in flight.
// * D 32 (kByRows; 64-byte rows, the 64-byte swizzle): rows are small
//   enough for the bf16 design's shape, one block per 128-row q tile, each
//   warpgroup owning 64 of its rows and their dq, both taking every k
//   block from one ring of four 64-key stages that warp 0 refills once
//   both have released a stage (q and do planes 48 KB + 4 x 24 KB = 144
//   KB): half the streamed bytes a row of the alternating shape, and no
//   final sum; on the card 9% faster than that shape (PERF.md).
//   Warpgroup 0 skips the causal end block, which reaches warpgroup 1's
//   rows only.  dq is 16 registers a thread, so every product's hi·hi
//   sums in accumulators of its own (kHiApart): the tensor cores'
//   round-toward-zero sums over T took dq to 9.3x the plain version's
//   error against float64 at T 8,192 with one accumulator (the gate is
//   8x), 2.9x with two, for 3.5% of the time.
template <int D>
struct F32Dq {
  using B = hop::Box<D>;
  static constexpr bool kRowsF32 = D == 256;
  static constexpr bool kByRows = D == 32;
  static constexpr bool kHiApart = D == 32;
  static constexpr int kRings = kByRows ? 1 : 2;  // one a warpgroup, or shared
  static constexpr int BQ = kByRows ? 128 : 64;
  static constexpr int BK = D == 256 ? 16 : D == 128 ? 32 : 64;
  static constexpr int kStages = kByRows ? 4 : 1;
  static constexpr uint32_t kBoxQ = BQ * B::kRow;  // one box, one plane
  static constexpr uint32_t kBoxK = BK * B::kRow;
  static constexpr uint32_t kQPlane = B::kBoxes * kBoxQ;
  static constexpr uint32_t kKPlane = B::kBoxes * kBoxK;
  // q's float32 tile, or its three planes.
  static constexpr uint32_t kQBytes =
      kRowsF32 ? hop::F32Tile<D, BQ>::kBytes : 3 * kQPlane;
  static constexpr uint32_t kKBytes = 3 * kKPlane;
  static constexpr size_t q = 0;
  static constexpr size_t dout = kQBytes;
  // Ring r's stage s at kv + (r·kStages + s)·2·kKBytes: k, then v.
  static constexpr size_t kv = 2 * kQBytes;
  static constexpr size_t bars = kv + kRings * kStages * 2 * kKBytes;
  // full and empty a stage of each ring, then q's.
  static constexpr size_t bytes =
      bars + 8 * (2 * kRings * kStages + 1) + hop::kAtomBytes;
  static_assert(D == 32 || D == 64 || D == 128 || D == 256,
                "float32 D 32, 64, 128, 256");
  static_assert(bytes <= kMaxSmem, "dq tiles exceed shared memory");
  // Warpgroup 1's partial dq passes through the idle rings.
  static_assert(kByRows || D / 2 * 4 * 128 <= 2 * kStages * 2 * kKBytes,
                "ring");
};

template <int D>
__global__ void __launch_bounds__(hop::kThreads, 1)
    flash_dq_hopper_f32(const __grid_constant__ CUtensorMap tm_q,
                        const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v,
                        const __grid_constant__ CUtensorMap tm_do,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        float* __restrict__ dq, int tq, int tk, int causal,
                        float scale) {
  using C = F32Dq<D>;
  using B = typename C::B;
  constexpr int BK = C::BK, S = C::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = hop::align_atom(smem_raw);
  constexpr int R = C::kRings;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::bars);
  uint64_t* empty = full + R * S;
  uint64_t* qbar = empty + R * S;

  // Plane p of head bh is head bh + p·nbh of the maps.
  const int bh = blockIdx.x, nbh = gridDim.x;
  // Heaviest causal q tiles (the last ones) start first, over all heads.
  // The causal end block holds the tile's last row: with 64-row tiles
  // every block up to it reaches the tile's rows; with 128 (kByRows) the
  // last reaches warpgroup 1's rows only.
  const int q0 = (gridDim.y - 1 - blockIdx.y) * C::BQ;
  const int nk = (tk + BK - 1) / BK;
  const int kend = causal ? min(nk, (q0 + C::BQ - 1) / BK + 1) : nk;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = warp / 4;
  // The warpgroup's blocks: all of them from the shared ring (kByRows),
  // or k blocks g, g + 2, ... below kend from ring g.
  const int nblk = C::kByRows ? kend : (kend - g + 1) / 2;
  const int ring = C::kByRows ? 0 : g;
  const bool loader = C::kByRows ? warp == 0 : warp % 4 == 0;
  auto kblock = [&](int j) { return C::kByRows ? j : 2 * j + g; };

  if (threadIdx.x == 0) {
    for (int i = 0; i < R * S; ++i) {
      hop::mbar_init(&full[i], 1);
      hop::mbar_init(&empty[i], 4 * (2 / R));  // the ring's warps
    }
    hop::mbar_init(qbar, 1);
    hop::fence_barrier_init();
  }
  __syncthreads();

  // The warpgroup's j-th block into its ring's stage j % S, once the
  // ring's warps have released the block S before it.
  const CUtensorMap* mk = &tm_k;
  const CUtensorMap* mv = &tm_v;
  auto load_kv = [&](int j) {
    const int s = ring * S + j % S;
    hop::mbar_wait(&empty[s], ((j / S) & 1) ^ 1);
    if (lane == 0) {
      hop::mbar_expect_tx(&full[s], 2 * C::kKBytes);
      unsigned char* ks = smem + C::kv + s * 2 * C::kKBytes;
      for (int p = 0; p < 3; ++p) {
        for (int b = 0; b < B::kBoxes; ++b) {
          const uint32_t at = p * C::kKPlane + b * C::kBoxK;
          hop::tma_load(ks + at, mk, &full[s], b * B::kCols,
                        kblock(j) * BK, bh + p * nbh);
          hop::tma_load(ks + C::kKBytes + at, mv, &full[s],
                        b * B::kCols, kblock(j) * BK, bh + p * nbh);
        }
      }
    }
    __syncwarp();
  };
  if (loader) {
    if (warp == 0 && lane == 0) {
      hop::mbar_expect_tx(qbar, 2 * C::kQBytes);
      if constexpr (C::kRowsF32) {
        hop::tma_load_f32<D, C::BQ>(smem + C::q, &tm_q, qbar, q0, bh);
        hop::tma_load_f32<D, C::BQ>(smem + C::dout, &tm_do, qbar, q0, bh);
      } else {
        for (int p = 0; p < 3; ++p) {
          for (int b = 0; b < B::kBoxes; ++b) {
            const uint32_t at = p * C::kQPlane + b * C::kBoxQ;
            hop::tma_load(smem + C::q + at, &tm_q, qbar, b * B::kCols, q0,
                          bh + p * nbh);
            hop::tma_load(smem + C::dout + at, &tm_do, qbar, b * B::kCols,
                          q0, bh + p * nbh);
          }
        }
      }
    }
    __syncwarp();
    for (int j = 0; j < S && j < nblk; ++j) load_kv(j);
  }

  // Each warpgroup holds 64 rows from qw (the tile's, or with kByRows
  // its own half), r0 and r0 + 8 of each thread in the m64nNk16
  // accumulator layout.  Rows past tq read lse and delta as 0: their q
  // and do rows are TMA zeros, so their ds is 0.
  const int r0 = (warp % 4) * 16 + lane / 4;
  const int cq = 2 * (lane % 4);
  const int qw = q0 + (C::kByRows ? 64 * g : 0);
  const int row0 = qw + r0, row1 = row0 + 8;
  const float* lg = lse + static_cast<size_t>(bh) * tq;
  const float* dg = delta + static_cast<size_t>(bh) * tq;
  const float ls0 = row0 < tq ? lg[row0] * hop::kLog2e : 0.f;
  const float ls1 = row1 < tq ? lg[row1] * hop::kLog2e : 0.f;
  const float dl0 = row0 < tq ? dg[row0] : 0.f;
  const float dl1 = row1 < tq ? dg[row1] : 0.f;
  const uint32_t rows_at = C::kByRows ? 64 * g * B::kRow : 0;
  const uint32_t q_addr = hop::smem_u32(smem + C::q) + rows_at;
  const uint32_t do_addr = hop::smem_u32(smem + C::dout) + rows_at;

  // This warpgroup's part of dq, unscaled (with kHiApart its hi·hi
  // products in hacc).
  float acc[D / 2], hacc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) {
    acc[i] = 0.f;
    hacc[i] = 0.f;
  }
  hop::mbar_wait(qbar, 0);

  // The stage is free once this warp's products that read it are done;
  // the ring's loader then refills it S blocks ahead.
  auto release = [&](int j, int s) {
    __syncwarp();
    if (lane == 0) hop::mbar_arrive(&empty[s]);
    if (loader && j + S < nblk) load_kv(j + S);
  };
  for (int j = 0; j < nblk; ++j) {
    const int s = ring * S + j % S;
    const int k0 = kblock(j) * BK;
    hop::mbar_wait(&full[s], (j / S) & 1);
    if (C::kByRows && causal && k0 > qw + 63) {
      // Every key of this block is after every row of this warpgroup.
      release(j, s);
      continue;
    }
    const uint32_t k_addr = hop::smem_u32(smem + C::kv + s * 2 * C::kKBytes);
    const uint32_t v_addr = k_addr + C::kKBytes;

    float sc[BK / 2], dp[BK / 2];
    if constexpr (C::kRowsF32) {
      // q's and do's fragments split in registers at every step.
      hop::f32_rs_scores<D>(sc, dp,
                            reinterpret_cast<const float*>(smem + C::q),
                            reinterpret_cast<const float*>(smem + C::dout),
                            r0, cq, k_addr, v_addr, C::kKPlane, C::kBoxK);
    } else if constexpr (C::kHiApart) {
      float hs[BK / 2], hd[BK / 2];
      hop::wgmma_fence();
      hop::planes_ss<D>(sc, hs, q_addr, C::kQPlane, C::kBoxQ, k_addr,
                        C::kKPlane, C::kBoxK);
      hop::planes_ss<D>(dp, hd, do_addr, C::kQPlane, C::kBoxQ, v_addr,
                        C::kKPlane, C::kBoxK);
      hop::wgmma_commit();
      hop::wgmma_wait<0>();
      hop::fence_regs(sc);
      hop::fence_regs(dp);
      hop::fence_regs(hs);
      hop::fence_regs(hd);
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        sc[i] += hs[i];
        dp[i] += hd[i];
      }
    } else {
      hop::wgmma_fence();
      hop::planes_ss<D>(sc, q_addr, C::kQPlane, C::kBoxQ, k_addr,
                        C::kKPlane, C::kBoxK);
      hop::planes_ss<D>(dp, do_addr, C::kQPlane, C::kBoxQ, v_addr,
                        C::kKPlane, C::kBoxK);
      hop::wgmma_commit();
      hop::wgmma_wait<0>();
      hop::fence_regs(sc);
      hop::fence_regs(dp);
    }
    dq_ds(sc, dp, (causal && k0 + BK - 1 > qw) || k0 + BK > tk, row0, k0,
          cq, ls0, ls1, dl0, dl1, tq, tk, causal);

    // dq += ds·k: ds's planes from registers, k's MN-major.
    uint32_t dsa[3][BK / 4];
    hop::acc_to_a3(dp, dsa);
    hop::wgmma_fence();
    if constexpr (C::kHiApart) {
      hop::planes_rs<D>(acc, hacc, dsa, k_addr, C::kKPlane, C::kBoxK);
    } else {
      hop::planes_rs<D>(acc, dsa, k_addr, C::kKPlane, C::kBoxK);
    }
    hop::wgmma_commit();
    hop::wgmma_wait<0>();
    hop::fence_regs(acc);
    if constexpr (C::kHiApart) hop::fence_regs(hacc);
    release(j, s);
  }
  if constexpr (C::kHiApart) {
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] += hacc[i];
  }

  // With kByRows each warpgroup stores its own rows.  Otherwise warpgroup
  // 1's partial dq passes to warpgroup 0 through the rings, which no load
  // fills any more: thread t + 128 holds the same elements as t.
  const float* red = reinterpret_cast<const float*>(smem + C::kv);
  const int t = threadIdx.x % 128;
  if constexpr (!C::kByRows) {
    hop::fence_async_shared();
    hop::named_sync(1, hop::kThreads);
    if (g == 1) {
      float* out = reinterpret_cast<float*>(smem + C::kv);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) out[i * 128 + t] = acc[i];
    }
    hop::named_sync(1, hop::kThreads);
    if (g == 1) return;
  }
  float* dqg = dq + static_cast<size_t>(bh) * tq * D;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    if (row < tq) {
#pragma unroll
      for (int jc = 0; jc < D / 8; ++jc) {
        const int i = 4 * jc + 2 * h;
        float2 x = make_float2(acc[i], acc[i + 1]);
        if constexpr (!C::kByRows) {
          x.x += red[i * 128 + t];
          x.y += red[(i + 1) * 128 + t];
        }
        *reinterpret_cast<float2*>(dqg + static_cast<size_t>(row) * D +
                                   8 * jc + cq) =
            make_float2(x.x * scale, x.y * scale);
      }
    }
  }
}

// The float32 launch's planes (q's and do's too but at kRowsF32, where
// their float32 rows get maps of their own) split on the stream into the
// scratch, and the maps over them in m.
template <int D>
int split_dq_f32(Planes& m, const void* q, const void* k, const void* v,
                 const void* dout, void* planes, size_t planes_n, int bh,
                 int tq, int tk, cudaStream_t stream) {
  using C = F32Dq<D>;
  if constexpr (C::kRowsF32) {
    const int rc = m.split(nullptr, k, v, nullptr, planes, planes_n, D, bh,
                           tq, tk, C::BQ, C::BK, stream);
    if (rc != 0) return rc;
    return make_map_f32(&m.q, q, D, tq, bh, C::BQ) &&
                   make_map_f32(&m.dout, dout, D, tq, bh, C::BQ)
               ? 0
               : MVT_TMA_REFUSED;
  } else {
    return m.split(q, k, v, dout, planes, planes_n, D, bh, tq, tk, C::BQ,
                   C::BK, stream);
  }
}

template <int D>
int launch_dq_f32(const void* q, const void* k, const void* v,
                  const void* dout, const void* lse, const void* delta,
                  void* dq, void* planes, size_t planes_n, int bh, int tq,
                  int tk, int causal, float scale, cudaStream_t stream) {
  using C = F32Dq<D>;
  Planes m;
  const int rc = split_dq_f32<D>(m, q, k, v, dout, planes, planes_n, bh, tq,
                                 tk, stream);
  if (rc != 0) return rc;
  auto kernel = flash_dq_hopper_f32<D>;
  static bool smem_set = false;
  cudaError_t err = allow_smem(kernel, C::bytes, &smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(bh, (tq + C::BQ - 1) / C::BQ);
  kernel<<<grid, hop::kThreads, C::bytes, stream>>>(
      m.q, m.k, m.v, m.dout, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(dq), tq, tk,
      causal, scale);
  return static_cast<int>(cudaGetLastError());
}

// The design is fixed by (dtype, D) at compile time: bf16 runs the Hopper
// design above at every D, float32 the plane design (q and do float32 at
// D 256).
template <typename T>
int dq_for_dim(int d, const void* q, const void* k, const void* v,
               const void* dout, const void* lse, const void* delta,
               void* dq, void* planes, size_t planes_n, int bh, int tq,
               int tk, int causal, float scale, cudaStream_t s) {
  if constexpr (std::is_same<T, float>::value) {
    switch (d) {
      case 32: return launch_dq_f32<32>(q, k, v, dout, lse, delta, dq, planes, planes_n, bh, tq, tk, causal, scale, s);
      case 64: return launch_dq_f32<64>(q, k, v, dout, lse, delta, dq, planes, planes_n, bh, tq, tk, causal, scale, s);
      case 128: return launch_dq_f32<128>(q, k, v, dout, lse, delta, dq, planes, planes_n, bh, tq, tk, causal, scale, s);
      case 256: return launch_dq_f32<256>(q, k, v, dout, lse, delta, dq, planes, planes_n, bh, tq, tk, causal, scale, s);
      default: return MVT_UNSUPPORTED;
    }
  } else {
    switch (d) {
      case 32: return launch_dq_hopper<32>(q, k, v, dout, lse, delta, dq, bh, tq, tk, causal, scale, s);
      case 64: return launch_dq_hopper<64>(q, k, v, dout, lse, delta, dq, bh, tq, tk, causal, scale, s);
      case 128: return launch_dq_hopper<128>(q, k, v, dout, lse, delta, dq, bh, tq, tk, causal, scale, s);
      case 256: return launch_dq_hopper<256>(q, k, v, dout, lse, delta, dq, bh, tq, tk, causal, scale, s);
      default: return MVT_UNSUPPORTED;
    }
  }
}

}  // namespace mvt

// q (pre-scaled), k, v, dout: [bh, T, d]; lse, delta: [bh, tq] float;
// dq: [bh, tq, d], written as scale * ds k.  planes: the float32 plane
// design's scratch, 6·bh·(tq + tk)·d bf16 at D 32, 64 and 128, 6·bh·tk·d
// at D 256 (hopper_f32.cuh); null for a bf16 launch.  planes_n: its
// size in bf16 elements (a smaller one than the launch needs:
// MVT_SCRATCH_SHORT).
extern "C" int mvt_flash_dq(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, void* dq, void* planes,
                            size_t planes_n, int bh, int tq, int tk, int d,
                            int dtype, int causal, float scale,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == MVT_DTYPE_F32) {
    return mvt::dq_for_dim<float>(d, q, k, v, dout, lse, delta, dq, planes,
                                  planes_n, bh, tq, tk, causal, scale, s);
  }
  if (dtype == MVT_DTYPE_BF16) {
    return mvt::dq_for_dim<__nv_bfloat16>(d, q, k, v, dout, lse, delta, dq,
                                          planes, planes_n, bh, tq, tk,
                                          causal, scale, s);
  }
  return MVT_UNSUPPORTED;
}

// The split of a float32 mvt_flash_dq launch alone, on the same operands
// and scratch, with no kernel after it: what the launch spends before its
// kernel starts, timed apart.
extern "C" int mvt_plane_split(const void* q, const void* k, const void* v,
                               const void* dout, void* planes,
                               size_t planes_n, int bh, int tq, int tk,
                               int d, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  mvt::Planes m;
  switch (d) {
    case 32: return mvt::split_dq_f32<32>(m, q, k, v, dout, planes, planes_n, bh, tq, tk, s);
    case 64: return mvt::split_dq_f32<64>(m, q, k, v, dout, planes, planes_n, bh, tq, tk, s);
    case 128: return mvt::split_dq_f32<128>(m, q, k, v, dout, planes, planes_n, bh, tq, tk, s);
    case 256: return mvt::split_dq_f32<256>(m, q, k, v, dout, planes, planes_n, bh, tq, tk, s);
    default: return MVT_UNSUPPORTED;
  }
}
