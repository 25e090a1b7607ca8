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
// bound at the trainer's shapes (at head dim 32 the exp of each score
// costs about as much as its 8·32 flops); in float32 six bf16 products a
// product, so six times the flops at the bf16 rate (0.8342 ms at [4, 16,
// 2048, 128] and at [4, 8, 2048, 256], 0.4171 ms at [8, 16, 2048, 32],
// causal).  Two designs, chosen at compile time by (dtype, D) in
// dkv_for_dim:
//
// * bf16 at every D (flash_dkv_hopper): k-stationary with transposed
//   scores, accumulators in registers, both operands of every product
//   from TMA-filled shared memory or registers (hopper.cuh).  q and do
//   tiles of 64 rows stream through a ring of kStages stages by TMA, with
//   the matching lse and delta rows beside them by cp.async from warp 0,
//   kStages blocks ahead; k and v load once.  Per q block it forms
//   sᵀ = k·qᵀ and dpᵀ = v·doᵀ by wgmma, then pᵀ = exp(sᵀ - lse) and
//   dsᵀ = pᵀ (dpᵀ - delta) in registers (lse and delta broadcast along
//   columns), rounds both to bf16, and feeds them as the A operand of
//   dv += pᵀ·do and dk += dsᵀ·q (do and q MN-major).
//   - D 32, 64, 128 (dkv_by_rows): one block of two warpgroups per (bh,
//     128-row k block); each warpgroup owns 64 k rows, keeps its dk and dv
//     in registers for the whole q loop, and feeds pᵀ and dsᵀ from
//     registers.  No score tile is ever written to shared memory.
//   - D 256 (dkv_by_cols): dk and dv of 64 rows would need 256 registers
//     a thread, so one block per (bh, 64-row k block) splits their
//     columns between the two warpgroups, each forming half the q block's
//     pᵀ and dsᵀ and sharing them through shared memory (HopDkvCols).
// * float32 at every D (flash_dkv_hopper_f32, hopper_f32.cuh): q and do
//   split into three bf16 planes (hi, mid, lo) by flash_split3, an
//   elementwise kernel that replaces no TPU kernel, into the wrapper's
//   scratch; every product runs as six bf16 wgmma products into float32
//   accumulators (a0b0 + a0b1 + a1b0 + a0b2 + a1b1 + a2b0; the terms left
//   out are of order 2^-24 of the product), pᵀ and dsᵀ split in registers
//   as the A operands of dv += pᵀ·do and dk += dsᵀ·q.  One 64-row k block
//   a block.
//   - D 64 and 128 (dkv_f32_by_blocks): k and v are planes too; both
//     warpgroups share them and take every other q block from a ring of
//     their own, and sum their partial dk and dv once at the end (F32Dkv:
//     192 KB of shared memory at D 128, 144 KB at D 64).
//   - D 32 (dkv_f32_by_blocks, kByRows): a row of planes is 64 bytes, so
//     the block keeps the bf16 design's 128 k rows, 64 a warpgroup, as
//     planes, both warpgroups taking every q block from one ring of four
//     stages (144 KB); hi·hi of every product sums apart, and dk and dv
//     flush into float32 sums every 8 q blocks.
//   - D 256 (dkv_f32_by_roles): dk and dv of 64 rows would take 256
//     registers a thread, and k's and v's planes 192 KB, so k and v stay
//     float32 (128 KB), split in registers at every 16-column step as the
//     register A of sᵀ = k·qᵀ and dpᵀ = v·doᵀ, and the warpgroups split
//     the work by role over one stage of 32-row q blocks: warpgroup 0 owns
//     dv, warpgroup 1 dk, each sum flushed to device memory every 8
//     blocks (F32DkvRoles, 225 KB).
#include "flash_common.cuh"
#include "hopper.cuh"
#include "hopper_f32.cuh"

namespace mvt {

// ------------------------------------------------ bf16 Hopper design
// D 32, 64 and 128: k-stationary with transposed scores, each warpgroup
// owning 64 of the block's 128 k rows with its dk and dv in registers.
// D 32 runs 64-byte box rows with the 64-byte swizzle, and 32-row q
// blocks in four stages: sᵀ and pᵀ shrink to 99 registers a thread, so
// two blocks share an SM (a little faster on the card than 64-row q
// blocks; PERF.md).
template <int D>
struct HopDkv {
  using B = hop::Box<D>;
  static constexpr int BK = 128, BQ = D == 32 ? 32 : 64;
  static constexpr int kStages = D == 32 ? 4 : 3;
  static constexpr uint32_t kBoxK = BK * B::kRow;  // one box of columns
  static constexpr uint32_t kBoxQ = BQ * B::kRow;
  static constexpr uint32_t kKBytes = B::kBoxes * kBoxK;
  static constexpr uint32_t kQBytes = B::kBoxes * kBoxQ;
  static constexpr size_t k = 0;
  static constexpr size_t v = kKBytes;
  static constexpr size_t qdo = 2 * kKBytes;  // stage s: q, then do
  static constexpr size_t rows = qdo + kStages * 2 * kQBytes;  // lse, delta
  static constexpr size_t bars = rows + kStages * 2 * BQ * sizeof(float);
  static constexpr size_t bytes = bars + 8 * (2 * kStages + 1) + hop::kAtomBytes;
  static_assert(D <= 128, "D 256 splits columns: HopDkvCols");
  static_assert(bytes <= kMaxSmem, "dkv tiles exceed shared memory");
};

// D 256: dk and dv for 64 k rows would be 256 registers a thread, so both
// warpgroups share one block of 64 k rows and split the D columns of dk
// and dv (128 each: 128 registers).  Per q block each warpgroup forms sᵀ
// and dpᵀ for half the block's 64 q columns, turns them into pᵀ and dsᵀ
// in registers and writes them, bf16 and swizzled, into shared memory,
// where both warpgroups read the whole [64, 64] tiles as wgmma's A
// operand.  Two buffers of them, so one barrier a block keeps a buffer's
// writes after its last readers.  k 32 KB + v 32 KB + two stages of q and
// do (128 KB) + pᵀ and dsᵀ twice (32 KB) = 224 KB.
struct HopDkvCols {
  using B = hop::Box<256>;
  static constexpr int D = 256, BK = 64, BQ = 64, kStages = 2;
  static constexpr int kHalf = D / 2;          // dk, dv columns a warpgroup
  static constexpr int kQCols = BQ / 2;        // sᵀ columns a warpgroup
  static constexpr uint32_t kBoxK = BK * B::kRow;
  static constexpr uint32_t kBoxQ = BQ * B::kRow;
  static constexpr uint32_t kKBytes = B::kBoxes * kBoxK;
  static constexpr uint32_t kQBytes = B::kBoxes * kBoxQ;
  static constexpr uint32_t kPBytes = BK * BQ * 2;  // one [64, 64] bf16 box
  static constexpr size_t k = 0;
  static constexpr size_t v = kKBytes;
  static constexpr size_t qdo = 2 * kKBytes;  // stage s: q, then do
  static constexpr size_t pds = qdo + kStages * 2 * kQBytes;  // pᵀ, dsᵀ x 2
  static constexpr size_t rows = pds + 2 * 2 * kPBytes;       // lse, delta
  static constexpr size_t bars = rows + kStages * 2 * BQ * sizeof(float);
  static constexpr size_t bytes = bars + 8 * (2 * kStages + 1) + hop::kAtomBytes;
  static_assert(bytes <= kMaxSmem, "dkv tiles exceed shared memory");
};

// The launch's layout for head dim D.
template <int D>
using HopDkvFor =
    typename std::conditional<D == 256, HopDkvCols, HopDkv<D>>::type;

// Warp 0's refill of stage j % kStages with the j-th q block of the loop
// (block qstart + j), as soon as both warpgroups have released the block
// kStages before it: q and do by TMA from lane 0, the lse and delta rows by
// cp.async from every lane (rows past tq read as 0: their q and do rows
// are TMA zeros, and the mask drops them).
template <class C>
__device__ __forceinline__ void dkv_load_q(
    unsigned char* smem, uint64_t* full, uint64_t* empty,
    const CUtensorMap* tm_q, const CUtensorMap* tm_do, const float* lg,
    const float* dg, int bh, int tq, int qstart, int j, int lane) {
  using B = typename C::B;
  const int s = j % C::kStages;
  const int qb = qstart + j;
  hop::mbar_wait(&empty[s], ((j / C::kStages) & 1) ^ 1);
  if (lane == 0) {
    hop::mbar_expect_tx(&full[s], 2 * C::kQBytes);
    unsigned char* qs = smem + C::qdo + s * 2 * C::kQBytes;
    for (int b = 0; b < B::kBoxes; ++b) {
      hop::tma_load(qs + b * C::kBoxQ, tm_q, &full[s], b * B::kCols,
                    qb * C::BQ, bh);
      hop::tma_load(qs + C::kQBytes + b * C::kBoxQ, tm_do, &full[s],
                    b * B::kCols, qb * C::BQ, bh);
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
}

// pᵀ = exp(sᵀ - lse) and dsᵀ = pᵀ (dpᵀ - delta) in place, for 64 k rows
// (this thread's rows row0, row0 + 8) over q columns q0 + c0 + [0, 2N):
// the lse and delta rows are columns here, read from the stage's rows at
// c0.  Masked where the block straddles the diagonal or an end.
template <int N>
__device__ __forceinline__ void dkv_probs(float (&st)[N], float (&dpt)[N],
                                          const float* lse_s,
                                          const float* dl_s, bool mask,
                                          int q0, int c0, int row0, int cq,
                                          int tq, int tk, int causal) {
  const int row1 = row0 + 8;
  if (mask) {
#pragma unroll
    for (int j = 0; j < N / 4; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int qc = q0 + c0 + 8 * j + cq + e;
        if (masked_out(qc, row0, tq, tk, causal)) st[4 * j + e] = kNeg;
        if (masked_out(qc, row1, tq, tk, causal)) st[4 * j + 2 + e] = kNeg;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    const float2 l2 = *reinterpret_cast<const float2*>(lse_s + c0 + 8 * j + cq);
    const float2 d2 = *reinterpret_cast<const float2*>(dl_s + c0 + 8 * j + cq);
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
}

// D 32, 64, 128: one block of two warpgroups per (bh, 128-row k block).
template <int D>
__device__ __forceinline__ void dkv_by_rows(
    const CUtensorMap* tm_q, const CUtensorMap* tm_k, const CUtensorMap* tm_v,
    const CUtensorMap* tm_do, const float* lse, const float* delta,
    bf16* dk, bf16* dv, int tq, int tk, int causal) {
  using C = HopDkv<D>;
  using B = typename C::B;
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
  const float* lg = lse + static_cast<size_t>(bh) * tq;
  const float* dg = delta + static_cast<size_t>(bh) * tq;
  const int nblocks = nq - qstart;
  if (warp == 0) {
    if (lane == 0) {
      hop::mbar_expect_tx(kvbar, 2 * C::kKBytes);
      for (int b = 0; b < B::kBoxes; ++b) {
        hop::tma_load(smem + C::k + b * C::kBoxK, tm_k, kvbar, b * B::kCols,
                      k0, bh);
        hop::tma_load(smem + C::v + b * C::kBoxK, tm_v, kvbar, b * B::kCols,
                      k0, bh);
      }
    }
    for (int j = 0; j < C::kStages && j < nblocks; ++j) {
      dkv_load_q<C>(smem, full, empty, tm_q, tm_do, lg, dg, bh, tq, qstart,
                    j, lane);
    }
  }

  // Warpgroup g owns k rows [k0 + 64g, k0 + 64g + 64).  In the m64nNk16
  // accumulator layout each thread holds rows r0 and r0 + 8, columns
  // 8j + cq and 8j + cq + 1 of every 8-column slice j.
  const int g = warp / 4;
  const int r0 = (warp % 4) * 16 + lane / 4;
  const int cq = 2 * (lane % 4);
  const int kw = k0 + 64 * g;
  const int row0 = kw + r0, row1 = row0 + 8;
  const uint32_t k_addr = hop::smem_u32(smem + C::k) + 64 * g * B::kRow;
  const uint32_t v_addr = hop::smem_u32(smem + C::v) + 64 * g * B::kRow;

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
    if (warp == 0 && i + C::kStages < nblocks) {
      dkv_load_q<C>(smem, full, empty, tm_q, tm_do, lg, dg, bh, tq, qstart,
                    i + C::kStages, lane);
    }
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
      const uint32_t at = (t % B::kSteps) * 32;
      const uint32_t kcol = (t / B::kSteps) * C::kBoxK + at;
      const uint32_t qcol = (t / B::kSteps) * C::kBoxQ + at;
      const uint64_t a = hop::desc_box<D>(k_addr + kcol, 16);
      const uint64_t b = hop::desc_box<D>(q_addr + qcol, 16);
      if (t == 0) {
        hop::wgmma_ss_first(st, a, b);
      } else {
        hop::wgmma_ss(st, a, b);
      }
    }
#pragma unroll
    for (int t = 0; t < D / 16; ++t) {
      const uint32_t at = (t % B::kSteps) * 32;
      const uint32_t kcol = (t / B::kSteps) * C::kBoxK + at;
      const uint32_t qcol = (t / B::kSteps) * C::kBoxQ + at;
      const uint64_t a = hop::desc_box<D>(v_addr + kcol, 16);
      const uint64_t b = hop::desc_box<D>(do_addr + qcol, 16);
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

    dkv_probs(st, dpt, lse_s, dl_s,
              (causal && q0 < kw + 63) || kw + 64 > tk || q0 + C::BQ > tq,
              q0, 0, row0, cq, tq, tk, causal);

    // dv += pᵀ·do and dk += dsᵀ·q over the q block in steps of 16 rows:
    // pᵀ and dsᵀ from registers, do and q MN-major.
    uint32_t pa[C::BQ / 4], dsa[C::BQ / 4];
    hop::acc_to_a(st, pa);
    hop::acc_to_a(dpt, dsa);
    hop::wgmma_fence();
#pragma unroll
    for (int t = 0; t < C::BQ / 16; ++t) {
      const uint32_t row = t * 16 * B::kRow;
      const uint64_t b_do = hop::desc_box<D>(do_addr + row, C::kBoxQ);
      const uint64_t b_q = hop::desc_box<D>(q_addr + row, C::kBoxQ);
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

// D 256: one block of two warpgroups per (bh, 64-row k block), the
// columns split (HopDkvCols).
__device__ __forceinline__ void dkv_by_cols(
    const CUtensorMap* tm_q, const CUtensorMap* tm_k, const CUtensorMap* tm_v,
    const CUtensorMap* tm_do, const float* lse, const float* delta,
    bf16* dk, bf16* dv, int tq, int tk, int causal) {
  using C = HopDkvCols;
  using B = C::B;
  constexpr int D = C::D;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = hop::align_atom(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::bars);
  uint64_t* empty = full + C::kStages;
  uint64_t* kvbar = empty + C::kStages;

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * C::BK;
  const int nq = (tq + C::BQ - 1) / C::BQ;
  // BQ == BK: the causal start is the diagonal block, and every visited
  // block reaches the block's k rows (no block is skipped).
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
  const float* lg = lse + static_cast<size_t>(bh) * tq;
  const float* dg = delta + static_cast<size_t>(bh) * tq;
  const int nblocks = nq - qstart;
  if (warp == 0) {
    if (lane == 0) {
      hop::mbar_expect_tx(kvbar, 2 * C::kKBytes);
      for (int b = 0; b < B::kBoxes; ++b) {
        hop::tma_load(smem + C::k + b * C::kBoxK, tm_k, kvbar, b * B::kCols,
                      k0, bh);
        hop::tma_load(smem + C::v + b * C::kBoxK, tm_v, kvbar, b * B::kCols,
                      k0, bh);
      }
    }
    for (int j = 0; j < C::kStages && j < nblocks; ++j) {
      dkv_load_q<C>(smem, full, empty, tm_q, tm_do, lg, dg, bh, tq, qstart,
                    j, lane);
    }
  }

  // Both warpgroups hold the block's 64 k rows (r0 and r0 + 8 of each
  // thread, as in the m64nNk16 accumulator layout).  Warpgroup g forms sᵀ
  // and dpᵀ over q columns [32g, 32g + 32) of each q block, and keeps dk
  // and dv over D columns [128g, 128g + 128).
  const int g = warp / 4;
  const int r0 = (warp % 4) * 16 + lane / 4;
  const int cq = 2 * (lane % 4);
  const int row0 = k0 + r0, row1 = row0 + 8;
  const uint32_t k_addr = hop::smem_u32(smem + C::k);
  const uint32_t v_addr = hop::smem_u32(smem + C::v);

  float dka[C::kHalf / 2], dva[C::kHalf / 2];
#pragma unroll
  for (int i = 0; i < C::kHalf / 2; ++i) {
    dka[i] = 0.f;
    dva[i] = 0.f;
  }
  hop::mbar_wait(kvbar, 0);

  for (int i = 0; i < nblocks; ++i) {
    const int s = i % C::kStages;
    const int q0 = (qstart + i) * C::BQ;
    hop::mbar_wait(&full[s], (i / C::kStages) & 1);
    const uint32_t q_addr = hop::smem_u32(smem + C::qdo + s * 2 * C::kQBytes);
    const uint32_t do_addr = q_addr + C::kQBytes;
    const float* lse_s = reinterpret_cast<const float*>(smem + C::rows) + s * 2 * C::BQ;
    const float* dl_s = lse_s + C::BQ;

    // sᵀ = k·qᵀ and dpᵀ = v·doᵀ for this warpgroup's 32 q columns (q and
    // do rows [32g, 32g + 32) as B), over D in steps of 16, K-major.
    float st[C::kQCols / 2], dpt[C::kQCols / 2];
    const uint32_t qg_addr = q_addr + C::kQCols * g * B::kRow;
    const uint32_t dog_addr = do_addr + C::kQCols * g * B::kRow;
    hop::wgmma_fence();
#pragma unroll
    for (int t = 0; t < D / 16; ++t) {
      const uint32_t at = (t % B::kSteps) * 32;
      const uint64_t a = hop::desc_box<D>(
          k_addr + (t / B::kSteps) * C::kBoxK + at, 16);
      const uint64_t b = hop::desc_box<D>(
          qg_addr + (t / B::kSteps) * C::kBoxQ + at, 16);
      if (t == 0) {
        hop::wgmma_ss_first(st, a, b);
      } else {
        hop::wgmma_ss(st, a, b);
      }
    }
#pragma unroll
    for (int t = 0; t < D / 16; ++t) {
      const uint32_t at = (t % B::kSteps) * 32;
      const uint64_t a = hop::desc_box<D>(
          v_addr + (t / B::kSteps) * C::kBoxK + at, 16);
      const uint64_t b = hop::desc_box<D>(
          dog_addr + (t / B::kSteps) * C::kBoxQ + at, 16);
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

    dkv_probs(st, dpt, lse_s, dl_s,
              (causal && q0 < k0 + 63) || k0 + 64 > tk || q0 + C::BQ > tq,
              q0, C::kQCols * g, row0, cq, tq, tk, causal);

    // This block's pᵀ and dsᵀ tiles: [64 k rows, 64 q] bf16 rows of 128
    // bytes, 16-byte chunk c of row r at chunk c ^ (r % 8) (the 128-byte
    // swizzle the A descriptors read).  This warpgroup writes its 32
    // columns of both.
    unsigned char* pbuf = smem + C::pds + (i % 2) * 2 * C::kPBytes;
#pragma unroll
    for (int j = 0; j < C::kQCols / 8; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + 8 * h, c = C::kQCols * g + 8 * j + cq;
        const uint32_t at = r * 128 + (((c >> 3) ^ (r & 7)) << 4) + 2 * (c & 7);
        *reinterpret_cast<uint32_t*>(pbuf + at) =
            hop::pack_bf16(st[4 * j + 2 * h], st[4 * j + 2 * h + 1]);
        *reinterpret_cast<uint32_t*>(pbuf + C::kPBytes + at) =
            hop::pack_bf16(dpt[4 * j + 2 * h], dpt[4 * j + 2 * h + 1]);
      }
    }
    hop::fence_async_shared();
    hop::named_sync(1, hop::kThreads);

    // dv += pᵀ·do and dk += dsᵀ·q over this warpgroup's 128 columns, in
    // steps of 16 q: pᵀ and dsᵀ from shared memory (K-major), do and q
    // MN-major (boxes 2g and 2g + 1).
    const uint32_t p_addr = hop::smem_u32(pbuf);
    const uint32_t cols = 2 * g * C::kBoxQ;
    hop::wgmma_fence();
#pragma unroll
    for (int t = 0; t < C::BQ / 16; ++t) {
      const uint32_t row = t * 16 * B::kRow;
      hop::wgmma_ss<1>(dva, hop::desc_sw128(p_addr + 32 * t, 16, 1024),
                       hop::desc_box<D>(do_addr + cols + row, C::kBoxQ));
      hop::wgmma_ss<1>(dka,
                       hop::desc_sw128(p_addr + C::kPBytes + 32 * t, 16, 1024),
                       hop::desc_box<D>(q_addr + cols + row, C::kBoxQ));
    }
    hop::wgmma_commit();
    hop::wgmma_wait<0>();
    hop::fence_regs(dva);
    hop::fence_regs(dka);

    // The stage is free once this warp's products that read it are done;
    // warp 0 then refills it kStages blocks ahead.
    __syncwarp();
    if (lane == 0) hop::mbar_arrive(&empty[s]);
    if (warp == 0 && i + C::kStages < nblocks) {
      dkv_load_q<C>(smem, full, empty, tm_q, tm_do, lg, dg, bh, tq, qstart,
                    i + C::kStages, lane);
    }
  }

  bf16* dkg = dk + static_cast<size_t>(bh) * tk * D;
  bf16* dvg = dv + static_cast<size_t>(bh) * tk * D;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = h ? row1 : row0;
    if (row < tk) {
#pragma unroll
      for (int j = 0; j < C::kHalf / 8; ++j) {
        const size_t at =
            static_cast<size_t>(row) * D + C::kHalf * g + 8 * j + cq;
        *reinterpret_cast<uint32_t*>(dkg + at) =
            hop::pack_bf16(dka[4 * j + 2 * h], dka[4 * j + 2 * h + 1]);
        *reinterpret_cast<uint32_t*>(dvg + at) =
            hop::pack_bf16(dva[4 * j + 2 * h], dva[4 * j + 2 * h + 1]);
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(hop::kThreads, 1)
    flash_dkv_hopper(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     const __grid_constant__ CUtensorMap tm_do,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, int tq, int tk, int causal) {
  if constexpr (D == 256) {
    dkv_by_cols(&tm_q, &tm_k, &tm_v, &tm_do, lse, delta, dk, dv, tq, tk,
                causal);
  } else {
    dkv_by_rows<D>(&tm_q, &tm_k, &tm_v, &tm_do, lse, delta, dk, dv, tq, tk,
                   causal);
  }
}

template <int D>
int launch_dkv_hopper(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dk, void* dv, int bh, int tq, int tk, int causal,
                      cudaStream_t stream) {
  using C = HopDkvFor<D>;
  constexpr int kCols = C::B::kCols;
  // The maps hold the tensors' addresses, so they are made on every call.
  CUtensorMap mq, mk, mv, mdo;
  if (!hop::make_map(&mq, q, D, tq, bh, C::BQ, kCols) ||
      !hop::make_map(&mk, k, D, tk, bh, C::BK, kCols) ||
      !hop::make_map(&mv, v, D, tk, bh, C::BK, kCols) ||
      !hop::make_map(&mdo, dout, D, tq, bh, C::BQ, kCols)) {
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

// ---------------------------------------------- float32 Hopper design
// D 32, 64 and 128 (hopper_f32.cuh): q, k, v and do as three bf16 planes,
// every product six wgmma products.  k and v planes load once; q and do
// planes stream through a ring of kStages stages, with their lse and
// delta rows.  Per q block, sᵀ = k·qᵀ and dpᵀ = v·doᵀ by wgmma from shared
// memory, pᵀ and dsᵀ in registers, each split into three planes as the
// register A of dv += pᵀ·do and dk += dsᵀ·q (do and q MN-major).
// * D 64 and 128: one block per (bh, 64-row k block); both warpgroups
//   share its k and v planes and split the q blocks, warpgroup g taking
//   blocks qstart + g, qstart + g + 2, ... from a ring of its own
//   (refilled by its first warp), and each keeps partial dk and dv of all
//   64 rows in registers.  Their sums meet once, after the loop, in shared
//   memory.  Shared memory, k and v planes plus each warpgroup's stage of
//   q and do planes: D 128, 32-row q blocks: 96 KB + 2 x 48 KB = 192 KB;
//   D 64, 64-row q blocks: 48 KB + 2 x 48 KB = 144 KB (232,448 the cap).
// * D 32 (kByRows; 64-byte rows, the 64-byte swizzle): the bf16 design's
//   shape, one block per (bh, 128-row k block), each warpgroup owning 64
//   of its rows and their dk and dv, both taking every q block from one
//   ring of four 64-row stages that warp 0 refills once both have
//   released a stage (k and v planes 48 KB + 4 x 24 KB = 144 KB): half the
//   streamed bytes a row, and no final sum; on the card 5% faster than
//   alternating the q blocks (PERF.md).  Warpgroup 1 skips the causal start
//   block, which reaches warpgroup 0's rows only.  dk and dv are 16
//   registers a thread each, so the sums over T can be kept apart
//   against the tensor cores' round-toward-zero sums: every product's
//   hi·hi in accumulators of its own (kHiApart), and dk's and dv's
//   accumulators added into float32 sums, rounded to nearest, every
//   kFlush q blocks (F32DkvRoles flushes into device memory the same
//   way).  At T 8,192 their error against float64 was 1.2-1.3x the plain
//   version's without hi·hi apart and 4.0-4.4x without the flushes,
//   0.33-0.36x with both; neither cost a time the card could tell from
//   its noise (about 1%).
template <int D>
struct F32Dkv {
  using B = hop::Box<D>;
  static constexpr bool kByRows = D == 32;
  static constexpr bool kHiApart = D == 32;
  static constexpr int kFlush = D == 32 ? 8 : 0;  // 0: never
  static constexpr int kRings = kByRows ? 1 : 2;  // one a warpgroup, or shared
  static constexpr int BK = kByRows ? 128 : 64, BQ = D == 128 ? 32 : 64;
  static constexpr int kStages = kByRows ? 4 : 1;
  static constexpr uint32_t kBoxK = BK * B::kRow;  // one box, one plane
  static constexpr uint32_t kBoxQ = BQ * B::kRow;
  static constexpr uint32_t kKPlane = B::kBoxes * kBoxK;
  static constexpr uint32_t kQPlane = B::kBoxes * kBoxQ;
  static constexpr uint32_t kKBytes = 3 * kKPlane;  // k's three planes
  static constexpr uint32_t kQBytes = 3 * kQPlane;
  static constexpr size_t k = 0;
  static constexpr size_t v = kKBytes;
  // Ring r's stage s at qdo + (r·kStages + s)·2·kQBytes: q, then do.
  static constexpr size_t qdo = 2 * kKBytes;
  static constexpr size_t rows =  // lse, delta
      qdo + kRings * kStages * 2 * kQBytes;
  static constexpr size_t bars =
      rows + kRings * kStages * 2 * BQ * sizeof(float);
  // full and empty a stage of each ring, then k's and v's.
  static constexpr size_t bytes =
      bars + 8 * (2 * kRings * kStages + 1) + hop::kAtomBytes;
  static_assert(D == 32 || D == 64 || D == 128,
                "float32 planes at D 32, 64 and 128");
  static_assert(bytes <= kMaxSmem, "dkv tiles exceed shared memory");
  // Warpgroup 1's partial dk and dv pass through the idle rings.
  static_assert(kByRows || D * 4 * 128 <= 2 * kStages * 2 * kQBytes, "ring");
};

// D 32, 64 and 128: one block of two warpgroups per (bh, k block), the q
// blocks alternating between them or, with kByRows, taken by both
// (F32Dkv).
template <int D>
__device__ __forceinline__ void dkv_f32_by_blocks(
    const CUtensorMap* tm_q, const CUtensorMap* tm_k, const CUtensorMap* tm_v,
    const CUtensorMap* tm_do, const float* lse, const float* delta,
    float* dk, float* dv, int tq, int tk, int causal) {
  using C = F32Dkv<D>;
  using B = typename C::B;
  constexpr int BQ = C::BQ, S = C::kStages, R = C::kRings;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = hop::align_atom(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::bars);
  uint64_t* empty = full + R * S;
  uint64_t* kvbar = empty + R * S;

  // Plane p of head bh is head bh + p·nbh of the maps.
  const int bh = blockIdx.x, nbh = gridDim.x;
  // Early k blocks see the most causal q blocks: natural order runs the
  // heaviest first, over all heads.  The causal start is the first q
  // block that reaches k0: with 64-row k blocks every visited block
  // reaches the block's rows; with 128 (kByRows) the first reaches
  // warpgroup 0's rows only.
  const int k0 = blockIdx.y * C::BK;
  const int nq = (tq + BQ - 1) / BQ;
  const int qstart = causal ? k0 / BQ : 0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = warp / 4;
  // The warpgroup's blocks: every q block from qstart from the shared
  // ring (kByRows), or qstart + g, qstart + g + 2, ... from ring g.
  const int nblk = C::kByRows ? nq - qstart : (nq - qstart - g + 1) / 2;
  const int ring = C::kByRows ? 0 : g;
  const bool loader = C::kByRows ? warp == 0 : warp % 4 == 0;
  auto qblock = [&](int j) {
    return C::kByRows ? qstart + j : qstart + 2 * j + g;
  };

  if (threadIdx.x == 0) {
    for (int i = 0; i < R * S; ++i) {
      hop::mbar_init(&full[i], 1 + 32);  // the TMA's bytes + the warp's rows
      hop::mbar_init(&empty[i], 4 * (2 / R));  // the ring's warps
    }
    hop::mbar_init(kvbar, 1);
    hop::fence_barrier_init();
  }
  __syncthreads();

  // The warpgroup's j-th block into its ring's stage j % S, once the
  // ring's warps have released the block S before it: q and do by TMA
  // from lane 0, the lse and delta rows by cp.async from every lane (rows
  // past tq read as 0: their q and do rows are TMA zeros, and the mask
  // drops them).
  const float* lg = lse + static_cast<size_t>(bh) * tq;
  const float* dg = delta + static_cast<size_t>(bh) * tq;
  const CUtensorMap* mq = tm_q;
  const CUtensorMap* mdo = tm_do;
  auto load_q = [&](int j) {
    const int s = ring * S + j % S;
    const int qb = qblock(j);
    hop::mbar_wait(&empty[s], ((j / S) & 1) ^ 1);
    if (lane == 0) {
      hop::mbar_expect_tx(&full[s], 2 * C::kQBytes);
      unsigned char* qs = smem + C::qdo + s * 2 * C::kQBytes;
      for (int p = 0; p < 3; ++p) {
        for (int b = 0; b < B::kBoxes; ++b) {
          const uint32_t at = p * C::kQPlane + b * C::kBoxQ;
          hop::tma_load(qs + at, mq, &full[s], b * B::kCols, qb * BQ,
                        bh + p * nbh);
          hop::tma_load(qs + C::kQBytes + at, mdo, &full[s], b * B::kCols,
                        qb * BQ, bh + p * nbh);
        }
      }
    }
    float* rs = reinterpret_cast<float*>(smem + C::rows) + s * 2 * BQ;
    for (int c = lane; c < BQ; c += 32) {
      const int qi = qb * BQ + c;
      const uint32_t n = qi < tq ? 4 : 0;
      hop::cp_async_4(rs + c, lg + (n ? qi : 0), n);
      hop::cp_async_4(rs + BQ + c, dg + (n ? qi : 0), n);
    }
    hop::cp_async_arrive(&full[s]);
  };
  if (loader) {
    if (warp == 0 && lane == 0) {
      hop::mbar_expect_tx(kvbar, 2 * C::kKBytes);
      for (int p = 0; p < 3; ++p) {
        for (int b = 0; b < B::kBoxes; ++b) {
          const uint32_t at = p * C::kKPlane + b * C::kBoxK;
          hop::tma_load(smem + C::k + at, tm_k, kvbar, b * B::kCols, k0,
                        bh + p * nbh);
          hop::tma_load(smem + C::v + at, tm_v, kvbar, b * B::kCols, k0,
                        bh + p * nbh);
        }
      }
    }
    __syncwarp();
    for (int j = 0; j < S && j < nblk; ++j) load_q(j);
  }

  // Each warpgroup holds 64 k rows from kw (the block's, or with kByRows
  // its own half), r0 and r0 + 8 of each thread in the m64nNk16
  // accumulator layout.
  const int r0 = (warp % 4) * 16 + lane / 4;
  const int cq = 2 * (lane % 4);
  const int kw = k0 + (C::kByRows ? 64 * g : 0);
  const int row0 = kw + r0;
  const uint32_t rows_at = C::kByRows ? 64 * g * B::kRow : 0;
  const uint32_t k_addr = hop::smem_u32(smem + C::k) + rows_at;
  const uint32_t v_addr = hop::smem_u32(smem + C::v) + rows_at;

  // This warpgroup's parts of dk and dv: since the last flush (with
  // kHiApart their hi·hi products in hka and hva) and the flushed sums.
  float dka[D / 2], dva[D / 2], hka[D / 2], hva[D / 2];
  float dks[D / 2], dvs[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) {
    dka[i] = 0.f;
    dva[i] = 0.f;
    hka[i] = 0.f;
    hva[i] = 0.f;
    dks[i] = 0.f;
    dvs[i] = 0.f;
  }
  hop::mbar_wait(kvbar, 0);

  // The stage is free once this warp's products that read it are done;
  // the ring's loader then refills it S blocks ahead.
  auto release = [&](int j, int s) {
    __syncwarp();
    if (lane == 0) hop::mbar_arrive(&empty[s]);
    if (loader && j + S < nblk) load_q(j + S);
  };
  for (int j = 0; j < nblk; ++j) {
    const int s = ring * S + j % S;
    const int q0 = qblock(j) * BQ;
    hop::mbar_wait(&full[s], (j / S) & 1);
    if (C::kByRows && causal && q0 + BQ - 1 < kw) {
      // Every q of this block is before every k of this warpgroup.
      release(j, s);
      continue;
    }
    const uint32_t q_addr = hop::smem_u32(smem + C::qdo + s * 2 * C::kQBytes);
    const uint32_t do_addr = q_addr + C::kQBytes;
    const float* lse_s = reinterpret_cast<const float*>(smem + C::rows) + s * 2 * BQ;
    const float* dl_s = lse_s + BQ;

    float st[BQ / 2], dpt[BQ / 2];
    if constexpr (C::kHiApart) {
      float hs[BQ / 2], hd[BQ / 2];
      hop::wgmma_fence();
      hop::planes_ss<D>(st, hs, k_addr, C::kKPlane, C::kBoxK, q_addr,
                        C::kQPlane, C::kBoxQ);
      hop::planes_ss<D>(dpt, hd, v_addr, C::kKPlane, C::kBoxK, do_addr,
                        C::kQPlane, C::kBoxQ);
      hop::wgmma_commit();
      hop::wgmma_wait<0>();
      hop::fence_regs(st);
      hop::fence_regs(dpt);
      hop::fence_regs(hs);
      hop::fence_regs(hd);
#pragma unroll
      for (int i = 0; i < BQ / 2; ++i) {
        st[i] += hs[i];
        dpt[i] += hd[i];
      }
    } else {
      hop::wgmma_fence();
      hop::planes_ss<D>(st, k_addr, C::kKPlane, C::kBoxK, q_addr,
                        C::kQPlane, C::kBoxQ);
      hop::planes_ss<D>(dpt, v_addr, C::kKPlane, C::kBoxK, do_addr,
                        C::kQPlane, C::kBoxQ);
      hop::wgmma_commit();
      hop::wgmma_wait<0>();
      hop::fence_regs(st);
      hop::fence_regs(dpt);
    }
    dkv_probs(st, dpt, lse_s, dl_s,
              (causal && q0 < kw + 63) || kw + 64 > tk || q0 + BQ > tq, q0,
              0, row0, cq, tq, tk, causal);

    // dv += pᵀ·do and dk += dsᵀ·q: pᵀ's and dsᵀ's planes from registers,
    // do's and q's MN-major.
    uint32_t pa[3][BQ / 4], dsa[3][BQ / 4];
    hop::acc_to_a3(st, pa);
    hop::acc_to_a3(dpt, dsa);
    hop::wgmma_fence();
    if constexpr (C::kHiApart) {
      hop::planes_rs<D>(dva, hva, pa, do_addr, C::kQPlane, C::kBoxQ);
      hop::planes_rs<D>(dka, hka, dsa, q_addr, C::kQPlane, C::kBoxQ);
    } else {
      hop::planes_rs<D>(dva, pa, do_addr, C::kQPlane, C::kBoxQ);
      hop::planes_rs<D>(dka, dsa, q_addr, C::kQPlane, C::kBoxQ);
    }
    hop::wgmma_commit();
    hop::wgmma_wait<0>();
    hop::fence_regs(dva);
    hop::fence_regs(dka);
    if constexpr (C::kHiApart) {
      hop::fence_regs(hva);
      hop::fence_regs(hka);
    }
    if constexpr (C::kFlush > 0) {
      // Every kFlush blocks the accumulators add into the float32 sums,
      // rounded to nearest, and start again from 0.
      if ((j + 1) % C::kFlush == 0) {
#pragma unroll
        for (int i = 0; i < D / 2; ++i) {
          dks[i] += dka[i] + hka[i];
          dvs[i] += dva[i] + hva[i];
          dka[i] = 0.f;
          dva[i] = 0.f;
          hka[i] = 0.f;
          hva[i] = 0.f;
        }
      }
    }
    release(j, s);
  }
  if constexpr (C::kHiApart || C::kFlush > 0) {
#pragma unroll
    for (int i = 0; i < D / 2; ++i) {
      dka[i] = dks[i] + (dka[i] + hka[i]);
      dva[i] = dvs[i] + (dva[i] + hva[i]);
    }
  }

  // With kByRows each warpgroup stores its own rows.  Otherwise warpgroup
  // 1's partial dk and dv pass to warpgroup 0 through the rings, which no
  // load fills any more: thread t + 128 holds the same elements as t.
  const float* red = reinterpret_cast<const float*>(smem + C::qdo);
  const int t = threadIdx.x % 128;
  if constexpr (!C::kByRows) {
    hop::fence_async_shared();
    hop::named_sync(1, hop::kThreads);
    if (g == 1) {
      float* out = reinterpret_cast<float*>(smem + C::qdo);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) {
        out[i * 128 + t] = dka[i];
        out[(D / 2 + i) * 128 + t] = dva[i];
      }
    }
    hop::named_sync(1, hop::kThreads);
    if (g == 1) return;
  }
  float* dkg = dk + static_cast<size_t>(bh) * tk * D;
  float* dvg = dv + static_cast<size_t>(bh) * tk * D;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    if (row < tk) {
#pragma unroll
      for (int jc = 0; jc < D / 8; ++jc) {
        const int i = 4 * jc + 2 * h;
        const size_t at = static_cast<size_t>(row) * D + 8 * jc + cq;
        float2 xk = make_float2(dka[i], dka[i + 1]);
        float2 xv = make_float2(dva[i], dva[i + 1]);
        if constexpr (!C::kByRows) {
          xk.x += red[i * 128 + t];
          xk.y += red[(i + 1) * 128 + t];
          xv.x += red[(D / 2 + i) * 128 + t];
          xv.y += red[(D / 2 + i + 1) * 128 + t];
        }
        *reinterpret_cast<float2*>(dkg + at) = xk;
        *reinterpret_cast<float2*>(dvg + at) = xv;
      }
    }
  }
}

// D 256 (hopper_f32.cuh): dk and dv of 64 rows would take 256 registers
// a thread, and k and v as planes 192 KB of shared memory, so k and v
// stay float32 (F32Tile, 128 KB) and the two warpgroups split the work by
// role over the same q blocks of 32 rows, whose q and do planes stream
// through one stage (96 KB): both form sᵀ = k·qᵀ and dpᵀ = v·doᵀ, pᵀ and
// dsᵀ; warpgroup 0 owns dv += pᵀ·do, warpgroup 1 dk += dsᵀ·q, each its
// 64 x 256 accumulator in registers (128 a thread).  Handing pᵀ over
// instead of forming it twice does not fit in shared memory beside the
// stage, and a warpgroup that issued fewer products than the other
// would take a divergent path, on which ptxas serializes every wgmma.
// The k and v fragments are split in registers at every 16-column step
// (f32_rs_scores), as the register A of sᵀ and dpᵀ, q and do K-major.
// The products of sᵀ and dpᵀ are m64n32k16: at 16 rows (m64n16k16, two
// stages) the tensor cores spent about as long on each as on one of 32
// rows, so a stage of 32 rows whose load is not hidden came out ahead
// (PERF.md).  Warpgroup 1's first warp loads.  128 KB + 96 KB =
// 224 KB.
struct F32DkvRoles {
  using B = hop::Box<256>;
  using Tile = hop::F32Tile<256, 64>;
  static constexpr int D = 256, BK = 64, BQ = 32, kStages = 1;
  static constexpr int kLoader = 4;  // the warp that loads
  // q blocks summed in acc between flushes to device memory: the tensor
  // cores' accumulation drops the bits below the accumulator's last place
  // (it rounds toward zero), so six products a block added into one sum
  // over all of T lose up to an ulp each, all one way (at T 8,192 dv's
  // error against float64 was 16x the plain version's); the flushed
  // partial sums add in float32, rounded to nearest.
  static constexpr int kFlush = 8;
  static constexpr uint32_t kBoxQ = BQ * B::kRow;  // one box, one plane
  static constexpr uint32_t kQPlane = B::kBoxes * kBoxQ;
  static constexpr uint32_t kQBytes = 3 * kQPlane;
  static constexpr size_t k = 0;
  static constexpr size_t v = Tile::kBytes;
  static constexpr size_t qdo = 2 * Tile::kBytes;  // stage s: q, then do
  static constexpr size_t rows = qdo + kStages * 2 * kQBytes;  // lse, delta
  static constexpr size_t bars = rows + kStages * 2 * BQ * sizeof(float);
  static constexpr size_t bytes = bars + 8 * (2 * kStages + 1) + hop::kAtomBytes;
  static_assert(bytes <= kMaxSmem, "dkv tiles exceed shared memory");
};

__device__ __forceinline__ void dkv_f32_by_roles(
    const CUtensorMap* tm_q, const CUtensorMap* tm_k, const CUtensorMap* tm_v,
    const CUtensorMap* tm_do, const float* lse, const float* delta,
    float* dk, float* dv, int tq, int tk, int causal) {
  using C = F32DkvRoles;
  using B = C::B;
  constexpr int D = C::D, BQ = C::BQ, S = C::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = hop::align_atom(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::bars);
  uint64_t* empty = full + S;
  uint64_t* kvbar = empty + S;

  // Plane p of head bh is head bh + p·nbh of the q and do maps.
  const int bh = blockIdx.x, nbh = gridDim.x;
  // Early k blocks see the most causal q blocks: natural order runs the
  // heaviest first, over all heads.  The causal start is the first q
  // block that reaches k0, so every visited block reaches the block's
  // rows.
  const int k0 = blockIdx.y * C::BK;
  const int nq = (tq + BQ - 1) / BQ;
  const int qstart = causal ? k0 / BQ : 0;
  const int nblocks = nq - qstart;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = warp / 4;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      hop::mbar_init(&full[s], 1 + 32);  // the TMA's bytes + the warp's rows
      hop::mbar_init(&empty[s], hop::kWarps);
    }
    hop::mbar_init(kvbar, 1);
    hop::fence_barrier_init();
  }
  __syncthreads();

  // The i-th q block of the loop (block qstart + i) into stage i % S, once
  // both warpgroups have released the block S before it: q's and do's
  // planes by TMA from lane 0, the lse and delta rows by cp.async from
  // every lane (rows past tq read as 0: their q and do rows are TMA
  // zeros, and the mask drops them).
  const float* lg = lse + static_cast<size_t>(bh) * tq;
  const float* dg = delta + static_cast<size_t>(bh) * tq;
  auto load_q = [&](int i) {
    const int s = i % S;
    const int qb = qstart + i;
    hop::mbar_wait(&empty[s], ((i / S) & 1) ^ 1);
    if (lane == 0) {
      hop::mbar_expect_tx(&full[s], 2 * C::kQBytes);
      unsigned char* qs = smem + C::qdo + s * 2 * C::kQBytes;
      for (int p = 0; p < 3; ++p) {
        for (int b = 0; b < B::kBoxes; ++b) {
          const uint32_t at = p * C::kQPlane + b * C::kBoxQ;
          hop::tma_load(qs + at, tm_q, &full[s], b * B::kCols, qb * BQ,
                        bh + p * nbh);
          hop::tma_load(qs + C::kQBytes + at, tm_do, &full[s], b * B::kCols,
                        qb * BQ, bh + p * nbh);
        }
      }
    }
    float* rs = reinterpret_cast<float*>(smem + C::rows) + s * 2 * BQ;
    for (int c = lane; c < BQ; c += 32) {
      const int qi = qb * BQ + c;
      const uint32_t n = qi < tq ? 4 : 0;
      hop::cp_async_4(rs + c, lg + (n ? qi : 0), n);
      hop::cp_async_4(rs + BQ + c, dg + (n ? qi : 0), n);
    }
    hop::cp_async_arrive(&full[s]);
  };
  if (warp == C::kLoader) {
    if (lane == 0) {
      hop::mbar_expect_tx(kvbar, 2 * C::Tile::kBytes);
      hop::tma_load_f32<D, C::BK>(smem + C::k, tm_k, kvbar, k0, bh);
      hop::tma_load_f32<D, C::BK>(smem + C::v, tm_v, kvbar, k0, bh);
    }
    __syncwarp();
    for (int i = 0; i < S && i < nblocks; ++i) load_q(i);
  }

  // Both warpgroups hold the block's 64 k rows, r0 and r0 + 8 of each
  // thread in the m64nNk16 accumulator layout.
  const int r0 = (warp % 4) * 16 + lane / 4;
  const int cq = 2 * (lane % 4);
  const int row0 = k0 + r0;
  const float* kt = reinterpret_cast<const float*>(smem + C::k);
  const float* vt = reinterpret_cast<const float*>(smem + C::v);

  float acc[D / 2];  // dv (warpgroup 0) or dk (warpgroup 1) since a flush
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  // acc into this warpgroup's output rows (past tk: not stored), added to
  // what an earlier flush left there or not, then zeroed.  Each element
  // is this thread's alone, so its own earlier store is what it reads.
  float* out = (g ? dk : dv) + static_cast<size_t>(bh) * tk * D;
  auto flush = [&](bool add) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      if (row < tk) {
#pragma unroll
        for (int jc = 0; jc < D / 8; ++jc) {
          const int i = 4 * jc + 2 * h;
          float2* o = reinterpret_cast<float2*>(
              out + static_cast<size_t>(row) * D + 8 * jc + cq);
          float2 v = make_float2(acc[i], acc[i + 1]);
          if (add) {
            const float2 w = *o;
            v.x += w.x;
            v.y += w.y;
          }
          *o = v;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  };
  hop::mbar_wait(kvbar, 0);

  for (int i = 0; i < nblocks; ++i) {
    const int s = i % S;
    const int q0 = (qstart + i) * BQ;
    hop::mbar_wait(&full[s], (i / S) & 1);
    const uint32_t q_addr = hop::smem_u32(smem + C::qdo + s * 2 * C::kQBytes);
    const uint32_t do_addr = q_addr + C::kQBytes;
    const float* lse_s = reinterpret_cast<const float*>(smem + C::rows) + s * 2 * BQ;
    const float* dl_s = lse_s + BQ;

    // sᵀ and dpᵀ in both warpgroups (see F32DkvRoles).
    float st[BQ / 2], dpt[BQ / 2];
    hop::f32_rs_scores<D>(st, dpt, kt, vt, r0, cq, q_addr, do_addr,
                          C::kQPlane, C::kBoxQ);
    dkv_probs(st, dpt, lse_s, dl_s,
              (causal && q0 < k0 + 63) || k0 + 64 > tk || q0 + BQ > tq, q0,
              0, row0, cq, tq, tk, causal);

    // dv += pᵀ·do (warpgroup 0) or dk += dsᵀ·q (warpgroup 1): the A
    // operand's planes from registers, do's or q's MN-major.
    float a[BQ / 2];
#pragma unroll
    for (int j = 0; j < BQ / 2; ++j) a[j] = g ? dpt[j] : st[j];
    uint32_t pa[3][BQ / 4];
    hop::acc_to_a3(a, pa);
    hop::wgmma_fence();
    hop::planes_rs<D>(acc, pa, g ? q_addr : do_addr, C::kQPlane, C::kBoxQ);
    hop::wgmma_commit();
    hop::wgmma_wait<0>();
    hop::fence_regs(acc);

    // Every kFlush blocks, and after the last, the sum so far goes to
    // device memory (stored by the first flush, added by the later ones)
    // and acc starts again from 0 (F32DkvRoles).
    if ((i + 1) % C::kFlush == 0 || i + 1 == nblocks) {
      flush(i + 1 > C::kFlush);
    }

    // The stage is free once this warp's products that read it are done;
    // the loader then refills it S blocks ahead.
    __syncwarp();
    if (lane == 0) hop::mbar_arrive(&empty[s]);
    if (warp == C::kLoader && i + S < nblocks) load_q(i + S);
  }
  // A k block that no q block reaches (causal, tq < tk) has gradients 0.
  if (nblocks <= 0) flush(false);
}

// The launch's layout for head dim D.
template <int D>
using F32DkvFor =
    typename std::conditional<D == 256, F32DkvRoles, F32Dkv<D>>::type;

template <int D>
__global__ void __launch_bounds__(hop::kThreads, 1)
    flash_dkv_hopper_f32(const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v,
                         const __grid_constant__ CUtensorMap tm_do,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         float* __restrict__ dk, float* __restrict__ dv,
                         int tq, int tk, int causal) {
  if constexpr (D == 256) {
    dkv_f32_by_roles(&tm_q, &tm_k, &tm_v, &tm_do, lse, delta, dk, dv, tq, tk,
                     causal);
  } else {
    dkv_f32_by_blocks<D>(&tm_q, &tm_k, &tm_v, &tm_do, lse, delta, dk, dv, tq,
                         tk, causal);
  }
}

// The float32 launch's planes (k's and v's too but at D 256, where their
// float32 rows get maps of their own) split on the stream into the
// scratch, and the maps over them in m.
template <int D>
int split_dkv_f32(Planes& m, const void* q, const void* k, const void* v,
                  const void* dout, void* planes, size_t planes_n, int bh,
                  int tq, int tk, cudaStream_t stream) {
  using C = F32DkvFor<D>;
  if constexpr (D == 256) {
    const int rc = m.split(q, nullptr, nullptr, dout, planes, planes_n, D,
                           bh, tq, tk, C::BQ, C::BK, stream);
    if (rc != 0) return rc;
    return make_map_f32(&m.k, k, D, tk, bh, C::BK) &&
                   make_map_f32(&m.v, v, D, tk, bh, C::BK)
               ? 0
               : MVT_TMA_REFUSED;
  } else {
    return m.split(q, k, v, dout, planes, planes_n, D, bh, tq, tk, C::BQ,
                   C::BK, stream);
  }
}

template <int D>
int launch_dkv_f32(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* dk, void* dv, void* planes, size_t planes_n, int bh,
                   int tq, int tk, int causal, cudaStream_t stream) {
  using C = F32DkvFor<D>;
  Planes m;
  const int rc = split_dkv_f32<D>(m, q, k, v, dout, planes, planes_n, bh, tq,
                                  tk, stream);
  if (rc != 0) return rc;
  auto kernel = flash_dkv_hopper_f32<D>;
  static bool smem_set = false;
  cudaError_t err = allow_smem(kernel, C::bytes, &smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(bh, (tk + C::BK - 1) / C::BK);
  kernel<<<grid, hop::kThreads, C::bytes, stream>>>(
      m.q, m.k, m.v, m.dout, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(dk),
      static_cast<float*>(dv), tq, tk, causal);
  return static_cast<int>(cudaGetLastError());
}

// The design is fixed by (dtype, D) at compile time: bf16 runs the Hopper
// design above at every D, float32 the plane design (k and v float32 at
// D 256).
template <typename T>
int dkv_for_dim(int d, const void* q, const void* k, const void* v,
                const void* dout, const void* lse, const void* delta,
                void* dk, void* dv, void* planes, size_t planes_n, int bh,
                int tq, int tk, int causal, cudaStream_t s) {
  if constexpr (std::is_same<T, float>::value) {
    switch (d) {
      case 32: return launch_dkv_f32<32>(q, k, v, dout, lse, delta, dk, dv, planes, planes_n, bh, tq, tk, causal, s);
      case 64: return launch_dkv_f32<64>(q, k, v, dout, lse, delta, dk, dv, planes, planes_n, bh, tq, tk, causal, s);
      case 128: return launch_dkv_f32<128>(q, k, v, dout, lse, delta, dk, dv, planes, planes_n, bh, tq, tk, causal, s);
      case 256: return launch_dkv_f32<256>(q, k, v, dout, lse, delta, dk, dv, planes, planes_n, bh, tq, tk, causal, s);
      default: return MVT_UNSUPPORTED;
    }
  } else {
    switch (d) {
      case 32: return launch_dkv_hopper<32>(q, k, v, dout, lse, delta, dk, dv, bh, tq, tk, causal, s);
      case 64: return launch_dkv_hopper<64>(q, k, v, dout, lse, delta, dk, dv, bh, tq, tk, causal, s);
      case 128: return launch_dkv_hopper<128>(q, k, v, dout, lse, delta, dk, dv, bh, tq, tk, causal, s);
      case 256: return launch_dkv_hopper<256>(q, k, v, dout, lse, delta, dk, dv, bh, tq, tk, causal, s);
      default: return MVT_UNSUPPORTED;
    }
  }
}

}  // namespace mvt

// q (pre-scaled), k, v, dout: [bh, T, d]; lse, delta: [bh, tq] float;
// dk, dv: [bh, tk, d].  planes: the float32 plane design's scratch,
// 6·bh·(tq + tk)·d bf16 at D 32, 64 and 128, 6·bh·tq·d at D 256
// (hopper_f32.cuh); null for a bf16 launch.  planes_n: its size in
// bf16 elements (a smaller one than the launch needs: MVT_SCRATCH_SHORT).
extern "C" int mvt_flash_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, void* dk, void* dv,
                             void* planes, size_t planes_n, int bh, int tq,
                             int tk, int d, int dtype, int causal,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == MVT_DTYPE_F32) {
    return mvt::dkv_for_dim<float>(d, q, k, v, dout, lse, delta, dk, dv,
                                   planes, planes_n, bh, tq, tk, causal, s);
  }
  if (dtype == MVT_DTYPE_BF16) {
    return mvt::dkv_for_dim<__nv_bfloat16>(d, q, k, v, dout, lse, delta, dk,
                                           dv, planes, planes_n, bh, tq, tk,
                                           causal, s);
  }
  return MVT_UNSUPPORTED;
}

// The split of a float32 mvt_flash_dkv launch alone, on the same operands
// and scratch, with no kernel after it: what the launch spends before its
// kernel starts, timed apart.
extern "C" int mvt_plane_split(const void* q, const void* k, const void* v,
                               const void* dout, void* planes,
                               size_t planes_n, int bh, int tq, int tk,
                               int d, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  mvt::Planes m;
  switch (d) {
    case 32: return mvt::split_dkv_f32<32>(m, q, k, v, dout, planes, planes_n, bh, tq, tk, s);
    case 64: return mvt::split_dkv_f32<64>(m, q, k, v, dout, planes, planes_n, bh, tq, tk, s);
    case 128: return mvt::split_dkv_f32<128>(m, q, k, v, dout, planes, planes_n, bh, tq, tk, s);
    case 256: return mvt::split_dkv_f32<256>(m, q, k, v, dout, planes, planes_n, bh, tq, tk, s);
    default: return MVT_UNSUPPORTED;
  }
}
