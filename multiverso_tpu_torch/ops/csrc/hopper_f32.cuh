// The float32 flash kernels on the bf16 tensor cores (flash_fwd.cu,
// flash_dq.cu and flash_dkv.cu at D 32, 64, 128 and 256): float32 as
// three bf16 planes, six wgmma products a product.
//
// A float32 x splits into hi = bf16(x), mid = bf16(x - hi) and
// lo = bf16(x - hi - mid), each rounded to nearest; both differences are
// exact in float32, and the three pieces carry all 24 bits of x's
// mantissa (hi + mid + lo == x for every normal x whose lo stays above
// bf16's underflow).  A product a·b then runs as
//   a0·b0 + a0·b1 + a1·b0 + a0·b2 + a1·b1 + a2·b0
// into the float32 wgmma accumulator: every bf16 product is exact, and
// the three terms left out (a1·b2, a2·b1, a2·b2) are of order 2^-24 of
// a·b.  Six bf16 products at 989 TFLOP/s cost what 3xTF32 costs at 495,
// and keep every operand layout of the bf16 designs (hopper.cuh): TMA
// boxes of bf16 rows, K-major or MN-major descriptors, accumulators fed
// back as register A operands.
//
// flash_split3 splits the float32 operands into their planes in device
// memory before each launch, into scratch the wrapper allocates: [3, bh,
// T, D] bf16 a tensor, plane p of head b at head index p·bh + b, so one
// 3-D TMA map (D, T, 3·bh) reads all three.  It replaces no TPU kernel:
// the Pallas kernels take float32 operands whole.  It is bound by bytes
// (4 read and 6 written an element).  At D 32, 64 and 128 it splits every
// operand it is given (q, k, v, and do for dq and dk/dv).  Each library's
// mvt_plane_split runs a launch's split alone, so that it can be timed
// apart from the kernel.  At D 256 planes of the
// stationary rows (q for the forward, q and do for dq, k and v for dk/dv)
// would take 192 KB of shared memory, so they stay float32 (F32Tile: 128
// KB for two 64-row tiles) and each thread splits its A fragment in
// registers at every 16-column step of D (f32_rs_products), by the same
// split3_pair as flash_split3, so the planes agree bit for bit; only the
// streamed operands (k and v for the forward and dq, q and do for dk/dv)
// are split in device memory.
//
// The tensor cores drop the bits of a sum below its last place (they
// round toward zero).  Where a sum runs long, its largest plane product,
// hi·hi, sums in an accumulator of its own, apart from the five smaller
// ones, which stay about 2^-8 of the result (f32_rs_products at D 256;
// planes_ss and planes_rs given a second accumulator at D 32), and the
// sums of T-long gradients are flushed into float32 sums, rounded to
// nearest, every few blocks.
#pragma once

#include "flash_common.cuh"
#include "hopper.cuh"

namespace mvt {
namespace hop {

// (a plane, b plane) of product i of the six, the largest last:
// (2, 0), (1, 1), (0, 2), (1, 0), (0, 1), (0, 0).
constexpr int kPairs = 6;
__host__ __device__ constexpr int pair_a(int i) {
  return i == 0 ? 2 : (i == 1 || i == 3) ? 1 : 0;
}
__host__ __device__ constexpr int pair_b(int i) {
  return i == 2 ? 2 : (i == 1 || i == 4) ? 1 : 0;
}

// hi, mid and lo of two floats, packed as bf16 pairs.
__device__ __forceinline__ void split3_pair(float x0, float x1, uint32_t& h,
                                            uint32_t& m, uint32_t& l) {
  const __nv_bfloat162 hi = __floats2bfloat162_rn(x0, x1);
  const float r0 = x0 - __low2float(hi), r1 = x1 - __high2float(hi);
  const __nv_bfloat162 mid = __floats2bfloat162_rn(r0, r1);
  const __nv_bfloat162 lo = __floats2bfloat162_rn(r0 - __low2float(mid),
                                                  r1 - __high2float(mid));
  h = *reinterpret_cast<const uint32_t*>(&hi);
  m = *reinterpret_cast<const uint32_t*>(&mid);
  l = *reinterpret_cast<const uint32_t*>(&lo);
}

// acc_to_a in three planes: a[p] is plane p of the accumulator as the
// register A operand of the next product.
template <int N>
__device__ __forceinline__ void acc_to_a3(const float (&acc)[N],
                                          uint32_t (&a)[3][N / 2]) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    split3_pair(acc[2 * i], acc[2 * i + 1], a[0][i], a[1][i], a[2][i]);
  }
}

// acc = A·Bᵀ over D in steps of 16, both operands K-major Box<D> tiles of
// three planes each: A's plane p at a_addr + p·a_plane, its boxes of
// columns a_box apart; B's likewise.  Overwrites acc (the first product
// reads nothing); with kApart the largest pair, hi·hi, goes to hi
// instead (overwritten too), and the caller adds it to acc once the
// products are done.  The caller fences before and commits after.
template <int D, bool kApart, int N>
__device__ __forceinline__ void planes_ss_in(float (&acc)[N], float (&hi)[N],
                                             uint32_t a_addr,
                                             uint32_t a_plane,
                                             uint32_t a_box, uint32_t b_addr,
                                             uint32_t b_plane,
                                             uint32_t b_box) {
  using B = Box<D>;
#pragma unroll
  for (int x = 0; x < D / 16; ++x) {
    const uint32_t at = (x % B::kSteps) * 32;
    const uint32_t ac = a_addr + (x / B::kSteps) * a_box + at;
    const uint32_t bc = b_addr + (x / B::kSteps) * b_box + at;
#pragma unroll
    for (int i = 0; i < kPairs; ++i) {
      const uint64_t da = desc_box<D>(ac + pair_a(i) * a_plane, 16);
      const uint64_t db = desc_box<D>(bc + pair_b(i) * b_plane, 16);
      const bool to_hi = kApart && i == kPairs - 1;
      float(&d)[N] = to_hi ? hi : acc;
      if (x == 0 && (i == 0 || to_hi)) {
        wgmma_ss_first(d, da, db);
      } else {
        wgmma_ss(d, da, db);
      }
    }
  }
}
template <int D, int N>
__device__ __forceinline__ void planes_ss(float (&acc)[N], uint32_t a_addr,
                                          uint32_t a_plane, uint32_t a_box,
                                          uint32_t b_addr, uint32_t b_plane,
                                          uint32_t b_box) {
  planes_ss_in<D, false>(acc, acc, a_addr, a_plane, a_box, b_addr, b_plane,
                         b_box);
}
template <int D, int N>
__device__ __forceinline__ void planes_ss(float (&acc)[N], float (&hi)[N],
                                          uint32_t a_addr, uint32_t a_plane,
                                          uint32_t a_box, uint32_t b_addr,
                                          uint32_t b_plane, uint32_t b_box) {
  planes_ss_in<D, true>(acc, hi, a_addr, a_plane, a_box, b_addr, b_plane,
                        b_box);
}

// acc += A·B over RA / 4 steps of 16 rows of B: A the register planes a
// (acc_to_a3), B MN-major Box<D> tiles of three planes, plane p at
// b_addr + p·b_plane, its boxes of columns b_box apart.  Given hi, the
// largest pair, hi·hi, adds into hi instead of acc.
template <int D, int RA, int N>
__device__ __forceinline__ void planes_rs(float (&acc)[N], float (&hi)[N],
                                          const uint32_t (&a)[3][RA],
                                          uint32_t b_addr, uint32_t b_plane,
                                          uint32_t b_box) {
#pragma unroll
  for (int t = 0; t < RA / 4; ++t) {
#pragma unroll
    for (int i = 0; i < kPairs; ++i) {
      const uint32_t* f = &a[pair_a(i)][4 * t];
      float(&d)[N] = i == kPairs - 1 ? hi : acc;
      wgmma_rs(d, f[0], f[1], f[2], f[3],
               desc_box<D>(b_addr + pair_b(i) * b_plane +
                               t * 16 * Box<D>::kRow,
                           b_box));
    }
  }
}
template <int D, int RA, int N>
__device__ __forceinline__ void planes_rs(float (&acc)[N],
                                          const uint32_t (&a)[3][RA],
                                          uint32_t b_addr, uint32_t b_plane,
                                          uint32_t b_box) {
  planes_rs<D>(acc, acc, a, b_addr, b_plane, b_box);
}

// A float32 [rows, D] tile in shared memory as its fragment loads want it:
// D / 8 groups of 8 columns, each [rows, 8] floats (32-byte rows), loaded
// by TMA one [rows, 8] box a group (make_map_f32).  A warp's fragment load
// (8 rows, 2 floats a thread at columns cq, cq + 1) then reads 256
// contiguous bytes, free of bank conflicts; a 1,024-byte row stride would
// put every row of it in the same banks.
template <int D, int Rows>
struct F32Tile {
  static constexpr int kGroups = D / 8;
  static constexpr uint32_t kGroupBytes = Rows * 8 * 4;
  static constexpr uint32_t kBytes = kGroups * kGroupBytes;
};

// Rows [t0, t0 + Rows) of head b of a float32 map into an F32Tile at dst,
// counted on bar (the caller announces F32Tile::kBytes).  One thread.
template <int D, int Rows>
__device__ __forceinline__ void tma_load_f32(unsigned char* dst,
                                             const CUtensorMap* map,
                                             uint64_t* bar, int t0, int b) {
  using T = F32Tile<D, Rows>;
  for (int c = 0; c < T::kGroups; ++c) {
    tma_load(dst + c * T::kGroupBytes, map, bar, 8 * c, t0, b);
  }
}

// s[n] = A_n·B_nᵀ for each of NP products (the forward's s alone; s and
// dp of a block, or sᵀ and dpᵀ), over D in steps of 16, m64nNk16
// products (each s[n] float[N / 2]) with their steps interleaved: A_n a
// float32 F32Tile of 64 rows at tile[n], of which this thread's fragment
// (rows r0 and r0 + 8, columns cq, cq + 1, cq + 8, cq + 9 of each step) is
// loaded and split into three register planes at every step; B_n a
// K-major Box<D> tile of three planes (N rows of keys or queries), plane p
// at b[n] + p·b_plane, its boxes of columns b_box apart.  The tensor
// cores drop the bits of a sum below its last place (they round toward
// zero), so each product's largest plane product, hi·hi, sums apart from
// the five smaller ones, which stay about 2^-8 of the result: the two
// sums lose 16 truncations at full size between them, not 96, and meet
// once in float32.  Each step's products form one commit group; with at
// most 16 accumulator registers a thread over all NP products two steps
// are in flight while the next one's fragments are split, with more one.
// Returns with every product done.
template <int D, int NP, int W>
__device__ __forceinline__ void f32_rs_products(
    float (&s)[NP][W], const float* const (&tile)[NP], int r0, int cq,
    const uint32_t (&b)[NP], uint32_t b_plane, uint32_t b_box) {
  using B = Box<D>;
  constexpr int kGroup = F32Tile<D, 64>::kGroupBytes / 4;  // floats
  constexpr int kFlight = NP * W <= 16 ? 2 : 1;
  float h[NP][W];  // the hi·hi sums
#pragma unroll
  for (int n = 0; n < NP; ++n) {
#pragma unroll
    for (int i = 0; i < W; ++i) {
      s[n][i] = 0.f;
      h[n][i] = 0.f;
    }
  }
#pragma unroll
  for (int x = 0; x < D / 16; ++x) {
    uint32_t a[NP][3][4];
#pragma unroll
    for (int n = 0; n < NP; ++n) {
      const float* lo = tile[n] + 2 * x * kGroup + r0 * 8 + cq;  // 16x..
      const float* hi = lo + kGroup;                             // 16x + 8..
      const float2 f[4] = {*reinterpret_cast<const float2*>(lo),
                           *reinterpret_cast<const float2*>(lo + 64),
                           *reinterpret_cast<const float2*>(hi),
                           *reinterpret_cast<const float2*>(hi + 64)};
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        split3_pair(f[r].x, f[r].y, a[n][0][r], a[n][1][r], a[n][2][r]);
      }
    }
    const uint32_t at = (x / B::kSteps) * b_box + (x % B::kSteps) * 32;
    wgmma_fence();
#pragma unroll
    for (int i = 0; i < kPairs - 1; ++i) {
#pragma unroll
      for (int n = 0; n < NP; ++n) {
        const uint32_t* f = a[n][pair_a(i)];
        wgmma_rs<0>(s[n], f[0], f[1], f[2], f[3],
                    desc_box<D>(b[n] + at + pair_b(i) * b_plane, 16));
      }
    }
#pragma unroll
    for (int n = 0; n < NP; ++n) {  // hi·hi, the last pair
      const uint32_t* f = a[n][0];
      wgmma_rs<0>(h[n], f[0], f[1], f[2], f[3], desc_box<D>(b[n] + at, 16));
    }
    wgmma_commit();
    wgmma_wait<kFlight - 1>();
  }
  wgmma_wait<0>();
#pragma unroll
  for (int n = 0; n < NP; ++n) fence_regs(s[n]);
#pragma unroll
  for (int n = 0; n < NP; ++n) fence_regs(h[n]);
#pragma unroll
  for (int n = 0; n < NP; ++n) {
#pragma unroll
    for (int i = 0; i < W; ++i) s[n][i] += h[n][i];
  }
}

// s0 = A0·B0ᵀ and s1 = A1·B1ᵀ by f32_rs_products: s and dp of a block (dq),
// or sᵀ and dpᵀ (dk/dv).
template <int D, int W>
__device__ __forceinline__ void f32_rs_scores(float (&s0)[W], float (&s1)[W],
                                              const float* t0,
                                              const float* t1, int r0,
                                              int cq, uint32_t b0,
                                              uint32_t b1, uint32_t b_plane,
                                              uint32_t b_box) {
  const float* const tile[2] = {t0, t1};
  const uint32_t b[2] = {b0, b1};
  float s[2][W];
  f32_rs_products<D>(s, tile, r0, cq, b, b_plane, b_box);
#pragma unroll
  for (int i = 0; i < W; ++i) {
    s0[i] = s[0][i];
    s1[i] = s[1][i];
  }
}

}  // namespace hop

// The planes of n floats (n a multiple of 4): plane p at out + p·n.
__global__ void __launch_bounds__(256)
    flash_split3(const float4* __restrict__ x, uint2* __restrict__ out,
                 size_t n4) {
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
       i < n4; i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const float4 v = x[i];
    uint2 h, m, l;
    hop::split3_pair(v.x, v.y, h.x, m.x, l.x);
    hop::split3_pair(v.z, v.w, h.y, m.y, l.y);
    out[i] = h;
    out[n4 + i] = m;
    out[2 * n4 + i] = l;
  }
}

inline int launch_split3(const void* x, void* out, size_t n,
                         cudaStream_t stream) {
  if (reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0 || n % 4 != 0) {
    return MVT_TMA_REFUSED;
  }
  const size_t n4 = n / 4;
  const size_t blocks = n4 / 256 + 1;
  flash_split3<<<static_cast<unsigned>(blocks < 8192 ? blocks : 8192), 256,
                 0, stream>>>(static_cast<const float4*>(x),
                              static_cast<uint2*>(out), n4);
  return static_cast<int>(cudaGetLastError());
}

// A float32 [bh, t, d] tensor as a 3-D map (d, t, bh) read in [rows, 8]
// boxes, unswizzled: the groups of an F32Tile.  Rows past t read as
// zeros.  False if cuTensorMapEncodeTiled refuses the map.
inline bool make_map_f32(CUtensorMap* map, const void* base, int d, int t,
                         int bh, int rows) {
  hop::EncodeTiledFn encode = hop::encode_tiled();
  if (encode == nullptr || reinterpret_cast<uintptr_t>(base) % 16 != 0) {
    return false;
  }
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(t),
                              static_cast<cuuint64_t>(bh)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d) * 4,
                                 static_cast<cuuint64_t>(t) * d * 4};
  const cuuint32_t box[3] = {8, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
                const_cast<void*>(base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The float32 operands' planes in the wrapper's scratch, three a tensor
// in the order q, do, k, v, of the operands given (a null one is not
// split: the forward passes no do, so 3·(nq + 2·nk) bf16; dq and dk/dv
// at D 32, 64 and 128 all four, 6·(nq + nk); at D 256 the forward and dq
// only k and v, 6·nk, dk/dv only q and do, 6·nq), split on the stream,
// and a TMA map over each in boxes of qrows (q, do) or krows (k, v) rows
// of Box<D>'s columns (32 with the 64-byte swizzle at D 32, 64 with the
// 128-byte one above).  ``cap`` is the scratch's size in bf16 elements: a
// launch that needs more writes nothing and returns MVT_SCRATCH_SHORT.
struct Planes {
  CUtensorMap q, k, v, dout;

  int split(const void* qp, const void* kp, const void* vp,
            const void* dop, void* scratch, size_t cap, int d, int bh,
            int tq, int tk, int qrows, int krows, cudaStream_t stream) {
    if (scratch == nullptr) return MVT_NO_SCRATCH;
    const void* src[4] = {qp, dop, kp, vp};
    CUtensorMap* maps[4] = {&q, &dout, &k, &v};
    size_t need = 0;
    for (int i = 0; i < 4; ++i) {
      if (src[i] != nullptr) {
        need += 3 * static_cast<size_t>(bh) * (i < 2 ? tq : tk) * d;
      }
    }
    if (need > cap) return MVT_SCRATCH_SHORT;
    bf16* at = static_cast<bf16*>(scratch);
    for (int i = 0; i < 4; ++i) {
      if (src[i] == nullptr) continue;
      const int t = i < 2 ? tq : tk;
      const size_t n = static_cast<size_t>(bh) * t * d;
      const int rc = launch_split3(src[i], at, n, stream);
      if (rc != 0) return rc;
      if (!hop::make_map(maps[i], at, d, t, 3 * bh, i < 2 ? qrows : krows,
                         d < hop::kBoxCols ? d : hop::kBoxCols)) {
        return MVT_TMA_REFUSED;
      }
      at += 3 * n;
    }
    return 0;
  }
};

}  // namespace mvt
