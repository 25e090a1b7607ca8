// The float32 flash kernels on the bf16 tensor cores (flash_fwd.cu,
// flash_dq.cu and flash_dkv.cu at D 64 and 128): float32 as three bf16
// planes, six wgmma products a product.
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
// flash_split3 splits the float32 operands (q, k, v, and do for dq and
// dk/dv) into their planes in device memory before each launch, into
// scratch the wrapper allocates: [3, bh, T, D] bf16 a tensor, plane p of
// head b at head index p·bh + b, so one 3-D TMA map (D, T, 3·bh) reads
// all three.  It replaces no TPU kernel: the Pallas kernels take float32
// operands whole.  It is bound by bytes (4 read and 6 written an
// element).
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
// reads nothing); the caller fences before and commits after.
template <int D, int N>
__device__ __forceinline__ void planes_ss(float (&acc)[N], uint32_t a_addr,
                                          uint32_t a_plane, uint32_t a_box,
                                          uint32_t b_addr, uint32_t b_plane,
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
      if (x == 0 && i == 0) {
        wgmma_ss_first(acc, da, db);
      } else {
        wgmma_ss(acc, da, db);
      }
    }
  }
}

// acc += A·B over RA / 4 steps of 16 rows of B: A the register planes a
// (acc_to_a3), B MN-major Box<D> tiles of three planes, plane p at
// b_addr + p·b_plane, its boxes of columns b_box apart.
template <int D, int RA, int N>
__device__ __forceinline__ void planes_rs(float (&acc)[N],
                                          const uint32_t (&a)[3][RA],
                                          uint32_t b_addr, uint32_t b_plane,
                                          uint32_t b_box) {
#pragma unroll
  for (int t = 0; t < RA / 4; ++t) {
#pragma unroll
    for (int i = 0; i < kPairs; ++i) {
      const uint32_t* f = &a[pair_a(i)][4 * t];
      wgmma_rs(acc, f[0], f[1], f[2], f[3],
               desc_box<D>(b_addr + pair_b(i) * b_plane +
                               t * 16 * Box<D>::kRow,
                           b_box));
    }
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

// The float32 operands' planes in the wrapper's scratch, three a tensor
// in the order q, do, k, v (6·(nq + nk) bf16 for dq and dk/dv; the
// forward passes no do, so 3·(nq + 2·nk)), split on the stream, and a TMA
// map over each in boxes of qrows (q, do) or krows (k, v) rows.
struct Planes {
  CUtensorMap q, k, v, dout;

  int split(const void* qp, const void* kp, const void* vp,
            const void* dop, void* scratch, int d, int bh, int tq, int tk,
            int qrows, int krows, cudaStream_t stream) {
    if (scratch == nullptr) return MVT_NO_SCRATCH;
    const void* src[4] = {qp, dop, kp, vp};
    CUtensorMap* maps[4] = {&q, &dout, &k, &v};
    bf16* at = static_cast<bf16*>(scratch);
    for (int i = 0; i < 4; ++i) {
      if (src[i] == nullptr) continue;
      const int t = i < 2 ? tq : tk;
      const size_t n = static_cast<size_t>(bh) * t * d;
      const int rc = launch_split3(src[i], at, n, stream);
      if (rc != 0) return rc;
      if (!hop::make_map(maps[i], at, d, t, 3 * bh, i < 2 ? qrows : krows)) {
        return MVT_TMA_REFUSED;
      }
      at += 3 * n;
    }
    return 0;
  }
};

}  // namespace mvt
