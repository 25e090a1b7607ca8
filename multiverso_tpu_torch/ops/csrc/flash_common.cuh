// Shared pieces of the Hopper flash-attention kernels (flash_fwd.cu,
// flash_dq.cu, flash_dkv.cu): shared-memory tile staging, the three tile
// products, and the plain-C error helper every library exports.
//
// Conventions shared with multiverso_tpu/ops/flash_attention.py:
//   q, k, v, do are [bh, T, D] row-major in T (float or bf16), q arrives
//   PRE-SCALED by the softmax scale; lse and delta are [bh, T] float.
//   Scores, softmax statistics and accumulators are float32.
//
// Design of the first port's kernels, which float32 at every D and bf16
// at D 32 and 256 still run (bf16 at D 64 and 128 runs the Hopper
// designs of hopper.cuh): one thread block of kThreads threads per (bh,
// row block).  Every operand tile is staged in shared memory with a
// padded leading dimension; every product reads its operands from shared
// memory and accumulates in float32 shared memory.  bf16 products run on
// the tensor cores through WMMA 16x16x16 fragments (float32 accumulate);
// float32 products run as plain FMAs, so float32 results keep full
// float32 precision (no TF32).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

namespace mvt {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kNeg = -1e30f;  // finite mask sentinel, as in the JAX kernel
// Dynamic shared memory one block may use on Hopper (227 KB).
constexpr size_t kMaxSmem = 232448;

__host__ __device__ constexpr size_t align128(size_t x) {
  return (x + 127) & ~static_cast<size_t>(127);
}

// Leading dimension of a staged tile of N columns: padded by 16 bytes so
// consecutive rows start on different banks; stays a multiple of 16
// bytes (WMMA ldm rule: 8 bf16 or 4 float elements).
template <typename T, int N>
struct Ld {
  static constexpr int value = N + static_cast<int>(16 / sizeof(T));
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's cast
}

// True where a (query, key) pair is excluded: beyond either length, or
// above the diagonal under the causal mask.
__device__ __forceinline__ bool masked_out(int qp, int kp, int tq, int tk,
                                           int causal) {
  return kp >= tk || qp >= tq || (causal && kp > qp);
}

// Rows [row0, row0 + ROWS) of a [n, COLS] matrix into a shared tile with
// leading dimension LD; rows at or past n read as zero.  16-byte vector
// loads: COLS * sizeof(T) is a multiple of 16 for every supported D.
template <typename T, int ROWS, int COLS, int LD>
__device__ __forceinline__ void load_rows(T* __restrict__ dst,
                                          const T* __restrict__ src,
                                          int row0, int n) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kChunks = COLS / kVec;
  for (int c = threadIdx.x; c < ROWS * kChunks; c += kThreads) {
    const int r = c / kChunks;
    const int col = (c - r * kChunks) * kVec;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n) {
      val = *reinterpret_cast<const uint4*>(
          src + static_cast<size_t>(row0 + r) * COLS + col);
    }
    *reinterpret_cast<uint4*>(dst + r * LD + col) = val;
  }
}

template <int ROWS>
__device__ __forceinline__ void load_vec(float* __restrict__ dst,
                                         const float* __restrict__ src,
                                         int row0, int n) {
  for (int r = threadIdx.x; r < ROWS; r += kThreads) {
    dst[r] = (row0 + r < n) ? src[row0 + r] : 0.f;
  }
}

template <int ROWS, int COLS, int LD>
__device__ __forceinline__ void zero_acc(float* __restrict__ acc) {
  for (int i = threadIdx.x; i < ROWS * COLS; i += kThreads) {
    acc[(i / COLS) * LD + i % COLS] = 0.f;
  }
}

// Reduction over the TPR consecutive lanes that share one row.
template <int TPR>
__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int off = TPR / 2; off > 0; off >>= 1) {
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  }
  return x;
}
template <int TPR>
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int off = TPR / 2; off > 0; off >>= 1) {
    x += __shfl_xor_sync(0xffffffffu, x, off);
  }
  return x;
}

// ---------------------------------------------------------------------
// Tile products over shared memory.  C is float32 [M][N] with leading
// dimension ldc; ACC adds into C, otherwise C is overwritten.
//   mm_abt: C (+)= A[M][K] . B[N][K]^T   (s = q k^T, dp = do v^T)
//   mm_ab : C (+)= A[M][K] . B[K][N]     (o += p v,  dq += ds k)
//   mm_atb: C (+)= A[K][M]^T . B[K][N]   (dv += p^T do, dk += ds^T q)
// M, N, K are multiples of 16.  Callers separate a product from the
// writes of its operands and the reads of its result by __syncthreads.
// ---------------------------------------------------------------------
namespace wm = nvcuda::wmma;
using bf16 = __nv_bfloat16;

template <bool ACC>
__device__ __forceinline__ void acc_begin(
    wm::fragment<wm::accumulator, 16, 16, 16, float>& c, const float* p,
    int ldc) {
  if (ACC) {
    wm::load_matrix_sync(c, p, ldc, wm::mem_row_major);
  } else {
    wm::fill_fragment(c, 0.f);
  }
}

template <typename T, int M, int N, int K, bool ACC>
__device__ __forceinline__ void mm_abt(float* __restrict__ C, int ldc,
                                       const T* __restrict__ A, int lda,
                                       const T* __restrict__ B, int ldb) {
  if constexpr (std::is_same<T, bf16>::value) {
    const int warp = threadIdx.x / 32;
    for (int t = warp; t < (M / 16) * (N / 16); t += kWarps) {
      const int ti = t / (N / 16), tj = t % (N / 16);
      wm::fragment<wm::accumulator, 16, 16, 16, float> c;
      acc_begin<ACC>(c, C + ti * 16 * ldc + tj * 16, ldc);
#pragma unroll 4
      for (int kk = 0; kk < K; kk += 16) {
        wm::fragment<wm::matrix_a, 16, 16, 16, bf16, wm::row_major> a;
        wm::fragment<wm::matrix_b, 16, 16, 16, bf16, wm::col_major> b;
        wm::load_matrix_sync(a, A + ti * 16 * lda + kk, lda);
        wm::load_matrix_sync(b, B + tj * 16 * ldb + kk, ldb);
        wm::mma_sync(c, a, b, c);
      }
      wm::store_matrix_sync(C + ti * 16 * ldc + tj * 16, c, ldc,
                            wm::mem_row_major);
    }
  } else {
    for (int idx = threadIdx.x; idx < M * N; idx += kThreads) {
      const int i = idx / N, j = idx % N;
      const float* a = A + i * lda;
      const float* b = B + j * ldb;
      float acc = 0.f;
#pragma unroll 8
      for (int k = 0; k < K; ++k) acc = fmaf(a[k], b[k], acc);
      C[i * ldc + j] = ACC ? C[i * ldc + j] + acc : acc;
    }
  }
}

template <typename T, int M, int N, int K, bool ACC>
__device__ __forceinline__ void mm_ab(float* __restrict__ C, int ldc,
                                      const T* __restrict__ A, int lda,
                                      const T* __restrict__ B, int ldb) {
  if constexpr (std::is_same<T, bf16>::value) {
    const int warp = threadIdx.x / 32;
    for (int t = warp; t < (M / 16) * (N / 16); t += kWarps) {
      const int ti = t / (N / 16), tj = t % (N / 16);
      wm::fragment<wm::accumulator, 16, 16, 16, float> c;
      acc_begin<ACC>(c, C + ti * 16 * ldc + tj * 16, ldc);
#pragma unroll 4
      for (int kk = 0; kk < K; kk += 16) {
        wm::fragment<wm::matrix_a, 16, 16, 16, bf16, wm::row_major> a;
        wm::fragment<wm::matrix_b, 16, 16, 16, bf16, wm::row_major> b;
        wm::load_matrix_sync(a, A + ti * 16 * lda + kk, lda);
        wm::load_matrix_sync(b, B + kk * ldb + tj * 16, ldb);
        wm::mma_sync(c, a, b, c);
      }
      wm::store_matrix_sync(C + ti * 16 * ldc + tj * 16, c, ldc,
                            wm::mem_row_major);
    }
  } else {
    for (int idx = threadIdx.x; idx < M * N; idx += kThreads) {
      const int i = idx / N, j = idx % N;
      const float* a = A + i * lda;
      float acc = 0.f;
#pragma unroll 8
      for (int k = 0; k < K; ++k) acc = fmaf(a[k], B[k * ldb + j], acc);
      C[i * ldc + j] = ACC ? C[i * ldc + j] + acc : acc;
    }
  }
}

template <typename T, int M, int N, int K, bool ACC>
__device__ __forceinline__ void mm_atb(float* __restrict__ C, int ldc,
                                       const T* __restrict__ A, int lda,
                                       const T* __restrict__ B, int ldb) {
  if constexpr (std::is_same<T, bf16>::value) {
    const int warp = threadIdx.x / 32;
    for (int t = warp; t < (M / 16) * (N / 16); t += kWarps) {
      const int ti = t / (N / 16), tj = t % (N / 16);
      wm::fragment<wm::accumulator, 16, 16, 16, float> c;
      acc_begin<ACC>(c, C + ti * 16 * ldc + tj * 16, ldc);
#pragma unroll 4
      for (int kk = 0; kk < K; kk += 16) {
        // A^T as an [M][K] operand is A read column-major.
        wm::fragment<wm::matrix_a, 16, 16, 16, bf16, wm::col_major> a;
        wm::fragment<wm::matrix_b, 16, 16, 16, bf16, wm::row_major> b;
        wm::load_matrix_sync(a, A + kk * lda + ti * 16, lda);
        wm::load_matrix_sync(b, B + kk * ldb + tj * 16, ldb);
        wm::mma_sync(c, a, b, c);
      }
      wm::store_matrix_sync(C + ti * 16 * ldc + tj * 16, c, ldc,
                            wm::mem_row_major);
    }
  } else {
    for (int idx = threadIdx.x; idx < M * N; idx += kThreads) {
      const int i = idx / N, j = idx % N;
      float acc = 0.f;
#pragma unroll 8
      for (int k = 0; k < K; ++k) {
        acc = fmaf(A[k * lda + i], B[k * ldb + j], acc);
      }
      C[i * ldc + j] = ACC ? C[i * ldc + j] + acc : acc;
    }
  }
}

// Sets the dynamic shared-memory cap of one kernel instantiation once,
// then launches nothing itself; returns the CUDA error code.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes, bool* done) {
  if (*done) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err == cudaSuccess) *done = true;
  return err;
}

}  // namespace mvt

// dtype codes shared with the Python wrapper.
#define MVT_DTYPE_F32 0
#define MVT_DTYPE_BF16 1
// Return code for a dtype or head dim the library was not built for.
#define MVT_UNSUPPORTED (-1)
// Return code for a TMA descriptor the driver refused (hopper.cuh).
#define MVT_TMA_REFUSED (-2)

extern "C" const char* mvt_error_string(int code) {
  if (code == MVT_UNSUPPORTED) return "unsupported dtype or head dim";
  if (code == MVT_TMA_REFUSED) {
    return "TMA descriptor refused (pointer not 16-byte aligned or shape "
           "out of range)";
  }
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
