// Shared building blocks of the radzero_torch kernels (sm_90a).
//
// TileAccF32 accumulates one 64x64 fp32 tile with 128 threads on the CUDA
// cores in true fp32 (no TF32), each thread a 4x8 register block; the
// fp32 GEMM (the verification path) uses it.
//
// WarpAcc<T, B_T> is one warp's 16x64 fp32 tile C = A . B, operands in
// shared memory: A (16 x k) row-major with leading dimension lda; B
// (k x 64) row-major with ldb when B_T is false, or given transposed as a
// (64 x k) row-major array (K rows of attention) when B_T is true.
//   - T = __nv_bfloat16: WMMA m16n16k16 on the tensor cores, four fp32
//     accumulator fragments along n;
//   - T = float: CUDA-core FMAs, lane l owns row l / 2, columns
//     (l % 2) * 32 .. + 32.
// store() writes the tile to shared memory, row-major with ldc.
//
// Alignment contract for WMMA: every tile base is 32-byte aligned,
// lda/ldb are multiples of 8 elements, ldc of 4, and 16 rows of any
// operand span a multiple of 32 bytes.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace rz {

constexpr int kThreads = 128;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as astype(bfloat16)
}

// Round x to the operand type and back (the JAX `.astype(cdt)` points).
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

struct TileAccF32 {
  float c[4][8];

  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) c[i][j] = 0.0f;
  }

  __device__ void mma(const float* A, int lda, const float* B, int ldb, int k) {
    const int r0 = (threadIdx.x / 8) * 4, c0 = (threadIdx.x % 8) * 8;
    for (int kk = 0; kk < k; ++kk) {
      float a[4], b[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = A[(r0 + i) * lda + kk];
#pragma unroll
      for (int j = 0; j < 8; ++j) b[j] = B[kk * ldb + c0 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) c[i][j] = fmaf(a[i], b[j], c[i][j]);
    }
  }

  // the same with A given transposed: At is (k x 64) row-major
  __device__ void mma_at(const float* At, int lda, const float* B, int ldb, int k) {
    const int r0 = (threadIdx.x / 8) * 4, c0 = (threadIdx.x % 8) * 8;
    for (int kk = 0; kk < k; ++kk) {
      float a[4], b[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = At[kk * lda + r0 + i];
#pragma unroll
      for (int j = 0; j < 8; ++j) b[j] = B[kk * ldb + c0 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) c[i][j] = fmaf(a[i], b[j], c[i][j]);
    }
  }

  __device__ void store(float* C, int ldc) {
    const int r0 = (threadIdx.x / 8) * 4, c0 = (threadIdx.x % 8) * 8;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) C[(r0 + i) * ldc + c0 + j] = c[i][j];
  }
};

template <typename T, bool B_T> struct WarpAcc;

template <bool B_T> struct WarpAcc<__nv_bfloat16, B_T> {
  using BLayout = typename std::conditional<B_T, nvcuda::wmma::col_major,
                                            nvcuda::wmma::row_major>::type;
  nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float> c[4];

  __device__ void zero() {
#pragma unroll
    for (int j = 0; j < 4; ++j) nvcuda::wmma::fill_fragment(c[j], 0.0f);
  }

  __device__ void mma(const __nv_bfloat16* A, int lda, const __nv_bfloat16* B, int ldb,
                      int k) {
    using namespace nvcuda;
    for (int kk = 0; kk < k; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
      wmma::load_matrix_sync(a, A + kk, lda);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, BLayout> b;
        wmma::load_matrix_sync(b, B_T ? B + 16 * j * ldb + kk : B + kk * ldb + 16 * j, ldb);
        wmma::mma_sync(c[j], a, b, c[j]);
      }
    }
  }

  __device__ void store(float* C, int ldc) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      nvcuda::wmma::store_matrix_sync(C + 16 * j, c[j], ldc, nvcuda::wmma::mem_row_major);
  }
};

template <bool B_T> struct WarpAcc<float, B_T> {
  float c[32];

  __device__ void zero() {
#pragma unroll
    for (int j = 0; j < 32; ++j) c[j] = 0.0f;
  }

  __device__ void mma(const float* A, int lda, const float* B, int ldb, int k) {
    const int lane = threadIdx.x % 32, r = lane / 2, c0 = (lane % 2) * 32;
    for (int kk = 0; kk < k; ++kk) {
      const float a = A[r * lda + kk];
#pragma unroll
      for (int j = 0; j < 32; ++j)
        c[j] = fmaf(a, B_T ? B[(c0 + j) * ldb + kk] : B[kk * ldb + c0 + j], c[j]);
    }
  }

  __device__ void store(float* C, int ldc) {
    const int lane = threadIdx.x % 32, r = lane / 2, c0 = (lane % 2) * 32;
#pragma unroll
    for (int j = 0; j < 32; ++j) C[r * ldc + c0 + j] = c[j];
  }
};

// Opt in to more than 48 KB of dynamic shared memory for `kernel`.
template <typename K> inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

__host__ __device__ constexpr size_t align_up(size_t n, size_t a) { return (n + a - 1) / a * a; }

}  // namespace rz

#define RZ_DTYPE_F32 0
#define RZ_DTYPE_BF16 1
