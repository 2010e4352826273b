// The row-pass building blocks shared by the LayerNorm row passes of
// fused_layer_bwd.cu and the row kernel of tp_rows.cu: a warp holds a row,
// lane l its 8-column chunks l, l + 32, l + 64, ... as 16-byte vectors, the
// whole row (D <= MAX_D) in registers. row_stats is the one place the
// LayerNorm statistics are computed, so every kernel that includes this
// header gives a row the same mean and rstd, bit for bit.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace rz {
namespace rows {

constexpr int VEC = 8;      // columns a lane loads at once: 16 bytes of bf16, 32 of fp32
constexpr int MAX_NC = 4;   // 8-column chunks a lane holds of a row
constexpr int MAX_D = 32 * VEC * MAX_NC;  // widest row a warp holds

// 8 neighbouring values from p (16-byte aligned) as fp32, and back
__device__ __forceinline__ void load8(const float* p, float (&v)[VEC]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[VEC]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < VEC / 2; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store8(float* p, const float (&v)[VEC]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&v)[VEC]) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < VEC / 2; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = raw;
}

// the first column of a lane's chunk j of a row (a chunk at or past D is not held)
__device__ __forceinline__ int chunk_col(int j, int lane) { return (j * 32 + lane) * VEC; }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// mean and rstd of the row a warp holds (two passes over the registers, fp32;
// biased variance, eps inside the rsqrt)
template <int NC>
__device__ __forceinline__ void row_stats(const float (&x)[NC][VEC], int D, float eps, int lane,
                                          float& mean, float& rstd) {
  float s = 0.f, v = 0.f;
#pragma unroll
  for (int j = 0; j < NC; ++j)
    if (chunk_col(j, lane) < D)
#pragma unroll
      for (int k = 0; k < VEC; ++k) s += x[j][k];
  mean = warp_sum(s) / D;
#pragma unroll
  for (int j = 0; j < NC; ++j)
    if (chunk_col(j, lane) < D)
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        const float d = x[j][k] - mean;
        v = __fmaf_rn(d, d, v);
      }
  rstd = rsqrtf(warp_sum(v) / D + eps);
}

}  // namespace rows
}  // namespace rz
