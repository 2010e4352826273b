// The bf16 biased attention at short lengths (flash_bias_small.cu), as the
// entry points of flash_attention.cu call it for K15 / K16 at L <= 64.
#pragma once

#include <cuda_runtime.h>

namespace rz {
namespace fa {

// The longest sentence these kernels take; longer ones run the tiled kernels.
constexpr int kSmallL = 64;

// softmax(q k^T scale + bias[h] + neg[b]) v over (B, L, H, 64) bf16 operands
// read by stride (element (b, l, h, c) of q is q[b * q_bs + l * q_rs + h * 64 +
// c], strides in elements), bias (H, L, L) and neg (B, L) fp32 contiguous,
// into out by stride (o_bs, o_rs); keys >= Lk are masked. One block per head
// and chunk of ceil(B / chunks) sentences. L <= kSmallL.
cudaError_t forward_bias_small(const void* q, const void* k, const void* v, long long q_bs,
                               long long q_rs, long long k_bs, long long k_rs, long long v_bs,
                               long long v_rs, const float* bias, const float* neg, void* out,
                               long long o_bs, long long o_rs, int B, int L, int H, int Lk,
                               float scale, int chunks, cudaStream_t stream);

// Its backward: cotangent dout (B, L, H, 64) bf16 contiguous -> dq, dk, dv by
// stride (g_bs, g_rs), and part (chunks, H, L, L) fp32: the sum of dS before
// the scale over each chunk's sentences, in order, for a fixed-order reduce.
cudaError_t backward_bias_small(const void* q, const void* k, const void* v, long long q_bs,
                                long long q_rs, long long k_bs, long long k_rs, long long v_bs,
                                long long v_rs, const float* bias, const float* neg,
                                const void* dout, void* dq, void* dk, void* dv, long long g_bs,
                                long long g_rs, float* part, int B, int L, int H, int Lk,
                                float scale, int chunks, cudaStream_t stream);

}  // namespace fa
}  // namespace rz
