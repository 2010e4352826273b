// The bf16 attention forward and backward for Hopper (flash_fwd_sm90.cu,
// flash_bwd_sm90.cu), as the entry points of flash_attention.cu call them.
#pragma once

#include <cuda_runtime.h>

namespace rz {
namespace fa {

// softmax(q k^T scale) v over (B, L, H, 64) bf16 operands read by stride
// (element (b, l, h, c) of q is q[b * q_bs + l * q_rs + h * 64 + c], strides
// in elements) into out by stride (o_bs, o_rs); keys >= Lk are masked. A
// non-null lse (B, H, L) fp32 receives m + log2(l) of every query row in the
// log2 domain of the scores (scale log2 e folded in). Returns
// cudaErrorInvalidValue when the operands do not suit TMA (bases or strides
// not multiples of 16 bytes) or the tensor-map encoder is missing.
cudaError_t forward_sm90(const void* q, const void* k, const void* v, long long q_bs,
                         long long q_rs, long long k_bs, long long k_rs, long long v_bs,
                         long long v_rs, void* out, long long o_bs, long long o_rs, float* lse,
                         int B, int L, int H, int Lk, float scale, cudaStream_t stream);

// The backward of forward_sm90 (flash_bwd_sm90.cu): cotangent dout and the
// forward's out, both (B, L, H, 64) contiguous, and its lse -> dq, dk, dv by
// stride (g_bs, g_rs); delta (B, H, L) fp32 is scratch. Two kernels: dQ (which
// also writes delta = rowsum(dout out)), then dK / dV.
cudaError_t backward_sm90(const void* q, const void* k, const void* v, long long q_bs,
                          long long q_rs, long long k_bs, long long k_rs, long long v_bs,
                          long long v_rs, const void* out, const void* dout, const float* lse,
                          float* delta, void* dq, void* dk, void* dv, long long g_bs,
                          long long g_rs, int B, int L, int H, int Lk, float scale,
                          cudaStream_t stream);

}  // namespace fa
}  // namespace rz
