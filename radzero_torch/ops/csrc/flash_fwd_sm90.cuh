// The bf16 attention forward for Hopper (flash_fwd_sm90.cu), as the entry
// points of flash_attention.cu call it.
#pragma once

#include <cuda_runtime.h>

namespace rz {
namespace fa {

// softmax(q k^T scale) v over (B, L, H, 64) bf16 operands read by stride
// (element (b, l, h, c) of q is q[b * q_bs + l * q_rs + h * 64 + c], strides
// in elements) into out by stride (o_bs, o_rs); keys >= Lk are masked.
// Returns cudaErrorInvalidValue when the operands do not suit TMA (bases or
// strides not multiples of 16 bytes) or the tensor-map encoder is missing.
cudaError_t forward_sm90(const void* q, const void* k, const void* v, long long q_bs,
                         long long q_rs, long long k_bs, long long k_rs, long long v_bs,
                         long long v_rs, void* out, long long o_bs, long long o_rs, int B, int L,
                         int H, int Lk, float scale, cudaStream_t stream);

}  // namespace fa
}  // namespace rz
