// The bf16 GEMM for Hopper (gemm_sm90.cu), as the entry points of
// fused_layer.cu call it for K1 and K3.
#pragma once

#include <cuda_runtime.h>

#include "gemm.cuh"

namespace rz {

// C = A . W with the fused epilogue `epi` (EPI_BIAS, EPI_RESID_F32, EPI_GELU or
// EPI_RESID_OUT of gemm.cuh) over bf16 operands: g.a (M, K) and g.w (K, N),
// both row-major, with K % 8 == 0, N % 8 == 0 and 16-byte aligned bases (TMA's
// rules); any M >= 0. No LN prologue: g.ln_s / g.ln_b are not read (the caller
// normalises A first). Returns cudaErrorInvalidValue for another epilogue or
// operands that do not suit TMA, else the launch's cudaGetLastError().
cudaError_t gemm_sm90(const GemmArgs& g, int epi, cudaStream_t stream);

}  // namespace rz
