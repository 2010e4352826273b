// The bf16 GEMM for Hopper (gemm_sm90.cu), as the entry points of
// fused_layer.cu call it for K1, K3 and K4, those of fused_layer_bwd.cu for
// the chains of K6, K8 and K9, vlcabs_sm90.cu for the second phases of K12
// and of K5 / K10 and vlcabs_train.cu for K11's dq product.
#pragma once

#include <cuda_runtime.h>

#include "gemm.cuh"

namespace rz {

constexpr int kSm90RowTile = 128;  // rows of an output tile (colpart is (ceil(M / this), N))

// C = A . W (or A . W^T when w_t) with the fused epilogue `epi` of gemm.cuh over
// bf16 operands: g.a (M, K) row-major, and g.w (K, N) row-major, or (N, K)
// row-major when w_t (a dX = G . W^T reads the weight W as it is stored);
// K % 8 == 0, N % 8 == 0 and 16-byte aligned bases (TMA's rules); any M >= 0.
// The epilogues: EPI_BIAS, EPI_RESID_F32, EPI_GELU, EPI_RESID_OUT, EPI_ADD_F32,
// EPI_ADDF_F32, EPI_PROJ2, EPI_GELU_H1, EPI_F32 with W (K, N); EPI_BIAS,
// EPI_ADDF_F32, EPI_F32, EPI_DGELU with W^T. No LN prologue: g.ln_s / g.ln_b
// are not read (the caller normalises A first). Returns cudaErrorInvalidValue
// for another pair or operands that do not suit TMA, else the launch's
// cudaGetLastError().
cudaError_t gemm_sm90(const GemmArgs& g, int epi, cudaStream_t stream, bool w_t = false);

// part (splits, Ka, Nb) fp32: part[z] = a[rows of chunk z]^T . g[rows of chunk z],
// a (rows, Ka) and g (rows, Nb) bf16 row-major; the chunks are whole multiples of
// 64 rows, ceil(rows / splits) rounded up, and a chunk past the rows gets zeros.
// Ka % 64 == 0, Nb % 8 == 0.
cudaError_t gemm_sm90_wgrad(const void* a, const void* g, float* part, int rows, int Ka, int Nb,
                            int splits, cudaStream_t stream);

// K12's second phase, dtn[b] = [dc[b]; e[b]]^T . [qn; dg[b]] for each of B images:
// ce (B, 2 Np, Lp) bf16 holds image b's dc in rows [0, Np) and its e in rows
// [Np, 2 Np), zeros in the rows past N of each half and the columns past L;
// qn (N, D), dg (B, N, D), dtn (B, L, D) bf16. One product contracted over 2 Np
// a (128-token, 128-column) tile, rounded once; no partial sums. D, Np, Lp % 64
// == 0.
cudaError_t gemm_sm90_dtn(const void* ce, const void* qn, const void* dg, void* dtn, int N,
                          int Np, int B, int L, int Lp, int D, cudaStream_t stream);

// out[b] (+)= a[b] . tn[b] for each of B images, one fp32 sum over Lp a (128-row,
// 128-column) tile: a (B, Ar, Lp) bf16, of whose Ar rows per image the first N are
// read, with zeros in the columns past L; tn (B, L, D) bf16; out (B, N, D) fp32,
// overwritten, or added to in place with `add`. K5 / K10's second phase, g = e . tn
// (a = e, Ar = Np), and K11's dq product, dz ghat + dc . tn (a = K12's ce, Ar = 2 Np,
// the dc rows first). D % 8 == 0, Ar, Lp % 64 == 0.
cudaError_t gemm_sm90_vlc_g(const void* a, const void* tn, float* out, int N, int Ar, int B,
                            int L, int Lp, int D, bool add, cudaStream_t stream);

}  // namespace rz
