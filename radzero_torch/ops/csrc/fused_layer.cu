// K1 fused_preattn, K3 fused_postattn, K4 fused_mpnet_post for Hopper (K2,
// the packed attention between K1 and K3, is in flash_attention.cu).
//
// Replace the TPU kernels of radzero_tpu/ops/fused_layer.py:
//   K1 fused_preattn           (_preattn_kernel)
//   K3 fused_postattn          (_postattn_kernel)
//   K4 _mpnet_post_call        (_mpnet_post_kernel)
// with the same contracts: fp32 LayerNorm, softmax and accumulation on
// fp32 or bf16 operands, rounded to the operand type where the JAX code
// rounds (LN output before a GEMM, GELU output before fc2).
//
// What bounds them on the H100, and what the design does about it:
// - K1 and K3 are GEMMs (ViT-B/14 at 518: M = B * 1370 rows, K and N of
//   768 / 2304 / 3072) and so bound by the math units; the GEMM itself is
//   in gemm.cuh, shared with the backward chains. bf16: one 128x128
//   output tile per 256-thread block, 32-deep k-steps staged in shared
//   memory from 16-byte loads that are issued one k-step ahead, WMMA
//   tensor-core products with fp32 accumulators (8 warps of 64x32).
//   fp32: 64x64 tiles of true fp32 FMAs on the CUDA cores (no TF32), the
//   verification path. LayerNorm is a prologue: each block computes fp32
//   mean/rstd of its rows, then normalises A while staging it, so the LN
//   output never reaches device memory. Bias, LayerScale, residual and
//   exact-erf GELU run in the epilogue on the fp32 accumulators.
// - W1 and W2 (4.7 MB each in bf16) cannot stay in one SM's 227 KB, so
//   K3 is a chain of three launches: o-proj with y = x + ls1*(a Wo + bo)
//   kept in fp32 in device memory (as the TPU kernel keeps y32); LN2
//   prologue + fc1 + GELU, rounded to the operand type; fc2 with
//   out = y + ls2*(m + b2).
// - K4 is K3's post-LN sibling (MPNet): y = LN(x + a Wo + bo),
//   out = LN(y + gelu(y W1 + b1) W2 + b2), eps 1e-12. A LayerNorm over a
//   768-wide row cannot be the epilogue of a 128-wide column tile, so it
//   is a chain of five launches around the same GEMMs: o-proj + bias +
//   residual into fp32 u; a row pass LN(u) into fp32 y (one warp per row),
//   which stays fp32 in device memory as both the fc1 operand (rounded to
//   the operand type while it is staged) and the second residual
//   (unrounded); fc1 + GELU; fc2 + bias + y into fp32; a row pass into the
//   output. Rows are masked, never padded (M = sentences x length).
// Not yet done (later work): wgmma, TMA, multi-stage pipelines,
// warp specialisation.
#include "gemm.cuh"

namespace rz {

// K4's row pass: out[m, :] = LN(in[m, :]) * scale + bias for fp32 rows of
// width D, one warp per row, two-pass statistics in fp32 (biased variance,
// eps inside the rsqrt). TO is float (y, kept for the residual) or the
// operand type (the layer output).
constexpr int LN_ROWS = 8;  // rows (warps) per block

template <typename T, typename TO>
__global__ void __launch_bounds__(LN_ROWS * 32)
row_layernorm_kernel(const float* __restrict__ in, const T* __restrict__ scale,
                     const T* __restrict__ bias, TO* __restrict__ out, int M, int D,
                     float eps) {
  const int lane = threadIdx.x % 32, m = blockIdx.x * LN_ROWS + threadIdx.x / 32;
  if (m >= M) return;
  const float* row = in + (size_t)m * D;
  float s = 0.f, v = 0.f;
  for (int k = lane; k < D; k += 32) s += row[k];
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  const float mean = s / D;
  for (int k = lane; k < D; k += 32) {
    const float d = row[k] - mean;
    v += d * d;
  }
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const float rstd = rsqrtf(v / D + eps);
  for (int k = lane; k < D; k += 32)
    out[(size_t)m * D + k] =
        from_f32<TO>((row[k] - mean) * rstd * to_f32(scale[k]) + to_f32(bias[k]));
}

template <typename T, typename TO>
cudaError_t launch_row_layernorm(const void* in, const void* scale, const void* bias,
                                 void* out, int M, int D, float eps, cudaStream_t stream) {
  row_layernorm_kernel<T, TO><<<(M + LN_ROWS - 1) / LN_ROWS, LN_ROWS * 32, 0, stream>>>(
      static_cast<const float*>(in), static_cast<const T*>(scale),
      static_cast<const T*>(bias), static_cast<TO*>(out), M, D, eps);
  return cudaGetLastError();
}

}  // namespace rz

using rz::GemmArgs;
using bf16 = __nv_bfloat16;

extern "C" const char* rz_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// K1: out (M, N) = LN(x) (M, K) . w (K, N) + b
extern "C" int rz_fused_preattn(const void* x, const void* ln_s, const void* ln_b,
                                const void* w, const void* b, void* out, int M, int K,
                                int N, float eps, int dtype, void* stream) {
  GemmArgs g{x, w, b, ln_s, ln_b, eps, nullptr, nullptr, out, M, N, K};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == RZ_DTYPE_BF16
                        ? rz::launch_gemm<bf16, bf16, true, rz::EPI_BIAS>(g, s)
                        : rz::launch_gemm<float, float, true, rz::EPI_BIAS>(g, s);
  return static_cast<int>(err);
}

// K3: y32 = x + ls1 (a Wo + bo); h = gelu(LN2(y32) W1 + b1);
//     out = y32 + ls2 (h W2 + b2). y32 (M, D) fp32 and h (M, F) are
//     scratch buffers the caller allocates.
extern "C" int rz_fused_postattn(const void* x, const void* a, const void* wo,
                                 const void* bo, const void* ls1, const void* ln_s,
                                 const void* ln_b, const void* w1, const void* b1,
                                 const void* w2, const void* b2, const void* ls2,
                                 void* y32, void* h, void* out, int M, int D, int F,
                                 float eps, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  GemmArgs proj{a, wo, bo, nullptr, nullptr, 0.f, x, ls1, y32, M, D, D};
  GemmArgs fc1{y32, w1, b1, ln_s, ln_b, eps, nullptr, nullptr, h, M, F, D};
  GemmArgs fc2{h, w2, b2, nullptr, nullptr, 0.f, y32, ls2, out, M, D, F};
  cudaError_t err;
  if (dtype == RZ_DTYPE_BF16) {
    err = rz::launch_gemm<bf16, bf16, false, rz::EPI_RESID_F32>(proj, s);
    if (err == cudaSuccess) err = rz::launch_gemm<bf16, float, true, rz::EPI_GELU>(fc1, s);
    if (err == cudaSuccess) err = rz::launch_gemm<bf16, bf16, false, rz::EPI_RESID_OUT>(fc2, s);
  } else {
    err = rz::launch_gemm<float, float, false, rz::EPI_RESID_F32>(proj, s);
    if (err == cudaSuccess) err = rz::launch_gemm<float, float, true, rz::EPI_GELU>(fc1, s);
    if (err == cudaSuccess) err = rz::launch_gemm<float, float, false, rz::EPI_RESID_OUT>(fc2, s);
  }
  return static_cast<int>(err);
}

// K4: u32 = x + (a Wo + bo); y32 = LN(u32); h = gelu(y32 W1 + b1);
//     u32 = y32 + (h W2 + b2); out = LN(u32). u32, y32 (M, D) fp32 and
//     h (M, F) are scratch buffers the caller allocates.
template <typename T>
static cudaError_t mpnet_post(const void* x, const void* a, const void* wo, const void* bo,
                              const void* lnsa, const void* lnba, const void* w1,
                              const void* b1, const void* w2, const void* b2,
                              const void* lnso, const void* lnbo, void* u32, void* y32,
                              void* h, void* out, int M, int D, int F, float eps,
                              cudaStream_t s) {
  GemmArgs proj{a, wo, bo, nullptr, nullptr, 0.f, x, nullptr, u32, M, D, D};
  GemmArgs fc1{y32, w1, b1, nullptr, nullptr, 0.f, nullptr, nullptr, h, M, F, D};
  GemmArgs fc2{h, w2, b2, nullptr, nullptr, 0.f, y32, nullptr, u32, M, D, F};
  cudaError_t err = rz::launch_gemm<T, T, false, rz::EPI_ADD_F32>(proj, s);
  if (err == cudaSuccess) err = rz::launch_row_layernorm<T, float>(u32, lnsa, lnba, y32, M, D, eps, s);
  if (err == cudaSuccess) err = rz::launch_gemm<T, float, false, rz::EPI_GELU>(fc1, s);
  if (err == cudaSuccess) err = rz::launch_gemm<T, T, false, rz::EPI_ADDF_F32>(fc2, s);
  if (err == cudaSuccess) err = rz::launch_row_layernorm<T, T>(u32, lnso, lnbo, out, M, D, eps, s);
  return err;
}

extern "C" int rz_fused_mpnet_post(const void* x, const void* a, const void* wo,
                                   const void* bo, const void* lnsa, const void* lnba,
                                   const void* w1, const void* b1, const void* w2,
                                   const void* b2, const void* lnso, const void* lnbo,
                                   void* u32, void* y32, void* h, void* out, int M, int D,
                                   int F, float eps, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      dtype == RZ_DTYPE_BF16
          ? mpnet_post<bf16>(x, a, wo, bo, lnsa, lnba, w1, b1, w2, b2, lnso, lnbo, u32, y32, h,
                             out, M, D, F, eps, s)
          : mpnet_post<float>(x, a, wo, bo, lnsa, lnba, w1, b1, w2, b2, lnso, lnbo, u32, y32,
                              h, out, M, D, F, eps, s);
  return static_cast<int>(err);
}
