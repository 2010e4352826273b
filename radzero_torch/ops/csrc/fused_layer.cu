// K1 fused_preattn, K3 fused_postattn, K4 fused_mpnet_post for Hopper (K2,
// the packed attention between K1 and K3, is in flash_attention.cu and
// flash_fwd_sm90.cu).
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
//   768 / 2304 / 3072) and so bound by the math units. In bf16 they run
//   gemm_sm90_kernel (gemm_sm90.cu: a TMA ring fed by a producer
//   warpgroup, wgmma m64n128k16 in two consumer warpgroups, the epilogue on
//   the accumulator registers). Its A is a plain bf16 matrix, so LayerNorm
//   is a row pass in front of it (row_layernorm_kernel below: fp32
//   statistics once per row, the normalised row rounded to bf16 into a
//   scratch the wrapper allocates), where the old prologue recomputed the
//   statistics in every column block. fp32 runs gemm_f32_kernel (gemm.cuh:
//   64x64 tiles of true fp32 FMAs on the CUDA cores, no TF32), the
//   verification path, with the LN prologue: each block computes fp32
//   mean/rstd of its rows, then normalises A while staging it. Bias,
//   LayerScale, residual and exact-erf GELU run in the epilogue on the
//   fp32 accumulators.
// - W1 and W2 (4.7 MB each in bf16) cannot stay in one SM's 227 KB, so
//   K3 is a chain of launches: o-proj with y = x + ls1*(a Wo + bo) kept
//   in fp32 in device memory (as the TPU kernel keeps y32); LN2 (bf16: the
//   row pass into a bf16 scratch; fp32: the prologue) + fc1 + GELU,
//   rounded to the operand type; fc2 with out = y + ls2*(m + b2).
// - K4 is K3's post-LN sibling (MPNet): y = LN(x + a Wo + bo),
//   out = LN(y + gelu(y W1 + b1) W2 + b2), eps 1e-12. A LayerNorm over a
//   768-wide row cannot be the epilogue of a 128-wide column tile, so it
//   is a chain of five launches, in bf16 the chain that K9 recomputes:
//   o-proj + bias + residual into fp32 u (gemm_sm90_kernel, EPI_ADD_F32);
//   a row pass LN(u) (ln_rows_kernel of fused_layer_bwd.cu, rz_ln_rows)
//   that writes y twice from one fp32 value, rounded to bf16 (yln, fc1's
//   operand, which TMA reads) and in fp32 (y32, the second residual);
//   fc1 + GELU on yln (EPI_GELU); fc2 + bias + y32 (EPI_ADDF_F32, in place
//   in y32); a row pass into the output (row_layernorm_kernel). fp32 runs
//   gemm_f32_kernel, fc1 reading y32 itself. Rows are masked, never padded
//   (M = sentences x length).
#include "gemm.cuh"
#include "gemm_sm90.cuh"

namespace rz {

// The row pass of K1 and K3 (bf16), of K4's output and of both of K4's in
// fp32: out[m, :] = LN(in[m, :]) * scale + bias for rows of width D, one warp
// per row, two-pass statistics in fp32 (biased variance, eps inside the
// rsqrt) from 16-byte loads (D a multiple of 16 / sizeof(TI)). TI is the
// row's type: bf16 (K1's x), fp32 (K3's y32, K4's u and v). TO is bf16 (the
// next GEMM's operand, K4's output) or float (K4's y in fp32).
constexpr int LN_ROWS = 8;  // rows (warps) per block

template <typename T, typename TI, typename TO>
__global__ void __launch_bounds__(LN_ROWS * 32)
row_layernorm_kernel(const TI* __restrict__ in, const T* __restrict__ scale,
                     const T* __restrict__ bias, TO* __restrict__ out, int M, int D,
                     float eps) {
  constexpr int VEC = 16 / sizeof(TI);
  static_assert(VEC * sizeof(TO) == 16 || VEC * sizeof(TO) == 8, "one 16- or 8-byte store");
  const int lane = threadIdx.x % 32, m = blockIdx.x * LN_ROWS + threadIdx.x / 32;
  if (m >= M) return;
  const TI* row = in + (size_t)m * D;
  auto load = [&](int k, float (&x)[VEC]) {
    const uint4 u = *reinterpret_cast<const uint4*>(row + k);
    const TI* v = reinterpret_cast<const TI*>(&u);
#pragma unroll
    for (int e = 0; e < VEC; ++e) x[e] = to_f32(v[e]);
  };
  float x[VEC], s = 0.f, v = 0.f;
  for (int k = lane * VEC; k < D; k += 32 * VEC) {
    load(k, x);
#pragma unroll
    for (int e = 0; e < VEC; ++e) s += x[e];
  }
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  const float mean = s / D;
  for (int k = lane * VEC; k < D; k += 32 * VEC) {
    load(k, x);
#pragma unroll
    for (int e = 0; e < VEC; ++e) v += (x[e] - mean) * (x[e] - mean);
  }
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const float rstd = rsqrtf(v / D + eps);
  for (int k = lane * VEC; k < D; k += 32 * VEC) {
    load(k, x);
    __align__(16) TO y[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      y[e] = from_f32<TO>((x[e] - mean) * rstd * to_f32(scale[k + e]) + to_f32(bias[k + e]));
    if constexpr (VEC * sizeof(TO) == 16)
      *reinterpret_cast<uint4*>(out + (size_t)m * D + k) = *reinterpret_cast<const uint4*>(y);
    else
      *reinterpret_cast<uint2*>(out + (size_t)m * D + k) = *reinterpret_cast<const uint2*>(y);
  }
}

template <typename T, typename TI, typename TO>
cudaError_t launch_row_layernorm(const void* in, const void* scale, const void* bias,
                                 void* out, int M, int D, float eps, cudaStream_t stream) {
  if (M == 0) return cudaSuccess;
  row_layernorm_kernel<T, TI, TO><<<(M + LN_ROWS - 1) / LN_ROWS, LN_ROWS * 32, 0, stream>>>(
      static_cast<const TI*>(in), static_cast<const T*>(scale), static_cast<const T*>(bias),
      static_cast<TO*>(out), M, D, eps);
  return cudaGetLastError();
}

}  // namespace rz

using rz::GemmArgs;
using bf16 = __nv_bfloat16;

extern "C" const char* rz_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// K1: out (M, N) = LN(x) (M, K) . w (K, N) + b. bf16: the row pass writes
//     LN(x) into ln (M, K), a scratch the caller allocates, then
//     gemm_sm90_kernel; fp32: the LN prologue of gemm_f32_kernel (ln unused).
extern "C" int rz_fused_preattn(const void* x, const void* ln_s, const void* ln_b,
                                const void* w, const void* b, void* ln, void* out, int M,
                                int K, int N, float eps, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == RZ_DTYPE_BF16) {
    err = rz::launch_row_layernorm<bf16, bf16, bf16>(x, ln_s, ln_b, ln, M, K, eps, s);
    GemmArgs g{ln, w, b, nullptr, nullptr, 0.f, nullptr, nullptr, out, M, N, K};
    if (err == cudaSuccess) err = rz::gemm_sm90(g, rz::EPI_BIAS, s);
  } else {
    GemmArgs g{x, w, b, ln_s, ln_b, eps, nullptr, nullptr, out, M, N, K};
    err = rz::launch_gemm<true, rz::EPI_BIAS>(g, s);
  }
  return static_cast<int>(err);
}

// K3: y32 = x + ls1 (a Wo + bo); h = gelu(LN2(y32) W1 + b1);
//     out = y32 + ls2 (h W2 + b2). y32 (M, D) fp32, ln (M, D) (bf16 only:
//     LN2(y32) from the row pass) and h (M, F) are scratch buffers the
//     caller allocates. bf16: o-proj, the row pass, fc1, fc2 on
//     gemm_sm90_kernel; fp32: three gemm_f32_kernel, LN2 as fc1's prologue.
extern "C" int rz_fused_postattn(const void* x, const void* a, const void* wo,
                                 const void* bo, const void* ls1, const void* ln_s,
                                 const void* ln_b, const void* w1, const void* b1,
                                 const void* w2, const void* b2, const void* ls2,
                                 void* y32, void* ln, void* h, void* out, int M, int D, int F,
                                 float eps, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  GemmArgs proj{a, wo, bo, nullptr, nullptr, 0.f, x, ls1, y32, M, D, D};
  GemmArgs fc2{h, w2, b2, nullptr, nullptr, 0.f, y32, ls2, out, M, D, F};
  cudaError_t err;
  if (dtype == RZ_DTYPE_BF16) {
    GemmArgs fc1{ln, w1, b1, nullptr, nullptr, 0.f, nullptr, nullptr, h, M, F, D};
    err = rz::gemm_sm90(proj, rz::EPI_RESID_F32, s);
    if (err == cudaSuccess)
      err = rz::launch_row_layernorm<bf16, float, bf16>(y32, ln_s, ln_b, ln, M, D, eps, s);
    if (err == cudaSuccess) err = rz::gemm_sm90(fc1, rz::EPI_GELU, s);
    if (err == cudaSuccess) err = rz::gemm_sm90(fc2, rz::EPI_RESID_OUT, s);
  } else {
    GemmArgs fc1{y32, w1, b1, ln_s, ln_b, eps, nullptr, nullptr, h, M, F, D};
    err = rz::launch_gemm<false, rz::EPI_RESID_F32>(proj, s);
    if (err == cudaSuccess) err = rz::launch_gemm<true, rz::EPI_GELU>(fc1, s);
    if (err == cudaSuccess) err = rz::launch_gemm<false, rz::EPI_RESID_OUT>(fc2, s);
  }
  return static_cast<int>(err);
}

// LN(u) per row -> out_t (operand type) and / or out_f (fp32): fused_layer_bwd.cu
extern "C" int rz_ln_rows(const void* u, int u_f32, const void* scale, const void* bias,
                          void* out_t, void* out_f, int M, int D, float eps, int dtype,
                          void* stream);

// K4: u32 = x + (a Wo + bo); y = LN(u32); h = gelu(y W1 + b1);
//     v = y32 + (h W2 + b2); out = LN(v). u32, y32 (M, D) fp32, h (M, F) and, in
//     bf16, yln (M, D) (y rounded, fc1's operand) are scratch buffers the caller
//     allocates; bf16 keeps v in y32's buffer, fp32 in u32's.
extern "C" int rz_fused_mpnet_post(const void* x, const void* a, const void* wo,
                                   const void* bo, const void* lnsa, const void* lnba,
                                   const void* w1, const void* b1, const void* w2,
                                   const void* b2, const void* lnso, const void* lnbo,
                                   void* u32, void* y32, void* yln, void* h, void* out, int M,
                                   int D, int F, float eps, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  GemmArgs proj{a, wo, bo, nullptr, nullptr, 0.f, x, nullptr, u32, M, D, D};
  cudaError_t err;
  if (dtype == RZ_DTYPE_BF16) {
    GemmArgs fc1{yln, w1, b1, nullptr, nullptr, 0.f, nullptr, nullptr, h, M, F, D};
    GemmArgs fc2{h, w2, b2, nullptr, nullptr, 0.f, y32, nullptr, y32, M, D, F};
    err = rz::gemm_sm90(proj, rz::EPI_ADD_F32, s);
    if (err == cudaSuccess)
      err = static_cast<cudaError_t>(
          rz_ln_rows(u32, 1, lnsa, lnba, yln, y32, M, D, eps, RZ_DTYPE_BF16, stream));
    if (err == cudaSuccess) err = rz::gemm_sm90(fc1, rz::EPI_GELU, s);
    if (err == cudaSuccess) err = rz::gemm_sm90(fc2, rz::EPI_ADDF_F32, s);
    if (err == cudaSuccess)
      err = rz::launch_row_layernorm<bf16, float, bf16>(y32, lnso, lnbo, out, M, D, eps, s);
  } else {
    GemmArgs fc1{y32, w1, b1, nullptr, nullptr, 0.f, nullptr, nullptr, h, M, F, D};
    GemmArgs fc2{h, w2, b2, nullptr, nullptr, 0.f, y32, nullptr, u32, M, D, F};
    err = rz::launch_gemm<false, rz::EPI_ADD_F32>(proj, s);
    if (err == cudaSuccess)
      err = rz::launch_row_layernorm<float, float, float>(u32, lnsa, lnba, y32, M, D, eps, s);
    if (err == cudaSuccess) err = rz::launch_gemm<false, rz::EPI_GELU>(fc1, s);
    if (err == cudaSuccess) err = rz::launch_gemm<false, rz::EPI_ADDF_F32>(fc2, s);
    if (err == cudaSuccess)
      err = rz::launch_row_layernorm<float, float, float>(u32, lnso, lnbo, out, M, D, eps, s);
  }
  return static_cast<int>(err);
}
