// K6, K8, K9: the backward kernels of the fused layers for Hopper (K7, the
// backward of the packed attention K2, is in flash_attention.cu).
//
// Replace the TPU kernels of radzero_tpu/ops/fused_layer.py:
//   K6 _preattn_vjp_bwd     (_preattn_bwd_kernel)     backward of K1
//   K8 _postattn_vjp_bwd    (_postattn_bwd_kernel)    backward of K3
//   K9 _mpnet_post_vjp_bwd  (_mpnet_post_bwd_kernel)  backward of K4
// with the same contracts: only the layer's inputs are kept from the
// forward; the backward recomputes the forward chain in fp32 and rounds to
// the operand type where the TPU kernels do (LN output, GELU output, dm,
// dh1, dproj); every sum is fp32; gradients come back in the operand type.
//
// What bounds them on the H100, and what the design does about it. All
// three are chains of matrix products (K6 4 N D 3D operations, K8 and K9
// 6 N D (D + 2F)), so the math units bound them.
// - The TPU kernels hold a row block's whole chain in VMEM and add weight,
//   bias, LN and LayerScale gradients into one block across sequential
//   grid steps. Here blocks run concurrently and W1 / W2 do not fit an SM,
//   so they are chains of launches that the Python wrapper
//   composes from the entry points below, with the intermediates (LN
//   output, pre-GELU h1, GELU output, the rounded gradients) in scratch
//   that the wrapper allocates for the call:
//     rz_bwd_gemm      C = A . W with the epilogues of gemm.cuh; a product
//                      with a transposed weight (dh = g . W^T) reads W as
//                      it is stored in bf16 and a copy that rz_transpose
//                      made in fp32;
//     rz_wgrad         dW = A^T . G, contracted over the rows, split into
//                      chunks of rows that each write a partial tile;
//     rz_ln_rows       LN of each row (one warp per row), fp32 and / or
//                      rounded;
//     rz_ln_bwd_rows   the LayerNorm backward per row with the column sums
//                      (d scale, d bias, d LayerScale, d bias of the
//                      projection) as one partial sum per 32-row block;
//     rz_scale_colsum  dm = g * ls2 with the column sums of g * m and dm;
//     rz_reduce_parts  adds partial tiles / partial column sums in a fixed
//                      order and rounds once.
//   No sum crosses blocks through atomics or `+=`: every gradient has the
//   same bits from run to run.
// bf16 products run on the Hopper GEMM of gemm_sm90.cu (TMA and wgmma: the
// forward recompute and the dX products with their epilogues, W read K-major
// for dh = g . W^T, and dW with A read MN-major, one work item per tile and
// chunk of rows); fp32 products on the CUDA cores in true fp32
// (gemm_f32_kernel of gemm.cuh, wgrad_f32_kernel here).
// Not yet done (later work): fusing the chain's row passes into GEMM
// prologues, walking rows in chunks to bound the scratch.
#include "gemm.cuh"
#include "gemm_sm90.cuh"

namespace rz {
namespace bw {

constexpr int RB = 32;   // rows per block of the row kernels (column partial sums)
constexpr int RT = 256;  // their threads

// ---------------------------------------------------------------------------
// dW = A^T . G over a chunk of rows, fp32 (bf16: gemm_sm90_wgrad)
// ---------------------------------------------------------------------------

// grid (ceil(Nb / 64), ceil(Ka / 64), splits)
__global__ void __launch_bounds__(kThreads)
wgrad_f32_kernel(const float* __restrict__ A, const float* __restrict__ G,
                 float* __restrict__ part, int M, int Ka, int Nb, int chunk) {
  using namespace f32;
  __shared__ __align__(128) float As[BK][BM + 4];
  __shared__ __align__(128) float Bs[BK][BN + 8];
  __shared__ __align__(128) float Cs[BM][BN + 4];
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN, tid = threadIdx.x;
  const int r_begin = blockIdx.z * chunk, r_end = min(M, r_begin + chunk);

  TileAccF32 acc;
  acc.zero();
  for (int r0 = r_begin; r0 < r_end; r0 += BK) {
    for (int i = tid; i < BK * BM; i += kThreads) {
      const int r = i / BM, cc = i % BM, row = r0 + r;
      As[r][cc] = (row < r_end && m0 + cc < Ka) ? A[(size_t)row * Ka + m0 + cc] : 0.f;
      Bs[r][cc] = (row < r_end && n0 + cc < Nb) ? G[(size_t)row * Nb + n0 + cc] : 0.f;
    }
    __syncthreads();
    acc.mma_at(&As[0][0], BM + 4, &Bs[0][0], BN + 8, BK);
    __syncthreads();
  }
  acc.store(&Cs[0][0], BN + 4);
  __syncthreads();
  float* dst = part + (size_t)blockIdx.z * Ka * Nb;
  for (int i = tid; i < BM * BN; i += kThreads) {
    const int r = i / BN, cc = i % BN;
    if (m0 + r < Ka && n0 + cc < Nb) dst[(size_t)(m0 + r) * Nb + n0 + cc] = Cs[r][cc];
  }
}

// out[i] = sum over s of part[s, i], in order, rounded once
template <typename T>
__global__ void __launch_bounds__(RT)
reduce_parts_kernel(const float* __restrict__ part, T* __restrict__ out, int S, size_t n) {
  const size_t i = (size_t)blockIdx.x * RT + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int k = 0; k < S; ++k) s += part[(size_t)k * n + i];
  out[i] = from_f32<T>(s);
}

// wt (N, K) = w (K, N)^T, fp32 (bf16 products read W K-major instead)
__global__ void __launch_bounds__(256)
transpose_kernel(const float* __restrict__ w, float* __restrict__ wt, int K, int N) {
  __shared__ float tile[32][33];
  const int k0 = blockIdx.y * 32, n0 = blockIdx.x * 32;
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  for (int r = ty; r < 32; r += 8)
    if (k0 + r < K && n0 + tx < N) tile[r][tx] = w[(size_t)(k0 + r) * N + n0 + tx];
  __syncthreads();
  for (int r = ty; r < 32; r += 8)
    if (n0 + r < N && k0 + tx < K) wt[(size_t)(n0 + r) * K + k0 + tx] = tile[tx][r];
}

// ---------------------------------------------------------------------------
// row passes
// ---------------------------------------------------------------------------

// mean and rstd of one row of width D, by one warp (two passes, fp32)
template <typename TU>
__device__ __forceinline__ void warp_row_stats(const TU* row, int D, float eps, int lane,
                                               float& mean, float& rstd) {
  float s = 0.f, v = 0.f;
  for (int k = lane; k < D; k += 32) s += to_f32(row[k]);
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  mean = s / D;
  for (int k = lane; k < D; k += 32) {
    const float d = to_f32(row[k]) - mean;
    v += d * d;
  }
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  rstd = rsqrtf(v / D + eps);
}

// LN(u) * scale + bias per row -> out_t (operand type) and / or out_f (fp32)
template <typename T, typename TU>
__global__ void __launch_bounds__(RT)
ln_rows_kernel(const TU* __restrict__ u, const T* __restrict__ scale, const T* __restrict__ bias,
               T* __restrict__ out_t, float* __restrict__ out_f, int M, int D, float eps) {
  const int lane = threadIdx.x % 32, m = blockIdx.x * (RT / 32) + threadIdx.x / 32;
  if (m >= M) return;
  const TU* row = u + (size_t)m * D;
  float mean, rstd;
  warp_row_stats<TU>(row, D, eps, lane, mean, rstd);
  for (int k = lane; k < D; k += 32) {
    const float y = (to_f32(row[k]) - mean) * rstd * to_f32(scale[k]) + to_f32(bias[k]);
    if (out_t != nullptr) out_t[(size_t)m * D + k] = from_f32<T>(y);
    if (out_f != nullptr) out_f[(size_t)m * D + k] = y;
  }
}

struct LnBwdArgs {
  const void* u;      // (M, D) the LayerNorm's input (TU)
  const void* dh;     // (M, D) gradient of the LayerNorm's output (TD)
  const void* scale;  // (D,) LN scale, operand type
  const void* add;    // (M, D) operand type, added to the LN input gradient, or null
  const void* ls;     // (D,) operand type: out2 = d * ls and c2 sums d * ls; null -> 1
  const float* proj;  // (M, D) fp32: c3 sums d * proj; or null
  void* out1;         // (M, D) operand type: d
  void* out2;         // (M, D) operand type: d * ls, or null
  float* out32;       // (M, D) fp32: d, or null
  float* cpart;       // (4, blocks, D) fp32 column sums per block:
                      //   c0 = dh * xn, c1 = dh, c2 = d * ls, c3 = d * proj
  int M, D;
  float eps;
};

// d = rstd * (dxn - mean(dxn) - xn * mean(dxn * xn)) [+ add], dxn = dh * scale
template <typename T, typename TU, typename TD>
__global__ void __launch_bounds__(RT) ln_bwd_rows_kernel(LnBwdArgs p) {
  __shared__ float mu[RB], rs[RB], m1s[RB], m2s[RB];
  const TU* U = static_cast<const TU*>(p.u);
  const TD* DH = static_cast<const TD*>(p.dh);
  const T* scale = static_cast<const T*>(p.scale);
  const T* add = static_cast<const T*>(p.add);
  const T* ls = static_cast<const T*>(p.ls);
  const int D = p.D, m0 = blockIdx.x * RB;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;

  for (int r = warp; r < RB; r += RT / 32) {  // phase 1: one warp per row
    const int gm = m0 + r;
    float mean = 0.f, rstd = 0.f, m1 = 0.f, m2 = 0.f;
    if (gm < p.M) {
      const TU* row = U + (size_t)gm * D;
      const TD* drow = DH + (size_t)gm * D;
      warp_row_stats<TU>(row, D, p.eps, lane, mean, rstd);
      for (int k = lane; k < D; k += 32) {
        const float dxn = to_f32(drow[k]) * to_f32(scale[k]);
        m1 += dxn;
        m2 += dxn * ((to_f32(row[k]) - mean) * rstd);
      }
      for (int o = 16; o > 0; o >>= 1) {
        m1 += __shfl_xor_sync(0xffffffffu, m1, o);
        m2 += __shfl_xor_sync(0xffffffffu, m2, o);
      }
      m1 /= D;
      m2 /= D;
    }
    if (lane == 0) { mu[r] = mean; rs[r] = rstd; m1s[r] = m1; m2s[r] = m2; }
  }
  __syncthreads();

  const size_t cstride = (size_t)gridDim.x * D;  // phase 2: one thread per column
  for (int c = threadIdx.x; c < D; c += RT) {
    const float sc = to_f32(scale[c]), lsv = ls != nullptr ? to_f32(ls[c]) : 1.0f;
    float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
    for (int r = 0; r < RB && m0 + r < p.M; ++r) {
      const size_t o = (size_t)(m0 + r) * D + c;
      const float xn = (to_f32(U[o]) - mu[r]) * rs[r];
      const float dh = to_f32(DH[o]);
      float d = rs[r] * (dh * sc - m1s[r] - xn * m2s[r]);
      if (add != nullptr) d += to_f32(add[o]);
      static_cast<T*>(p.out1)[o] = from_f32<T>(d);
      if (p.out2 != nullptr) static_cast<T*>(p.out2)[o] = from_f32<T>(d * lsv);
      if (p.out32 != nullptr) p.out32[o] = d;
      a0 += dh * xn;
      a1 += dh;
      a2 += d * lsv;
      if (p.proj != nullptr) a3 += d * p.proj[o];
    }
    float* cp = p.cpart + (size_t)blockIdx.x * D + c;
    cp[0] = a0;
    cp[cstride] = a1;
    cp[2 * cstride] = a2;
    cp[3 * cstride] = a3;
  }
}

// out = g * ls (rounded); cpart (2, blocks, D): c0 = sum g * m, c1 = sum g * ls.
// m, ls and out may be null (m -> c0 = 0, ls -> 1).
template <typename T>
__global__ void __launch_bounds__(RT)
scale_colsum_kernel(const T* __restrict__ g, const float* __restrict__ m,
                    const T* __restrict__ ls, T* __restrict__ out, float* __restrict__ cpart,
                    int M, int D) {
  const int m0 = blockIdx.x * RB;
  const size_t cstride = (size_t)gridDim.x * D;
  for (int c = threadIdx.x; c < D; c += RT) {
    const float lsv = ls != nullptr ? to_f32(ls[c]) : 1.0f;
    float a0 = 0.f, a1 = 0.f;
    for (int r = 0; r < RB && m0 + r < M; ++r) {
      const size_t o = (size_t)(m0 + r) * D + c;
      const float gv = to_f32(g[o]), dm = gv * lsv;
      if (m != nullptr) a0 += gv * m[o];
      a1 += dm;
      if (out != nullptr) out[o] = from_f32<T>(dm);
    }
    cpart[(size_t)blockIdx.x * D + c] = a0;
    cpart[cstride + (size_t)blockIdx.x * D + c] = a1;
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

// the fp32 products of the chains (bf16: gemm_sm90)
cudaError_t bwd_gemm_f32(const GemmArgs& g, int epi, cudaStream_t s) {
  switch (epi) {
    case EPI_BIAS: return launch_gemm<false, EPI_BIAS>(g, s);
    case EPI_ADD_F32: return launch_gemm<false, EPI_ADD_F32>(g, s);
    case EPI_ADDF_F32: return launch_gemm<false, EPI_ADDF_F32>(g, s);
    case EPI_PROJ2: return launch_gemm<false, EPI_PROJ2>(g, s);
    case EPI_GELU_H1: return launch_gemm<false, EPI_GELU_H1>(g, s);
    case EPI_F32: return launch_gemm<false, EPI_F32>(g, s);
    case EPI_DGELU: return launch_gemm<false, EPI_DGELU>(g, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, typename TU>
cudaError_t ln_bwd_rows(const LnBwdArgs& p, bool dh_f32, cudaStream_t s) {
  const int blocks = (p.M + RB - 1) / RB;
  if (dh_f32)
    ln_bwd_rows_kernel<T, TU, float><<<blocks, RT, 0, s>>>(p);
  else
    ln_bwd_rows_kernel<T, TU, T><<<blocks, RT, 0, s>>>(p);
  return cudaGetLastError();
}

}  // namespace bw
}  // namespace rz

using bf16 = __nv_bfloat16;
namespace bw = rz::bw;

// rows per block of the row passes: the column partial sums are (ceil(M / this), D)
extern "C" int rz_bwd_row_block() { return bw::RB; }

// rows per block of the GEMM whose epilogue sums columns (colpart is (ceil(M / this), N))
extern "C" int rz_bwd_gemm_row_tile(int dtype) {
  return dtype == RZ_DTYPE_BF16 ? rz::kSm90RowTile : rz::f32::BM;
}

// out (M, N) = a (M, K) . w (K, N) with the epilogue `epi` of gemm.cuh, or a . w^T
// with w (N, K) when w_t (bf16 only: fp32 takes a copy from rz_transpose); bias,
// resid, ls, aux, out2 and colpart as that epilogue reads them, else null
extern "C" int rz_bwd_gemm(const void* a, const void* w, const void* bias, const void* resid,
                           const void* ls, const void* aux, void* out, void* out2,
                           void* colpart, int M, int N, int K, int epi, int w_t, int dtype,
                           void* stream) {
  if (N % 64 || K % 32 || (w_t && dtype != RZ_DTYPE_BF16))
    return static_cast<int>(cudaErrorInvalidValue);
  rz::GemmArgs g{a, w, bias, nullptr, nullptr, 0.f, resid, ls, out, M, N, K};
  g.out2 = out2;
  g.aux = static_cast<const float*>(aux);
  g.colpart = static_cast<float*>(colpart);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dtype == RZ_DTYPE_BF16 ? rz::gemm_sm90(g, epi, s, w_t != 0)
                                                 : bw::bwd_gemm_f32(g, epi, s));
}

// part (splits, Ka, Nb) fp32: part[z] = a[rows of chunk z]^T . g[rows of chunk z];
// a chunk is ceil(M / splits) rows rounded up to 64 (bf16, Ka % 64 == 0) or 32 (fp32)
extern "C" int rz_wgrad(const void* a, const void* g, void* part, int M, int Ka, int Nb,
                        int splits, int dtype, void* stream) {
  if (splits < 1 || Ka % 8 || Nb % 8) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == RZ_DTYPE_BF16)
    return static_cast<int>(
        rz::gemm_sm90_wgrad(a, g, static_cast<float*>(part), M, Ka, Nb, splits, s));
  const int chunk = ((M + splits - 1) / splits + 31) / 32 * 32;
  dim3 grid((Nb + 63) / 64, (Ka + 63) / 64, splits);
  bw::wgrad_f32_kernel<<<grid, rz::kThreads, 0, s>>>(
      static_cast<const float*>(a), static_cast<const float*>(g), static_cast<float*>(part), M,
      Ka, Nb, chunk);
  return static_cast<int>(cudaGetLastError());
}

// out (n,) operand type = sum over s of part (S, n) fp32, in order
extern "C" int rz_reduce_parts(const void* part, void* out, int S, long long n, int dtype,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned blocks = (unsigned)((n + bw::RT - 1) / bw::RT);
  if (dtype == RZ_DTYPE_BF16)
    bw::reduce_parts_kernel<bf16><<<blocks, bw::RT, 0, s>>>(
        static_cast<const float*>(part), static_cast<bf16*>(out), S, (size_t)n);
  else
    bw::reduce_parts_kernel<float><<<blocks, bw::RT, 0, s>>>(
        static_cast<const float*>(part), static_cast<float*>(out), S, (size_t)n);
  return static_cast<int>(cudaGetLastError());
}

// wt (N, K) = w (K, N)^T, fp32 only
extern "C" int rz_transpose(const void* w, void* wt, int K, int N, int dtype, void* stream) {
  if (dtype == RZ_DTYPE_BF16) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((N + 31) / 32, (K + 31) / 32);
  bw::transpose_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(w), static_cast<float*>(wt), K, N);
  return static_cast<int>(cudaGetLastError());
}

// LN(u) per row -> out_t (operand type) and / or out_f (fp32); u is fp32 when u_f32
extern "C" int rz_ln_rows(const void* u, int u_f32, const void* scale, const void* bias,
                          void* out_t, void* out_f, int M, int D, float eps, int dtype,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = (M + bw::RT / 32 - 1) / (bw::RT / 32);
  float* of = static_cast<float*>(out_f);
  if (dtype != RZ_DTYPE_BF16)
    bw::ln_rows_kernel<float, float><<<blocks, bw::RT, 0, s>>>(
        static_cast<const float*>(u), static_cast<const float*>(scale),
        static_cast<const float*>(bias), static_cast<float*>(out_t), of, M, D, eps);
  else if (u_f32)
    bw::ln_rows_kernel<bf16, float><<<blocks, bw::RT, 0, s>>>(
        static_cast<const float*>(u), static_cast<const bf16*>(scale),
        static_cast<const bf16*>(bias), static_cast<bf16*>(out_t), of, M, D, eps);
  else
    bw::ln_rows_kernel<bf16, bf16><<<blocks, bw::RT, 0, s>>>(
        static_cast<const bf16*>(u), static_cast<const bf16*>(scale),
        static_cast<const bf16*>(bias), static_cast<bf16*>(out_t), of, M, D, eps);
  return static_cast<int>(cudaGetLastError());
}

// the LayerNorm backward per row, see LnBwdArgs; u / dh are fp32 when flagged
extern "C" int rz_ln_bwd_rows(const void* u, int u_f32, const void* dh, int dh_f32,
                              const void* scale, const void* add, const void* ls,
                              const void* proj, void* out1, void* out2, void* out32,
                              void* cpart, int M, int D, float eps, int dtype, void* stream) {
  bw::LnBwdArgs p{u, dh, scale, add, ls, static_cast<const float*>(proj), out1, out2,
                  static_cast<float*>(out32), static_cast<float*>(cpart), M, D, eps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype != RZ_DTYPE_BF16)
    err = bw::ln_bwd_rows<float, float>(p, true, s);
  else if (u_f32)
    err = bw::ln_bwd_rows<bf16, float>(p, dh_f32 != 0, s);
  else
    err = bw::ln_bwd_rows<bf16, bf16>(p, dh_f32 != 0, s);
  return static_cast<int>(err);
}

// out = g * ls with column partial sums, see scale_colsum_kernel
extern "C" int rz_scale_colsum(const void* g, const void* m, const void* ls, void* out,
                               void* cpart, int M, int D, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = (M + bw::RB - 1) / bw::RB;
  if (dtype == RZ_DTYPE_BF16)
    bw::scale_colsum_kernel<bf16><<<blocks, bw::RT, 0, s>>>(
        static_cast<const bf16*>(g), static_cast<const float*>(m), static_cast<const bf16*>(ls),
        static_cast<bf16*>(out), static_cast<float*>(cpart), M, D);
  else
    bw::scale_colsum_kernel<float><<<blocks, bw::RT, 0, s>>>(
        static_cast<const float*>(g), static_cast<const float*>(m),
        static_cast<const float*>(ls), static_cast<float*>(out), static_cast<float*>(cpart), M,
        D);
  return static_cast<int>(cudaGetLastError());
}
