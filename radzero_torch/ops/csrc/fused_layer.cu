// K1 fused_preattn, K2 packed attention, K3 fused_postattn, K4
// fused_mpnet_post for Hopper.
//
// Replace the TPU kernels of radzero_tpu/ops/fused_layer.py:
//   K1 fused_preattn           (_preattn_kernel)
//   K2 flash_attention_packed  (_packed_attn_kernel)
//   K3 fused_postattn          (_postattn_kernel)
//   K4 _mpnet_post_call        (_mpnet_post_kernel)
// with the same contracts: fp32 LayerNorm, softmax and accumulation on
// fp32 or bf16 operands, rounded to the operand type where the JAX code
// rounds (LN output before a GEMM, GELU output before fc2, softmax
// weights before P.V).
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
// - K2: the TPU kernel holds one head's whole (L x L) fp32 score matrix
//   in VMEM; K plus V alone exceed an SM's shared memory at L = 1370. The
//   port is FA2-style: one block per (image, head, 128-query tile), each
//   of its 8 warps owning 16 query rows from scores to output, an online
//   softmax over 64-key tiles with a running max, q/k/v read by stride
//   from the packed (B, L, 3D) buffer (the next K/V tile in flight while
//   the current one is used), keys >= L masked inside the last tile, heads
//   merged on write. S and P.V pass through warp-private shared memory,
//   because WMMA leaves its accumulator layout unspecified. It always
//   keeps the running max and never rounds the exponent argument: the JAX
//   serving shortcuts for bf16 (stable=False, round_bf16=True) are not
//   mirrored, which the bf16 tolerance of the card check allows for.
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

// ---------------------------------------------------------------------------
// K2: packed-layout attention, online softmax, head_dim 64
// ---------------------------------------------------------------------------

constexpr int HD = 64;           // head dim (ViT-B/14: 768 / 12)
constexpr int AQ = 128;          // query rows per block: 8 warps x 16
constexpr int AK = 64;           // keys per tile
constexpr int AT = 256;          // threads per block
constexpr int AP = HD + 8;       // operand pitch (elements)
constexpr int SP = AK + 4;       // fp32 score pitch

template <typename T>
struct KVLoader {  // one thread's share of the next K and V tiles, 16-byte vectors
  static constexpr int VEC = 16 / sizeof(T), PER_ROW = HD / VEC;
  static constexpr int N = AK * HD / VEC / AT;
  uint4 k[N], v[N];

  __device__ void load(const T* base, int D3, int D, int h, int k0, int L) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int idx = threadIdx.x + i * AT;
      const int r = idx / PER_ROW, c = (idx % PER_ROW) * VEC, key = k0 + r;
      const T* row = base + (size_t)key * D3 + h * HD + c;
      k[i] = key < L ? *reinterpret_cast<const uint4*>(row + D) : make_uint4(0, 0, 0, 0);
      v[i] = key < L ? *reinterpret_cast<const uint4*>(row + 2 * D) : make_uint4(0, 0, 0, 0);
    }
  }

  __device__ void store(T* Ks, T* Vs) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int idx = threadIdx.x + i * AT;
      const int off = (idx / PER_ROW) * AP + (idx % PER_ROW) * VEC;
      *reinterpret_cast<uint4*>(Ks + off) = k[i];
      *reinterpret_cast<uint4*>(Vs + off) = v[i];
    }
  }
};

template <typename T>
size_t attention_smem() {
  return align_up((size_t)(AQ + 2 * AK) * AP * sizeof(T), 128) +
         (AT / 32) * (align_up(16 * SP * sizeof(float), 128) +
                      align_up(16 * AP * sizeof(T), 128));
}

// grid (ceil(L / 128), H, B); qkv (B, L, 3 * H * 64) -> out (B, L, H * 64).
// Each warp owns 16 query rows end to end (scores, softmax, P.V, output),
// so only the K/V tile exchange needs the whole block; the next K/V tile
// is loaded into registers while the current one is in use.
template <typename T>
__global__ void __launch_bounds__(AT, 2)
packed_attention_kernel(const T* __restrict__ qkv, T* __restrict__ out, int L, int H,
                        float scale_log2e) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  T* Qs = reinterpret_cast<T*>(smem);
  T* Ks = Qs + AQ * AP;
  T* Vs = Ks + AK * AP;
  unsigned char* wbase = smem + align_up((size_t)(AQ + 2 * AK) * AP * sizeof(T), 128) +
                         warp * (align_up(16 * SP * sizeof(float), 128) +
                                 align_up(16 * AP * sizeof(T), 128));
  float* Sw = reinterpret_cast<float*>(wbase);                 // 16 x SP
  T* Pw = reinterpret_cast<T*>(wbase + align_up(16 * SP * sizeof(float), 128));

  const int q0 = blockIdx.x * AQ, h = blockIdx.y, b = blockIdx.z;
  const int D = H * HD, D3 = 3 * D;
  const T* base = qkv + (size_t)b * L * D3;

  for (int i = threadIdx.x; i < AQ * HD; i += AT) {
    const int r = i / HD, c = i % HD, q = q0 + r;
    Qs[r * AP + c] = q < L ? base[(size_t)q * D3 + h * HD + c] : from_f32<T>(0.f);
  }
  const T* Qw = Qs + warp * 16 * AP;

  // lane ownership: row r of the warp's 16, columns / dims [half * 32, + 32)
  const int r = lane / 2, half = lane % 2;
  float o[32];
#pragma unroll
  for (int j = 0; j < 32; ++j) o[j] = 0.f;
  float m = -INFINITY, l = 0.f;

  KVLoader<T> next;
  next.load(base, D3, D, h, 0, L);
  for (int k0 = 0; k0 < L; k0 += AK) {
    next.store(Ks, Vs);
    __syncthreads();
    if (k0 + AK < L) next.load(base, D3, D, h, k0 + AK, L);

    WarpAcc<T, true> s;  // S = Q . K^T for this warp's rows
    s.zero();
    s.mma(Qw, AP, Ks, AP, HD);
    s.store(Sw, SP);
    __syncwarp();

    float tmax = -INFINITY;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int col = half * 32 + j;
      const float v = (k0 + col < L) ? Sw[r * SP + col] * scale_log2e : -INFINITY;
      Sw[r * SP + col] = v;
      tmax = fmaxf(tmax, v);
    }
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    const float m_new = fmaxf(m, tmax);
    const float alpha = exp2f(m - m_new);  // 0 on the first tile
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int col = half * 32 + j;
      const float p = exp2f(Sw[r * SP + col] - m_new);
      psum += p;
      Pw[r * AP + col] = from_f32<T>(p);
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    l = l * alpha + psum;
    m = m_new;
    __syncwarp();

    WarpAcc<T, false> pv;  // P . V
    pv.zero();
    pv.mma(Pw, AP, Vs, AP, AK);
    pv.store(Sw, SP);
    __syncwarp();
#pragma unroll
    for (int j = 0; j < 32; ++j) o[j] = o[j] * alpha + Sw[r * SP + half * 32 + j];
    __syncthreads();  // K/V (and Sw) are rewritten next step
  }

  const int q = q0 + warp * 16 + r;
  if (q < L) {
    T* dst = out + ((size_t)b * L + q) * D + h * HD + half * 32;
#pragma unroll
    for (int j = 0; j < 32; ++j) dst[j] = from_f32<T>(o[j] / l);
  }
}

template <typename T>
cudaError_t launch_attention(const void* qkv, void* out, int B, int L, int H,
                             float scale_log2e, cudaStream_t stream) {
  const size_t smem = attention_smem<T>();
  cudaError_t err = allow_smem(packed_attention_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((L + AQ - 1) / AQ, H, B);
  packed_attention_kernel<T><<<grid, AT, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<T*>(out), L, H, scale_log2e);
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

// K2: qkv (B, L, 3D) -> out (B, L, D), D = H * 64
extern "C" int rz_packed_attention(const void* qkv, void* out, int B, int L, int H,
                                   int hd, float scale_log2e, int dtype, void* stream) {
  if (hd != rz::HD) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == RZ_DTYPE_BF16
                        ? rz::launch_attention<bf16>(qkv, out, B, L, H, scale_log2e, s)
                        : rz::launch_attention<float>(qkv, out, B, L, H, scale_log2e, s);
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
