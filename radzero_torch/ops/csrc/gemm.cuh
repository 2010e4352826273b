// The GEMM of the fused-layer kernels: C[M, N] = prologue(A)[M, K] . W[K, N]
// with a fused epilogue. Which kernel runs where:
// - gemm_f32_kernel: every fp32 product (K1, K3, K4 and the chains of K6, K8,
//   K9), the verification path: 64x64 tiles of true fp32 FMAs on the CUDA
//   cores (no TF32), with the LayerNorm prologue for K1 and K3's fc1;
// - every bf16 product (K1, K3, K4 and the chains of K6, K8 and K9) runs
//   gemm_sm90_kernel (gemm_sm90.cu: TMA and wgmma) on the epilogues defined
//   here.
// The fp32 LN prologue computes mean/rstd of the block's rows, then
// normalises A while staging it, so the LN output never reaches device
// memory. Rows are masked, never padded.
//
// An epilogue may also return a value whose column sum over the block's
// rows gemm_f32_kernel writes to colpart[blockIdx.y, column] (EPI_DGELU: the
// bias gradient): summed in a fixed order inside the block, no atomics; a
// reduce kernel adds the row tiles up afterwards.
#pragma once

#include "common.cuh"

namespace rz {

enum Epilogue {
  EPI_BIAS = 0,       // out_T   = acc + b                        (K1; K6/K8/K9 da)
  EPI_RESID_F32 = 1,  // out_f32 = x_T + ls * (acc + b)           (K3 o-proj)
  EPI_GELU = 2,       // out_T   = gelu(acc + b)                  (K3 fc1)
  EPI_RESID_OUT = 3,  // out_T   = y_f32 + ls * (acc + b)         (K3 fc2)
  EPI_ADD_F32 = 4,    // out_f32 = x_T + (acc + b)                (K4 o-proj)
  EPI_ADDF_F32 = 5,   // out_f32 = y_f32 + (acc + b)              (K4 fc2; K9 dyln)
  EPI_PROJ2 = 6,      // out2_f32 = acc + b; out_f32 = x_T + ls * out2   (K8 o-proj)
  EPI_GELU_H1 = 7,    // out2_f32 = acc + b; out_T = gelu(out2)          (K8/K9 fc1)
  EPI_F32 = 8,        // out_f32 = acc + b                        (K8 fc2, K6 dh, K8 dhln)
  EPI_DGELU = 9,      // out_T = acc * gelu'(aux_f32); column sums of the unrounded value
};

struct GemmArgs {
  const void* a;      // (M, K) row-major: operand type, or fp32 under LN
  const void* w;      // (K, N) row-major, operand type
  const void* bias;   // (N,), or null for none
  const void* ln_s;   // (K,) LN prologue scale / bias (operand type)
  const void* ln_b;
  float eps;
  const void* resid;  // (M, N) residual: x (operand type) or y (fp32)
  const void* ls;     // (N,) LayerScale
  void* out;          // (M, N)
  int M, N, K;
  void* out2 = nullptr;           // (M, N) fp32 second output
  const float* aux = nullptr;     // (M, N) fp32 extra input (EPI_DGELU: pre-GELU h1)
  float* colpart = nullptr;       // (row tiles, N) fp32 column sums per row tile
  int splits = 1;                 // gemm_sm90_wgrad: chunks of the rows (the reduction)
  int chunk_steps = 0;            // and the 64-row k-steps of one
  int batch = 1;                  // gemm_sm90_dtn: images, each its own product
  int k_split = 0;                // and the first k that its second B operand holds
};

constexpr float kInvSqrt2 = 0.70710678118654752f;
constexpr float kInvSqrt2Pi = 0.3989422804014327f;

// Phi(v), the normal distribution function, with the exact erf
__device__ __forceinline__ float gelu_phi(float v) { return 0.5f * (1.0f + erff(v * kInvSqrt2)); }

// fp32 two-pass LayerNorm statistics of rows [m0, m0 + 16 * warps), 16
// rows per warp, from 16-byte loads (K % (16 / sizeof(TA)) == 0); rows
// >= M get mean 0, rstd 0.
template <typename TA>
__device__ void row_stats(const GemmArgs& g, int m0, float* mu, float* rs) {
  constexpr int VEC = 16 / sizeof(TA);
  const TA* A = static_cast<const TA*>(g.a);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  for (int r = warp * 16; r < warp * 16 + 16; ++r) {
    const int gm = m0 + r;
    float mean = 0.f, rstd = 0.f;
    if (gm < g.M) {
      const TA* row = A + (size_t)gm * g.K;
      float s = 0.f, v = 0.f;
      for (int k = lane * VEC; k < g.K; k += 32 * VEC) {
        const uint4 u = *reinterpret_cast<const uint4*>(row + k);
        const TA* x = reinterpret_cast<const TA*>(&u);
#pragma unroll
        for (int e = 0; e < VEC; ++e) s += to_f32(x[e]);
      }
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      mean = s / g.K;
      for (int k = lane * VEC; k < g.K; k += 32 * VEC) {
        const uint4 u = *reinterpret_cast<const uint4*>(row + k);
        const TA* x = reinterpret_cast<const TA*>(&u);
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const float d = to_f32(x[e]) - mean;
          v += d * d;
        }
      }
      for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      rstd = rsqrtf(v / g.K + g.eps);
    }
    if (lane == 0) { mu[r] = mean; rs[r] = rstd; }
  }
}

// out[gm, gn] from the fp32 product acc = (A . W)[gm, gn]; returns the
// entry's contribution to the column sum (0 unless the epilogue has one)
template <typename T, int EPI>
__device__ __forceinline__ float epilogue(const GemmArgs& g, int gm, int gn, float acc) {
  const size_t o = (size_t)gm * g.N + gn;
  const float v =
      g.bias != nullptr ? acc + to_f32(static_cast<const T*>(g.bias)[gn]) : acc;
  const T* ls = static_cast<const T*>(g.ls);
  if (EPI == EPI_BIAS) {
    static_cast<T*>(g.out)[o] = from_f32<T>(v);
  } else if (EPI == EPI_RESID_F32) {
    const float x = to_f32(static_cast<const T*>(g.resid)[o]);
    static_cast<float*>(g.out)[o] = x + to_f32(ls[gn]) * v;
  } else if (EPI == EPI_GELU) {
    static_cast<T*>(g.out)[o] = from_f32<T>(v * gelu_phi(v));
  } else if (EPI == EPI_RESID_OUT) {
    const float y = static_cast<const float*>(g.resid)[o];
    static_cast<T*>(g.out)[o] = from_f32<T>(y + to_f32(ls[gn]) * v);
  } else if (EPI == EPI_ADD_F32) {
    static_cast<float*>(g.out)[o] = to_f32(static_cast<const T*>(g.resid)[o]) + v;
  } else if (EPI == EPI_ADDF_F32) {
    static_cast<float*>(g.out)[o] = static_cast<const float*>(g.resid)[o] + v;
  } else if (EPI == EPI_PROJ2) {
    const float x = to_f32(static_cast<const T*>(g.resid)[o]);
    static_cast<float*>(g.out2)[o] = v;
    static_cast<float*>(g.out)[o] = x + to_f32(ls[gn]) * v;
  } else if (EPI == EPI_GELU_H1) {
    static_cast<float*>(g.out2)[o] = v;
    static_cast<T*>(g.out)[o] = from_f32<T>(v * gelu_phi(v));
  } else if (EPI == EPI_F32) {
    static_cast<float*>(g.out)[o] = v;
  } else {  // EPI_DGELU: gelu'(h) = Phi(h) + h * pdf(h)
    const float h = g.aux[o];
    const float pdf = kInvSqrt2Pi * exp2f(-(h * h) * (0.5f * kLog2e));
    const float d = v * (gelu_phi(h) + h * pdf);
    static_cast<T*>(g.out)[o] = from_f32<T>(d);
    return d;
  }
  return 0.f;
}

// fp32 operands: 64x64 block tile, 128 threads, CUDA-core FMAs (TileAccF32).
// C[M, N] = prologue(A)[M, K] . W[K, N]; N % 64 == 0, K % 32 == 0.
namespace f32 {
constexpr int BM = 64, BN = 64, BK = 32;
}

template <bool LN, int EPI>
__global__ void __launch_bounds__(kThreads) gemm_f32_kernel(GemmArgs g) {
  using namespace f32;
  __shared__ __align__(128) float As[BM][BK + 8];
  __shared__ __align__(128) float Bs[BK][BN + 8];
  __shared__ __align__(128) float Cs[BM][BN + 4];
  __shared__ float mu[BM], rs[BM];

  const float* A = static_cast<const float*>(g.a);
  const float* W = static_cast<const float*>(g.w);
  const float* lns = static_cast<const float*>(g.ln_s);
  const float* lnb = static_cast<const float*>(g.ln_b);
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN, tid = threadIdx.x;
  if (LN) {
    row_stats<float>(g, m0, mu, rs);
    __syncthreads();
  }

  TileAccF32 acc;
  acc.zero();
  for (int k0 = 0; k0 < g.K; k0 += BK) {
    for (int i = tid; i < BM * BK; i += kThreads) {
      const int r = i / BK, c = i % BK, gm = m0 + r;
      float v = 0.f;
      if (gm < g.M) {
        v = A[(size_t)gm * g.K + k0 + c];
        if (LN) v = (v - mu[r]) * rs[r] * lns[k0 + c] + lnb[k0 + c];
      }
      As[r][c] = v;
    }
    for (int i = tid; i < BK * BN; i += kThreads) {
      const int r = i / BN, c = i % BN;
      Bs[r][c] = W[(size_t)(k0 + r) * g.N + n0 + c];
    }
    __syncthreads();
    acc.mma(&As[0][0], BK + 8, &Bs[0][0], BN + 8, BK);
    __syncthreads();
  }
  acc.store(&Cs[0][0], BN + 4);
  __syncthreads();
  // thread tid owns column tid % 64 and every second row from tid / 64
  float csum = 0.f;
  for (int i = tid; i < BM * BN; i += kThreads) {
    const int r = i / BN, c = i % BN;
    if (m0 + r < g.M) csum += epilogue<float, EPI>(g, m0 + r, n0 + c, Cs[r][c]);
  }
  if (EPI == EPI_DGELU) {
    __syncthreads();
    float* cp = &As[0][0];  // two partial sums per column
    cp[tid] = csum;
    __syncthreads();
    if (tid < BN) g.colpart[(size_t)blockIdx.y * g.N + n0 + tid] = cp[tid] + cp[tid + BN];
  }
}

template <bool LN, int EPI>
cudaError_t launch_gemm(const GemmArgs& g, cudaStream_t stream) {
  dim3 grid(g.N / f32::BN, (g.M + f32::BM - 1) / f32::BM);
  gemm_f32_kernel<LN, EPI><<<grid, kThreads, 0, stream>>>(g);
  return cudaGetLastError();
}

}  // namespace rz
