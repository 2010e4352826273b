// The GEMM of the fused-layer kernels: C[M, N] = prologue(A)[M, K] . W[K, N]
// with a fused epilogue. Which kernel runs where:
// - gemm_f32_kernel: every fp32 product (K1, K3, K4 and the chains of K6, K8,
//   K9), the verification path: 64x64 tiles of true fp32 FMAs on the CUDA
//   cores (no TF32), with the LayerNorm prologue for K1 and K3's fc1;
// - gemm_bf16_kernel: the bf16 products of K4's forward alone (its fc1 reads
//   the fp32 y32 and rounds it while staging, which TMA cannot): one 128x128
//   output tile per 256-thread block, 32-deep k-steps staged in shared
//   memory from 16-byte loads issued one k-step ahead, WMMA tensor-core
//   products with fp32 accumulators (8 warps of 64x32);
// - every other bf16 product (K1, K3 and the chains of K6, K8 and K9) runs
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

// bf16 operands (K4's forward): 128x128 block tile, 256 threads = 8 warps
// (2 x 4), each warp a 64x32 tile of 4x2 WMMA fragments; 16-byte global
// loads, held in registers one k-step ahead so that they overlap the
// tensor-core work. A is bf16, or fp32 (K4's fc1 reads y32), rounded to bf16
// as it is staged; no LN prologue (bf16 LayerNorm is a row pass). The
// epilogue runs per 16x16 fragment through a warp-private fp32 scratch tile,
// and has no column sums. N % 8 == 0 (masked at 128), K % 32 == 0.
namespace wm {
constexpr int BM = 128, BN = 128, BK = 32, THREADS = 256;
constexpr int LDA = BK + 8, LDB = BN + 8;
}

template <typename TA>
struct ALoader {  // one thread's share of a BM x BK tile of A, 16-byte vectors
  static constexpr int VEC = 16 / sizeof(TA), PER_ROW = wm::BK / VEC;
  static constexpr int N = wm::BM * wm::BK / VEC / wm::THREADS;
  uint4 v[N];

  __device__ void load(const GemmArgs& g, int m0, int k0) {
    const TA* A = static_cast<const TA*>(g.a);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int idx = threadIdx.x + i * wm::THREADS;
      const int r = idx / PER_ROW, c = (idx % PER_ROW) * VEC, gm = m0 + r;
      v[i] = gm < g.M ? *reinterpret_cast<const uint4*>(A + (size_t)gm * g.K + k0 + c)
                      : make_uint4(0, 0, 0, 0);
    }
  }

  __device__ void store(__nv_bfloat16 (*As)[wm::LDA]) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int idx = threadIdx.x + i * wm::THREADS;
      const int r = idx / PER_ROW, c = (idx % PER_ROW) * VEC;
      const TA* x = reinterpret_cast<const TA*>(&v[i]);
      __align__(16) __nv_bfloat16 out[8];
#pragma unroll
      for (int e = 0; e < VEC; ++e) out[e] = __float2bfloat16(to_f32(x[e]));
      if (VEC == 8)
        *reinterpret_cast<uint4*>(&As[r][c]) = *reinterpret_cast<const uint4*>(out);
      else
        *reinterpret_cast<uint2*>(&As[r][c]) = *reinterpret_cast<const uint2*>(out);
    }
  }
};

struct BLoader {  // one thread's share of a BK x BN tile of W (bf16)
  static constexpr int PER_ROW = wm::BN / 8, N = wm::BK * wm::BN / 8 / wm::THREADS;
  uint4 v[N];

  __device__ void load(const GemmArgs& g, int n0, int k0) {
    const __nv_bfloat16* W = static_cast<const __nv_bfloat16*>(g.w);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int idx = threadIdx.x + i * wm::THREADS;
      const int r = idx / PER_ROW, c = (idx % PER_ROW) * 8;
      v[i] = n0 + c < g.N ? *reinterpret_cast<const uint4*>(W + (size_t)(k0 + r) * g.N + n0 + c)
                          : make_uint4(0, 0, 0, 0);
    }
  }

  __device__ void store(__nv_bfloat16 (*Bs)[wm::LDB]) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int idx = threadIdx.x + i * wm::THREADS;
      *reinterpret_cast<uint4*>(&Bs[idx / PER_ROW][(idx % PER_ROW) * 8]) = v[i];
    }
  }
};

template <typename TA, int EPI>
__global__ void __launch_bounds__(wm::THREADS, 2) gemm_bf16_kernel(GemmArgs g) {
  using namespace wm;
  using namespace nvcuda;
  __shared__ __align__(128) __nv_bfloat16 As[BM][LDA];
  __shared__ __align__(128) __nv_bfloat16 Bs[BK][LDB];
  __shared__ __align__(128) float scratch[THREADS / 32][16 * 16];

  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int wr = (warp / 4) * 64, wc = (warp % 4) * 32;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> c[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(c[i][j], 0.0f);

  ALoader<TA> a_next;
  BLoader b_next;
  a_next.load(g, m0, 0);
  b_next.load(g, n0, 0);
  for (int k0 = 0; k0 < g.K; k0 += BK) {
    a_next.store(As);
    b_next.store(Bs);
    __syncthreads();
    if (k0 + BK < g.K) {  // next k-step's loads fly during this one's MMAs
      a_next.load(g, m0, k0 + BK);
      b_next.load(g, n0, k0 + BK);
    }
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 4; ++i) wmma::load_matrix_sync(a[i], &As[wr + 16 * i][kk], LDA);
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::load_matrix_sync(b[j], &Bs[kk][wc + 16 * j], LDB);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(c[i][j], a[i], b[j], c[i][j]);
    }
    __syncthreads();
  }

  // lane owns row lane / 2 and columns (lane % 2) * 8 .. + 8 of each fragment
  static_assert(EPI != EPI_DGELU, "no column sums here");
  float* tile = scratch[warp];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(tile, c[i][j], 16, wmma::mem_row_major);
      __syncwarp();
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int idx = lane * 8 + e;
        const int gm = m0 + wr + 16 * i + idx / 16, gn = n0 + wc + 16 * j + idx % 16;
        if (gm < g.M && gn < g.N) epilogue<__nv_bfloat16, EPI>(g, gm, gn, tile[idx]);
      }
      __syncwarp();
    }
}

template <typename T, typename TA, bool LN, int EPI>
cudaError_t launch_gemm(const GemmArgs& g, cudaStream_t stream) {
  if constexpr (std::is_same<T, float>::value) {
    dim3 grid(g.N / f32::BN, (g.M + f32::BM - 1) / f32::BM);
    gemm_f32_kernel<LN, EPI><<<grid, kThreads, 0, stream>>>(g);
  } else {
    dim3 grid((g.N + wm::BN - 1) / wm::BN, (g.M + wm::BM - 1) / wm::BM);
    static_assert(!LN, "bf16 LayerNorm is a row pass, not a prologue");
    gemm_bf16_kernel<TA, EPI><<<grid, wm::THREADS, 0, stream>>>(g);
  }
  return cudaGetLastError();
}

}  // namespace rz
