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
//   768 / 2304 / 3072) and so bound by the math units. bf16: one 128x128
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
#include "common.cuh"

namespace rz {

enum Epilogue {
  EPI_BIAS = 0,       // out_T   = acc + b                        (K1)
  EPI_RESID_F32 = 1,  // out_f32 = x_T + ls * (acc + b)           (K3 o-proj)
  EPI_GELU = 2,       // out_T   = gelu(acc + b)                  (K3 fc1)
  EPI_RESID_OUT = 3,  // out_T   = y_f32 + ls * (acc + b)         (K3 fc2)
  EPI_ADD_F32 = 4,    // out_f32 = x_T + (acc + b)                (K4 o-proj)
  EPI_ADDF_F32 = 5,   // out_f32 = y_f32 + (acc + b)              (K4 fc2)
};

struct GemmArgs {
  const void* a;      // (M, K) row-major: operand type, or fp32 under LN
  const void* w;      // (K, N) row-major, operand type
  const void* bias;   // (N,)
  const void* ln_s;   // (K,) LN prologue scale / bias (operand type)
  const void* ln_b;
  float eps;
  const void* resid;  // (M, N) residual: x (operand type) or y (fp32)
  const void* ls;     // (N,) LayerScale
  void* out;          // (M, N)
  int M, N, K;
};

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

// out[gm, gn] from the fp32 product acc = (A . W)[gm, gn]
template <typename T, int EPI>
__device__ __forceinline__ void epilogue(const GemmArgs& g, int gm, int gn, float acc) {
  const size_t o = (size_t)gm * g.N + gn;
  const float v = acc + to_f32(static_cast<const T*>(g.bias)[gn]);
  const T* ls = static_cast<const T*>(g.ls);
  if (EPI == EPI_BIAS) {
    static_cast<T*>(g.out)[o] = from_f32<T>(v);
  } else if (EPI == EPI_RESID_F32) {
    const float x = to_f32(static_cast<const T*>(g.resid)[o]);
    static_cast<float*>(g.out)[o] = x + to_f32(ls[gn]) * v;
  } else if (EPI == EPI_GELU) {
    const float ge = v * 0.5f * (1.0f + erff(v * 0.70710678118654752f));
    static_cast<T*>(g.out)[o] = from_f32<T>(ge);
  } else if (EPI == EPI_RESID_OUT) {
    const float y = static_cast<const float*>(g.resid)[o];
    static_cast<T*>(g.out)[o] = from_f32<T>(y + to_f32(ls[gn]) * v);
  } else if (EPI == EPI_ADD_F32) {
    static_cast<float*>(g.out)[o] = to_f32(static_cast<const T*>(g.resid)[o]) + v;
  } else {  // EPI_ADDF_F32
    static_cast<float*>(g.out)[o] = static_cast<const float*>(g.resid)[o] + v;
  }
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
  for (int i = tid; i < BM * BN; i += kThreads) {
    const int r = i / BN, c = i % BN;
    if (m0 + r < g.M) epilogue<float, EPI>(g, m0 + r, n0 + c, Cs[r][c]);
  }
}

// bf16 operands: 128x128 block tile, 256 threads = 8 warps (2 x 4), each
// warp a 64x32 tile of 4x2 WMMA fragments; 16-byte global loads, held in
// registers one k-step ahead so that they overlap the tensor-core work.
// A is bf16, or fp32 (K3's fc1 reads y32) with the LN prologue; the LN
// output is rounded to bf16 as it is staged. The epilogue runs per 16x16
// fragment through a warp-private fp32 scratch tile.
// N % 8 == 0 (masked at 128), K % 32 == 0.
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

  template <bool LN>
  __device__ void store(__nv_bfloat16 (*As)[wm::LDA], const GemmArgs& g, int m0, int k0,
                        const float* mu, const float* rs) {
    const __nv_bfloat16* lns = static_cast<const __nv_bfloat16*>(g.ln_s);
    const __nv_bfloat16* lnb = static_cast<const __nv_bfloat16*>(g.ln_b);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int idx = threadIdx.x + i * wm::THREADS;
      const int r = idx / PER_ROW, c = (idx % PER_ROW) * VEC;
      const TA* x = reinterpret_cast<const TA*>(&v[i]);
      __align__(16) __nv_bfloat16 out[8];
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        float f = to_f32(x[e]);
        if (LN && m0 + r < g.M)
          f = (f - mu[r]) * rs[r] * to_f32(lns[k0 + c + e]) + to_f32(lnb[k0 + c + e]);
        out[e] = __float2bfloat16(f);
      }
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

template <typename TA, bool LN, int EPI>
__global__ void __launch_bounds__(wm::THREADS, 2) gemm_bf16_kernel(GemmArgs g) {
  using namespace wm;
  using namespace nvcuda;
  __shared__ __align__(128) __nv_bfloat16 As[BM][LDA];
  __shared__ __align__(128) __nv_bfloat16 Bs[BK][LDB];
  __shared__ __align__(128) float scratch[THREADS / 32][16 * 16];
  __shared__ float mu[BM], rs[BM];

  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int wr = (warp / 4) * 64, wc = (warp % 4) * 32;
  if (LN) {
    row_stats<TA>(g, m0, mu, rs);
    __syncthreads();
  }

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
    a_next.template store<LN>(As, g, m0, k0, mu, rs);
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
    gemm_bf16_kernel<TA, LN, EPI><<<grid, wm::THREADS, 0, stream>>>(g);
  }
  return cudaGetLastError();
}

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
