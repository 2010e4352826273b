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
//                      rounded, and each row's mean and rstd when asked;
//     rz_ln_bwd_rows   the LayerNorm backward per row from those statistics
//                      (or its own), with the column sums the caller asks
//                      for (d scale, d bias, d LayerScale, d bias of the
//                      projection), one partial row per block;
//     rz_scale_colsum  dm = g * ls with the column sums of g * m and / or
//                      dm that the caller asks for;
//     rz_reduce_parts  adds partial tiles / partial column sums in a fixed
//                      order and rounds once (one level: a thread a column);
//     rz_reduce_two_level  the same in two levels for few columns and many
//                      partial rows (the row passes' and the GEMM's column
//                      partials).
//   No sum crosses blocks through atomics or `+=`: every gradient has the
//   same bits from run to run.
// bf16 products run on the Hopper GEMM of gemm_sm90.cu (TMA and wgmma: the
// forward recompute and the dX products with their epilogues, W read K-major
// for dh = g . W^T, and dW with A read MN-major, one work item per tile and
// chunk of rows); fp32 products on the CUDA cores in true fp32
// (gemm_f32_kernel of gemm.cuh, wgrad_f32_kernel here).
// - The row passes move bytes and do little arithmetic (K6's LayerNorm
//   backward reads x and the fp32 dh and writes dx: 539 MB at 64 images, a
//   0.161 ms floor at 3.35 TB/s), so they are built to stream: a lane loads
//   16 bytes at a time (8 columns of bf16, two vectors of fp32), neighbouring
//   lanes on neighbouring vectors, and a warp holds a whole row (D <= 1024) in
//   registers, so each row is read once. ln_rows_kernel writes each row's
//   mean and rstd (8 bytes) and the LayerNorm backward reads them instead of
//   computing them again; both compute them with one function (row_stats),
//   so a stored statistic equals a recomputed one bit for bit.
// - A row pass's column sums would otherwise cost more than the pass: one
//   partial row per 32 rows is 2740 rows at 87 680, which a reduce with one
//   thread a column reads through 2740 dependent loads on 3 blocks. So the
//   passes that sum columns (ln_bwd_rows_kernel, scale_colsum_kernel) run a
//   fixed grid, a multiple of the card's SMs that the wrapper sets, and each
//   block owns one contiguous range of rows (`chunk` rows, the wrapper's
//   partition) and keeps its column sums in registers across it: a few
//   hundred partial rows. The partition depends only on the rows and the
//   SM count, and the warps of a block add into shared memory in warp
//   order, so the bits stay the same from run to run. A pass writes only
//   the sums the caller asks for (`sums`), and one reduce adds all of them.
// - The two-level reduce (reduce_chunks_kernel, then reduce_parts_kernel)
//   spreads few columns and many partial rows over the card: a 2-D grid of
//   (256 columns x chunk of partial rows), each chunk in order, then the
//   chunks in order, rounded once. Where the columns fill the card (the dW
//   partial tiles, K16's batch sum of d(bias)) the one-level kernel stays.
// Not yet done (later work): the LayerNorm backward's column sums in dh's
// GEMM epilogue, fusing the chain's row passes into GEMM prologues, walking
// rows in chunks to bound the scratch.
#include "gemm.cuh"
#include "gemm_sm90.cuh"

namespace rz {
namespace bw {

constexpr int RT = 256;     // threads of the reduces and of the LayerNorm row passes
constexpr int VEC = 8;      // columns a lane loads at once: 16 bytes of bf16, 32 of fp32
constexpr int MAX_NC = 4;   // 8-column chunks a lane holds of a row
constexpr int MAX_D = 32 * VEC * MAX_NC;  // widest row of the LayerNorm row passes
constexpr int CT = 384;     // most threads of scale_colsum_kernel, a thread 8 columns

// the column sums of ln_bwd_rows_kernel (bit s: c_s) and of scale_colsum_kernel
enum : int { SUM_DH_XN = 1, SUM_DH = 2, SUM_D_LS = 4, SUM_D_PROJ = 8 };
enum : int { SUM_G_M = 1, SUM_G_LS = 2 };

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

// ---------------------------------------------------------------------------
// fixed-order reduces
// ---------------------------------------------------------------------------

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

// the first level of the two-level reduce, grid (ceil(n / RT), chunks):
// scratch[y, i] = the sum over s in [y per, min(S, (y + 1) per)) of part[s, i],
// in order; reduce_parts_kernel then adds the chunks in order
__global__ void __launch_bounds__(RT)
reduce_chunks_kernel(const float* __restrict__ part, float* __restrict__ scratch, int S,
                     size_t n, int per) {
  const size_t i = (size_t)blockIdx.x * RT + threadIdx.x;
  if (i >= n) return;
  const int s1 = min(S, (int)(blockIdx.y + 1) * per);
  float s = 0.f;
#pragma unroll 8
  for (int k = blockIdx.y * per; k < s1; ++k) s += part[(size_t)k * n + i];
  scratch[(size_t)blockIdx.y * n + i] = s;
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

// 8 neighbouring values from p (16-byte aligned) as fp32, and back
__device__ __forceinline__ void load8(const float* p, float (&v)[VEC]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[VEC]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < VEC / 2; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store8(float* p, const float (&v)[VEC]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&v)[VEC]) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < VEC / 2; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = raw;
}

// A warp holds a row: lane l its 8-column chunks l, l + 32, l + 64, ...; the
// first column of chunk j (a chunk at or past D is not held)
__device__ __forceinline__ int chunk_col(int j, int lane) { return (j * 32 + lane) * VEC; }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// mean and rstd of the row a warp holds (two passes over the registers, fp32);
// ln_rows_kernel and ln_bwd_rows_kernel both call it, so the statistics
// ln_rows_kernel stores equal those the backward would compute, bit for bit
template <int NC>
__device__ __forceinline__ void row_stats(const float (&x)[NC][VEC], int D, float eps, int lane,
                                          float& mean, float& rstd) {
  float s = 0.f, v = 0.f;
#pragma unroll
  for (int j = 0; j < NC; ++j)
    if (chunk_col(j, lane) < D)
#pragma unroll
      for (int k = 0; k < VEC; ++k) s += x[j][k];
  mean = warp_sum(s) / D;
#pragma unroll
  for (int j = 0; j < NC; ++j)
    if (chunk_col(j, lane) < D)
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        const float d = x[j][k] - mean;
        v = __fmaf_rn(d, d, v);
      }
  rstd = rsqrtf(warp_sum(v) / D + eps);
}

// LN(u) * scale + bias per row, a warp a row -> out_t (operand type) and / or
// out_f (fp32); stats (M,) (mean, rstd) of each row, or null
template <typename T, typename TU, int NC>
__global__ void __launch_bounds__(RT)
ln_rows_kernel(const TU* __restrict__ u, const T* __restrict__ scale, const T* __restrict__ bias,
               T* __restrict__ out_t, float* __restrict__ out_f, float2* __restrict__ stats,
               int M, int D, float eps) {
  const int lane = threadIdx.x % 32, m = blockIdx.x * (RT / 32) + threadIdx.x / 32;
  if (m >= M) return;
  const size_t row = (size_t)m * D;
  float x[NC][VEC];
#pragma unroll
  for (int j = 0; j < NC; ++j)
    if (chunk_col(j, lane) < D) load8(u + row + chunk_col(j, lane), x[j]);
  float mean, rstd;
  row_stats<NC>(x, D, eps, lane, mean, rstd);
  if (stats != nullptr && lane == 0) stats[m] = make_float2(mean, rstd);
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    const int c = chunk_col(j, lane);
    if (c >= D) continue;
    float sc[VEC], b[VEC], y[VEC];
    load8(scale + c, sc);
    load8(bias + c, b);
#pragma unroll
    for (int k = 0; k < VEC; ++k) y[k] = (x[j][k] - mean) * rstd * sc[k] + b[k];
    if (out_t != nullptr) store8(out_t + row + c, y);
    if (out_f != nullptr) store8(out_f + row + c, y);
  }
}

struct LnBwdArgs {
  const void* u;        // (M, D) the LayerNorm's input (TU)
  const void* dh;       // (M, D) gradient of the LayerNorm's output (TD)
  const void* scale;    // (D,) LN scale, operand type
  const void* add;      // (M, D) operand type, added to the LN input gradient, or null
  const void* ls;       // (D,) operand type: out2 = d * ls and c2 sums d * ls; null -> 1
  const float* proj;    // (M, D) fp32: c3 sums d * proj; or null
  const float2* stats;  // (M,) each row's (mean, rstd) from ln_rows_kernel, or null
  void* out1;           // (M, D) operand type: d
  void* out2;           // (M, D) operand type: d * ls, or null
  float* out32;         // (M, D) fp32: d, or null
  float* cpart;         // (blocks, popcount(sums), D) fp32: each block's column sums
                        //   of its rows, in bit order: c0 = dh * xn, c1 = dh,
                        //   c2 = d * ls, c3 = d * proj
  int sums;             // SUM_* bits: the column sums to write
  int chunk;            // rows of a block: block b owns [b chunk, min(M, (b + 1) chunk))
  int M, D;
  float eps;
};

// d = rstd * (dxn - mean(dxn) - xn * mean(dxn * xn)) [+ add], dxn = dh * scale:
// a warp a row of the block's range, in turn; NS = 2 holds c0 and c1, NS = 4
// all four sums in registers across the range
template <typename T, typename TU, typename TD, int NC, int NS>
__global__ void __launch_bounds__(RT, 1) ln_bwd_rows_kernel(LnBwdArgs p) {
  __shared__ float red[NS][MAX_D];
  const TU* U = static_cast<const TU*>(p.u);
  const TD* DH = static_cast<const TD*>(p.dh);
  const T* scale = static_cast<const T*>(p.scale);
  const T* add = static_cast<const T*>(p.add);
  const T* ls = static_cast<const T*>(p.ls);
  const int D = p.D, lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int r0 = blockIdx.x * p.chunk, r1 = min(p.M, r0 + p.chunk);

  float acc[NS][NC][VEC];
#pragma unroll
  for (int s = 0; s < NS; ++s)
#pragma unroll
    for (int j = 0; j < NC; ++j)
#pragma unroll
      for (int k = 0; k < VEC; ++k) acc[s][j][k] = 0.f;

#pragma unroll 1
  for (int m = r0 + warp; m < r1; m += RT / 32) {
    const size_t row = (size_t)m * D;
    float xn[NC][VEC], dxn[NC][VEC];  // u, then xn; dh, then dh * scale
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int c = chunk_col(j, lane);
      if (c < D) {
        load8(U + row + c, xn[j]);
        load8(DH + row + c, dxn[j]);
      }
    }
    float mean, rstd;
    if (p.stats != nullptr) {
      const float2 st = p.stats[m];
      mean = st.x;
      rstd = st.y;
    } else {
      row_stats<NC>(xn, D, p.eps, lane, mean, rstd);
    }
    float m1 = 0.f, m2 = 0.f;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int c = chunk_col(j, lane);
      if (c >= D) continue;
      float sc[VEC];
      load8(scale + c, sc);
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        const float x = (xn[j][k] - mean) * rstd, dh = dxn[j][k];
        if (p.sums & SUM_DH_XN) acc[0][j][k] += dh * x;
        if (p.sums & SUM_DH) acc[1][j][k] += dh;
        xn[j][k] = x;
        dxn[j][k] = dh * sc[k];
        m1 += dxn[j][k];
        m2 += dxn[j][k] * x;
      }
    }
    m1 = warp_sum(m1) / D;
    m2 = warp_sum(m2) / D;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int c = chunk_col(j, lane);
      if (c >= D) continue;
      float lsv[VEC], ad[VEC], pj[VEC], d[VEC];
      if (ls != nullptr) {
        load8(ls + c, lsv);
      } else {
#pragma unroll
        for (int k = 0; k < VEC; ++k) lsv[k] = 1.0f;
      }
      if (add != nullptr) load8(add + row + c, ad);
      if (p.proj != nullptr) load8(p.proj + row + c, pj);
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        d[k] = rstd * (dxn[j][k] - m1 - xn[j][k] * m2);
        if (add != nullptr) d[k] += ad[k];
        if constexpr (NS == 4) {
          if (p.sums & SUM_D_PROJ) acc[3][j][k] += d[k] * pj[k];
        }
      }
      store8(static_cast<T*>(p.out1) + row + c, d);
      if (p.out32 != nullptr) store8(p.out32 + row + c, d);
#pragma unroll
      for (int k = 0; k < VEC; ++k) {  // d * ls, in place
        d[k] *= lsv[k];
        if constexpr (NS == 4) {
          if (p.sums & SUM_D_LS) acc[2][j][k] += d[k];
        }
      }
      if (p.out2 != nullptr) store8(static_cast<T*>(p.out2) + row + c, d);
    }
  }

  // the warps' sums, added in warp order into shared memory, then one partial row
  for (int i = threadIdx.x; i < NS * MAX_D; i += RT) (&red[0][0])[i] = 0.f;
  __syncthreads();
  for (int w = 0; w < RT / 32; ++w) {
    if (warp == w) {
#pragma unroll
      for (int s = 0; s < NS; ++s)
#pragma unroll
        for (int j = 0; j < NC; ++j)
          if (chunk_col(j, lane) < D)
#pragma unroll
            for (int k = 0; k < VEC; ++k) red[s][chunk_col(j, lane) + k] += acc[s][j][k];
    }
    __syncthreads();
  }
  float* dst = p.cpart + (size_t)blockIdx.x * __popc(p.sums) * D;
  for (int s = 0; s < NS; ++s) {
    if (!(p.sums & (1 << s))) continue;
    for (int c = threadIdx.x; c < D; c += RT) dst[c] = red[s][c];
    dst += D;
  }
}

// out = g * ls rounded (when out is given), and each block's column sums of its
// rows: c0 = sum g * m (SUM_G_M, WANT_M; m fp32), c1 = sum g * ls (SUM_G_LS); ls
// null -> 1. A thread holds 8 neighbouring columns and walks the block's rows R
// at a time (loads first, then the sums in row order): 4 rows of g, or 2 of g and
// m, so that three blocks of 288 threads (K6's 2304 columns) fit an SM;
// cpart (blocks, popcount(sums), D) in bit order
template <typename T, bool WANT_M>
__device__ __forceinline__ void colsum_row(const float (&gv)[VEC], const float (&mv)[VEC],
                                           const float (&lsv)[VEC], float (&a0)[VEC],
                                           float (&a1)[VEC], T* out) {
  float dm[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    dm[k] = gv[k] * lsv[k];
    if constexpr (WANT_M) a0[k] += gv[k] * mv[k];
    a1[k] += dm[k];
  }
  if (out != nullptr) store8(out, dm);
}

template <typename T, bool WANT_M>
__global__ void __launch_bounds__(CT, 2)
scale_colsum_kernel(const T* __restrict__ g, const float* __restrict__ m,
                    const T* __restrict__ ls, T* __restrict__ out, float* __restrict__ cpart,
                    int sums, int M, int D, int chunk) {
  constexpr int R = WANT_M ? 2 : 4;
  const int r0 = blockIdx.x * chunk, r1 = min(M, r0 + chunk);
#pragma unroll 1
  for (int c = threadIdx.x * VEC; c < D; c += blockDim.x * VEC) {
    float lsv[VEC], a0[VEC], a1[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      lsv[k] = 1.0f;
      a0[k] = a1[k] = 0.f;
    }
    if (ls != nullptr) load8(ls + c, lsv);
    int r = r0;
#pragma unroll 1
    for (; r + R <= r1; r += R) {
      float gv[R][VEC], mv[R][VEC];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        load8(g + (size_t)(r + i) * D + c, gv[i]);
        if constexpr (WANT_M) load8(m + (size_t)(r + i) * D + c, mv[i]);
      }
#pragma unroll
      for (int i = 0; i < R; ++i)
        colsum_row<T, WANT_M>(gv[i], mv[i], lsv, a0, a1,
                              out == nullptr ? nullptr : out + (size_t)(r + i) * D + c);
    }
#pragma unroll 1
    for (; r < r1; ++r) {
      float gv[VEC], mv[VEC];
      load8(g + (size_t)r * D + c, gv);
      if constexpr (WANT_M) load8(m + (size_t)r * D + c, mv);
      colsum_row<T, WANT_M>(gv, mv, lsv, a0, a1,
                            out == nullptr ? nullptr : out + (size_t)r * D + c);
    }
    float* dst = cpart + (size_t)blockIdx.x * __popc(sums) * D + c;
    if (WANT_M) {
      store8(dst, a0);
      dst += D;
    }
    if (sums & SUM_G_LS) store8(dst, a1);
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

// the 8-column chunks a lane holds of a D-wide row (0: D does not suit the
// LayerNorm row passes)
inline int row_chunks(int D) {
  return (D < VEC || D % VEC || D > MAX_D) ? 0 : (D + 32 * VEC - 1) / (32 * VEC);
}

template <typename T, typename TU, int NC>
void launch_ln_rows(const void* u, const void* scale, const void* bias, void* out_t,
                    float* out_f, float2* stats, int M, int D, float eps, cudaStream_t s) {
  ln_rows_kernel<T, TU, NC><<<(M + RT / 32 - 1) / (RT / 32), RT, 0, s>>>(
      static_cast<const TU*>(u), static_cast<const T*>(scale), static_cast<const T*>(bias),
      static_cast<T*>(out_t), out_f, stats, M, D, eps);
}

template <typename T, typename TU>
cudaError_t ln_rows(const void* u, const void* scale, const void* bias, void* out_t,
                    float* out_f, float2* stats, int M, int D, float eps, cudaStream_t s) {
  switch (row_chunks(D)) {
    case 1: launch_ln_rows<T, TU, 1>(u, scale, bias, out_t, out_f, stats, M, D, eps, s); break;
    case 2: launch_ln_rows<T, TU, 2>(u, scale, bias, out_t, out_f, stats, M, D, eps, s); break;
    case 3: launch_ln_rows<T, TU, 3>(u, scale, bias, out_t, out_f, stats, M, D, eps, s); break;
    case 4: launch_ln_rows<T, TU, 4>(u, scale, bias, out_t, out_f, stats, M, D, eps, s); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <typename T, typename TU, typename TD, int NC>
void launch_ln_bwd(const LnBwdArgs& p, cudaStream_t s) {
  const int blocks = (p.M + p.chunk - 1) / p.chunk;
  if (p.sums & (SUM_D_LS | SUM_D_PROJ))
    ln_bwd_rows_kernel<T, TU, TD, NC, 4><<<blocks, RT, 0, s>>>(p);
  else
    ln_bwd_rows_kernel<T, TU, TD, NC, 2><<<blocks, RT, 0, s>>>(p);
}

template <typename T, typename TU, typename TD>
cudaError_t ln_bwd_rows(const LnBwdArgs& p, cudaStream_t s) {
  switch (row_chunks(p.D)) {
    case 1: launch_ln_bwd<T, TU, TD, 1>(p, s); break;
    case 2: launch_ln_bwd<T, TU, TD, 2>(p, s); break;
    case 3: launch_ln_bwd<T, TU, TD, 3>(p, s); break;
    case 4: launch_ln_bwd<T, TU, TD, 4>(p, s); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <typename T, bool WANT_M>
cudaError_t scale_colsum(const void* g, const void* m, const void* ls, void* out, void* cpart,
                         int sums, int chunk, int M, int D, cudaStream_t s) {
  scale_colsum_kernel<T, WANT_M><<<(M + chunk - 1) / chunk, min(CT, (D / VEC + 31) / 32 * 32), 0,
                                   s>>>(
      static_cast<const T*>(g), static_cast<const float*>(m), static_cast<const T*>(ls),
      static_cast<T*>(out), static_cast<float*>(cpart), sums, M, D, chunk);
  return cudaGetLastError();
}

template <typename T, typename TU>
cudaError_t ln_bwd_rows_dh(const LnBwdArgs& p, bool dh_f32, cudaStream_t s) {
  return dh_f32 ? ln_bwd_rows<T, TU, float>(p, s) : ln_bwd_rows<T, TU, T>(p, s);
}

}  // namespace bw
}  // namespace rz

using bf16 = __nv_bfloat16;
namespace bw = rz::bw;

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

// out (n,) operand type = sum over s of part (S, n) fp32 in two levels, each in
// order: scratch (ceil(S / per), n) fp32 receives the sums over chunks of `per`
// partial rows, which rz_reduce_parts then adds in chunk order, rounding once
extern "C" int rz_reduce_two_level(const void* part, void* scratch, void* out, int S,
                                   long long n, int per, int dtype, void* stream) {
  if (S < 1 || n < 1 || per < 1 || (S + per - 1) / per > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int chunks = (S + per - 1) / per;
  dim3 grid((unsigned)((n + bw::RT - 1) / bw::RT), chunks);
  bw::reduce_chunks_kernel<<<grid, bw::RT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(part), static_cast<float*>(scratch), S, (size_t)n, per);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return rz_reduce_parts(scratch, out, chunks, n, dtype, stream);
}

// wt (N, K) = w (K, N)^T, fp32 only
extern "C" int rz_transpose(const void* w, void* wt, int K, int N, int dtype, void* stream) {
  if (dtype == RZ_DTYPE_BF16) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((N + 31) / 32, (K + 31) / 32);
  bw::transpose_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(w), static_cast<float*>(wt), K, N);
  return static_cast<int>(cudaGetLastError());
}

// LN(u) per row -> out_t (operand type) and / or out_f (fp32), and stats (M, 2)
// fp32, each row's mean and rstd, or null; u is fp32 when u_f32. D % 8 == 0,
// D <= 1024, 16-byte aligned rows
extern "C" int rz_ln_rows(const void* u, int u_f32, const void* scale, const void* bias,
                          void* out_t, void* out_f, void* stats, int M, int D, float eps,
                          int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* of = static_cast<float*>(out_f);
  float2* st = static_cast<float2*>(stats);
  cudaError_t err;
  if (dtype != RZ_DTYPE_BF16)
    err = bw::ln_rows<float, float>(u, scale, bias, out_t, of, st, M, D, eps, s);
  else if (u_f32)
    err = bw::ln_rows<bf16, float>(u, scale, bias, out_t, of, st, M, D, eps, s);
  else
    err = bw::ln_rows<bf16, bf16>(u, scale, bias, out_t, of, st, M, D, eps, s);
  return static_cast<int>(err);
}

// the LayerNorm backward per row, see LnBwdArgs; u / dh are fp32 when flagged;
// stats from rz_ln_rows or null; the sums `sums` asks for into cpart (none: cpart
// is not written), block b of ceil(M / chunk) owning rows [b chunk, (b + 1) chunk).
// D % 8 == 0, D <= 1024
extern "C" int rz_ln_bwd_rows(const void* u, int u_f32, const void* dh, int dh_f32,
                              const void* scale, const void* add, const void* ls,
                              const void* proj, const void* stats, void* out1, void* out2,
                              void* out32, void* cpart, int sums, int chunk, int M, int D,
                              float eps, int dtype, void* stream) {
  if (M < 1 || chunk < 1 || sums < 0 || sums > 15 || ((sums & bw::SUM_D_PROJ) && !proj))
    return static_cast<int>(cudaErrorInvalidValue);
  bw::LnBwdArgs p{u, dh, scale, add, ls, static_cast<const float*>(proj),
                  static_cast<const float2*>(stats), out1, out2, static_cast<float*>(out32),
                  static_cast<float*>(cpart), sums, chunk, M, D, eps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype != RZ_DTYPE_BF16)
    err = bw::ln_bwd_rows<float, float, float>(p, s);
  else if (u_f32)
    err = bw::ln_bwd_rows_dh<bf16, float>(p, dh_f32 != 0, s);
  else
    err = bw::ln_bwd_rows_dh<bf16, bf16>(p, dh_f32 != 0, s);
  return static_cast<int>(err);
}

// out = g * ls with the column sums `sums` asks for, see scale_colsum_kernel;
// block b of ceil(M / chunk) owns rows [b chunk, (b + 1) chunk). D % 8 == 0
extern "C" int rz_scale_colsum(const void* g, const void* m, const void* ls, void* out,
                               void* cpart, int sums, int chunk, int M, int D, int dtype,
                               void* stream) {
  if (M < 1 || chunk < 1 || D < bw::VEC || D % bw::VEC || sums < 1 || sums > 3 ||
      ((sums & bw::SUM_G_M) && !m))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool want_m = sums & bw::SUM_G_M;
  cudaError_t err;
  if (dtype == RZ_DTYPE_BF16)
    err = want_m ? bw::scale_colsum<bf16, true>(g, m, ls, out, cpart, sums, chunk, M, D, s)
                 : bw::scale_colsum<bf16, false>(g, m, ls, out, cpart, sums, chunk, M, D, s);
  else
    err = want_m ? bw::scale_colsum<float, true>(g, m, ls, out, cpart, sums, chunk, M, D, s)
                 : bw::scale_colsum<float, false>(g, m, ls, out, cpart, sums, chunk, M, D, s);
  return static_cast<int>(err);
}
