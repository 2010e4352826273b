// K10, K11, K12: the differentiable VL-CABS for Hopper (logits only).
//
// Replace the TPU kernels of radzero_tpu/ops/pallas_vlcabs.py:
//   K10 _train_forward            (_kernel_fwd_logits)
//   K11 _train_bwd, first call    (_kernel_bwd_dq:  dq, dtau)
//   K12 _train_bwd, second call   (_kernel_bwd_dtn: d(normalised tokens))
// With qn (N, D) l2-normalised, t (B, L, D), tau, and the cotangent dz (N, B):
//   tn = t * rsqrt(sum(t^2) + 1e-24)          rounded to the operand type
//   s  = (qn . tn) / tau                      fp32
//   e  = exp(s - rowmax(s))                   fp32; rounded before a product
//   g  = e . tn                               fp32
//   z  = (qn . g) / max(|g|, 1e-12)           the logit
//   dg = dz (qn - z ghat) / |g|               rounded before a product
//   de = dg . tn^T;  dc = de * e / tau        dc rounded before a product
//   dq   = sum_b (dc . tn + dz ghat)          fp32, cast once
//   dtau = -sum dc * (s - rowmax(s))          fp32
//   dtn  = dc^T . qn + e^T . dg               fp32, rounded once
// The row-normalise VJP that turns dtn into dt stays outside, in plain
// torch, as the JAX package leaves it to XLA.
//
// What bounds them on the H100, and what the design does about it. They
// are chains of products of 2 N L D B operations each (34.5 GFLOP at
// N 512, B 64, L 1370, D 768) over ~0.14 GB of tokens, so the math units
// bound them. The TPU kernels hold one image's whole normalised token set
// and a (block, L) score block in VMEM and add into one output block
// across sequential grid steps; neither exists here:
// - One image's tn (1370 x 768) is ten times an SM's shared memory. Every
//   kernel walks L in tiles and D in chunks of 256 columns; nothing wider
//   than a (32 x 64) score tile and a (32 x 256) / (64 x 256) operand
//   chunk is ever in shared memory. The tokens are normalised once per
//   call into a (B, L, D) buffer of the operand type (a row kernel).
// - g needs the whole row of e, and dg needs g, so the backward cannot be
//   one pass. The forward kernel (pass 1) takes the row max in a first
//   sweep over L and g in a second, with g (32 x D) held in accumulator
//   registers, spread over the block's 8 warps by (16-row group, 64-column
//   slice). K10 ends there with the logit. For the backward the same
//   kernel ends by writing dg (B, N, D; operand type), the row max (B, N)
//   and dz ghat; the second pass then knows the max, so its accumulators
//   (dq in K11, dtn in K12) stay in registers with no rescaling.
// - Sums across blocks have a fixed order and use no atomics. K11 runs one
//   block per (32 queries, image), writes its dq into a (B, N, D) fp32
//   buffer and its share of dtau into one slot per block; a reduce kernel
//   adds the images up in order. K12 runs one block per (32 tokens, image)
//   that walks every 64-query block itself, so dtn is summed in registers
//   and written once, rounded once (the TPU kernel rounds the running sum
//   to the tokens' dtype once per 128-query block).
// - bf16 products run on the tensor cores (WMMA, fp32 accumulators), fp32
//   products on the CUDA cores in true fp32 (WarpAcc in common.cuh). The
//   k dimension of a score tile is split over four warps whose partial
//   tiles are added in shared memory, because WMMA leaves the accumulator
//   layout unspecified.
// Not yet done (later work): overlap of the chunk loads with the products,
// keeping the query chunk resident, wgmma/TMA, and saving the row max in
// the forward so that the backward's first sweep goes.
#include "common.cuh"

namespace rz {
namespace vt {

constexpr int QB = 32;        // rows of the block's own side (queries; tokens in K12)
constexpr int WB = 64;        // rows of one tile of the other side
constexpr int CW = 256;       // columns of D staged at a time: 4 slices of 64
constexpr int MAXC = 3;       // chunks: D <= 768
constexpr int THREADS = 256;  // 8 warps = 2 row groups x 4 slices
constexpr int SP = WB + 4;    // fp32 pitch of a score tile
constexpr int HEAD = 512;     // bytes of small arrays in front of the tiles

template <typename T> __host__ __device__ constexpr int pitch_b() { return CW + 16 / (int)sizeof(T); }
template <typename T> __host__ __device__ constexpr int pitch_e() { return WB + 16 / (int)sizeof(T); }
__host__ __device__ constexpr size_t g_bytes(int D) { return (size_t)QB * (D + 4) * sizeof(float); }
__host__ __device__ constexpr size_t max2(size_t a, size_t b) { return a > b ? a : b; }

// rows [r0, r0 + R) x columns [c0, c0 + cw) of a row-major (nrows x ld)
// matrix -> dst (R x pitch_b), 16-byte vectors; rows >= nrows are zero.
template <typename T, int R>
__device__ __forceinline__ void stage(T* dst, const T* __restrict__ src, int r0, int nrows,
                                      int ld, int c0, int cw) {
  constexpr int VEC = 16 / sizeof(T), PB = pitch_b<T>();
  const int per_row = cw / VEC;
  for (int i = threadIdx.x; i < R * per_row; i += THREADS) {
    const int r = i / per_row, c = (i % per_row) * VEC, gr = r0 + r;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (gr < nrows) v = *reinterpret_cast<const uint4*>(src + (size_t)gr * ld + c0 + c);
    *reinterpret_cast<uint4*>(dst + r * PB + c) = v;
  }
}

// sum of the four k-slice partial tiles at (r, c)
__device__ __forceinline__ float sum4(const float* sp, int r, int c) {
  const int o = r * SP + c;
  return (sp[o] + sp[QB * SP + o]) + (sp[2 * QB * SP + o] + sp[3 * QB * SP + o]);
}

// tn[row, :] = t[row, :] * rsqrt(sum(t^2) + 1e-24), one warp per row
template <typename T>
__global__ void __launch_bounds__(THREADS)
rownorm_kernel(const T* __restrict__ t, T* __restrict__ tn, int rows, int D) {
  const int lane = threadIdx.x % 32, row = blockIdx.x * (THREADS / 32) + threadIdx.x / 32;
  if (row >= rows) return;
  const T* src = t + (size_t)row * D;
  float ss = 0.f;
  for (int c = lane; c < D; c += 32) {
    const float x = to_f32(src[c]);
    ss += x * x;
  }
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  const float inv = rsqrtf(ss + 1e-24f);
  for (int c = lane; c < D; c += 32) tn[(size_t)row * D + c] = from_f32<T>(to_f32(src[c]) * inv);
}

// ---------------------------------------------------------------------------
// pass 1: row max, g, then the logit (K10) or dg / row max / dz ghat (backward)
// ---------------------------------------------------------------------------

enum { MODE_LOGITS = 0, MODE_BWD = 1 };

template <typename T>
__host__ __device__ constexpr size_t pass1_smem(int D) {
  return HEAD + max2((size_t)(QB + WB) * pitch_b<T>() * sizeof(T) +
                         4 * QB * SP * sizeof(float) + (size_t)QB * pitch_e<T>() * sizeof(T),
                     g_bytes(D));
}

// grid (ceil(N / 32), B)
template <typename T, int MODE>
__global__ void __launch_bounds__(THREADS)
vlc_pass1_kernel(const T* __restrict__ qn, const T* __restrict__ tn,
                 const float* __restrict__ tau, const float* __restrict__ dz,
                 float* __restrict__ logits, T* __restrict__ dg_out,
                 float* __restrict__ rowmax_out, float* __restrict__ dq_part, int N, int B,
                 int L, int D) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int PB = pitch_b<T>(), PE = pitch_e<T>();
  float* row_m = reinterpret_cast<float*>(smem);
  T* As = reinterpret_cast<T*>(smem + HEAD);          // QB x PB: query chunk
  T* Bs = As + QB * PB;                               // WB x PB: token chunk
  float* Sp = reinterpret_cast<float*>(Bs + WB * PB);  // 4 x QB x SP partial score tiles
  T* Es = reinterpret_cast<T*>(Sp + 4 * QB * SP);     // QB x PE: e, operand type
  float* Gs = reinterpret_cast<float*>(smem + HEAD);  // epilogue: QB x (D + 4), aliases the above

  const int n0 = blockIdx.x * QB, b = blockIdx.y, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, rg = warp & 1, kq = warp >> 1;
  const int r = tid / 8, cseg = (tid % 8) * 8;  // elementwise: row, first of 8 columns
  const T* tb = tn + (size_t)b * L * D;
  const float inv_tau = 1.0f / tau[0];
  const int nchunks = (D + CW - 1) / CW;
  if (tid < QB) row_m[tid] = -INFINITY;

  WarpAcc<T, false> gacc[MAXC];
#pragma unroll
  for (int ci = 0; ci < MAXC; ++ci) gacc[ci].zero();

  for (int sweep = 0; sweep < 2; ++sweep) {  // 0: row max; 1: e and g with the max known
    for (int l0 = 0; l0 < L; l0 += WB) {
      WarpAcc<T, true> sacc;
      sacc.zero();
      for (int ci = 0; ci < nchunks; ++ci) {
        const int c0 = ci * CW, cw = min(CW, D - c0);
        __syncthreads();
        stage<T, QB>(As, qn, n0, N, D, c0, cw);
        stage<T, WB>(Bs, tb, l0, L, D, c0, cw);
        __syncthreads();
        if (kq * 64 < cw) sacc.mma(As + rg * 16 * PB + kq * 64, PB, Bs + kq * 64, PB, 64);
      }
      sacc.store(Sp + kq * QB * SP + rg * 16 * SP, SP);
      __syncthreads();
      if (sweep == 0) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (l0 + cseg + j < L) mx = fmaxf(mx, sum4(Sp, r, cseg + j) * inv_tau);
        for (int o = 4; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        if (tid % 8 == 0) row_m[r] = fmaxf(row_m[r], mx);
        continue;
      }
      const float m = row_m[r];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = cseg + j;
        const float e =
            l0 + col < L ? exp2f((sum4(Sp, r, col) * inv_tau - m) * kLog2e) : 0.f;
        Es[r * PE + col] = from_f32<T>(e);
      }
#pragma unroll
      for (int ci = 0; ci < MAXC; ++ci) {
        if (ci < nchunks) {
          const int c0 = ci * CW, cw = min(CW, D - c0);
          __syncthreads();  // Es complete; the last users of Bs are done
          stage<T, WB>(Bs, tb, l0, L, D, c0, cw);
          __syncthreads();
          if (kq * 64 < cw) gacc[ci].mma(Es + rg * 16 * PE, PE, Bs + kq * 64, PB, WB);
        }
      }
    }
  }

  // g -> shared memory (over the tiles, which are dead now), then row-wise
  const int GP = D + 4;
  __syncthreads();
#pragma unroll
  for (int ci = 0; ci < MAXC; ++ci)
    if (ci * CW + kq * 64 < D) gacc[ci].store(Gs + rg * 16 * GP + ci * CW + kq * 64, GP);
  __syncthreads();
  for (int rr = warp * 4; rr < warp * 4 + 4; ++rr) {
    const int n = n0 + rr;
    if (n >= N) continue;
    const T* qrow = qn + (size_t)n * D;
    float num = 0.f, sq = 0.f;
    for (int c = lane; c < D; c += 32) {
      const float gv = Gs[rr * GP + c];
      num = fmaf(to_f32(qrow[c]), gv, num);
      sq = fmaf(gv, gv, sq);
    }
    for (int o = 16; o > 0; o >>= 1) {
      num += __shfl_xor_sync(0xffffffffu, num, o);
      sq += __shfl_xor_sync(0xffffffffu, sq, o);
    }
    const float norm = fmaxf(sqrtf(sq), 1e-12f), z = num / norm;
    if (MODE == MODE_LOGITS) {
      if (lane == 0) logits[(size_t)n * B + b] = z;
    } else {
      const float dzv = dz[(size_t)n * B + b];
      const size_t o = ((size_t)b * N + n) * D;
      for (int c = lane; c < D; c += 32) {
        const float ghat = Gs[rr * GP + c] / norm;
        dg_out[o + c] = from_f32<T>(dzv * (to_f32(qrow[c]) - z * ghat) / norm);
        if (dq_part != nullptr) dq_part[o + c] = dzv * ghat;
      }
      if (lane == 0) rowmax_out[(size_t)b * N + n] = row_m[rr];
    }
  }
}

// ---------------------------------------------------------------------------
// K11, pass 2: dq per (query block, image) and this block's share of dtau
// ---------------------------------------------------------------------------

template <typename T>
__host__ __device__ constexpr size_t dq_smem(int D) {
  return HEAD + max2((size_t)(2 * QB + WB) * pitch_b<T>() * sizeof(T) +
                         8 * QB * SP * sizeof(float) + (size_t)QB * pitch_e<T>() * sizeof(T),
                     g_bytes(D));
}

// grid (ceil(N / 32), B); dq_part (B, N, D) holds dz ghat on entry
template <typename T>
__global__ void __launch_bounds__(THREADS)
vlc_dq_kernel(const T* __restrict__ qn, const T* __restrict__ tn, const float* __restrict__ tau,
              const T* __restrict__ dg, const float* __restrict__ rowmax,
              float* __restrict__ dq_part, float* __restrict__ dtau_part, int N, int B, int L,
              int D) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int PB = pitch_b<T>(), PE = pitch_e<T>();
  float* row_m = reinterpret_cast<float*>(smem);       // QB
  float* red = row_m + QB;                             // 8 warps
  T* As0 = reinterpret_cast<T*>(smem + HEAD);          // QB x PB: query chunk
  T* As1 = As0 + QB * PB;                              // QB x PB: dg chunk
  T* Bs = As1 + QB * PB;                               // WB x PB: token chunk
  float* Sp = reinterpret_cast<float*>(Bs + WB * PB);  // 2 x 4 x QB x SP: s and de partials
  T* Cs = reinterpret_cast<T*>(Sp + 8 * QB * SP);      // QB x PE: dc, operand type
  float* Gs = reinterpret_cast<float*>(smem + HEAD);   // epilogue alias

  const int n0 = blockIdx.x * QB, b = blockIdx.y, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, rg = warp & 1, kq = warp >> 1;
  const int r = tid / 8, cseg = (tid % 8) * 8;
  const T* tb = tn + (size_t)b * L * D;
  const T* dgb = dg + (size_t)b * N * D;
  const float inv_tau = 1.0f / tau[0];
  const int nchunks = (D + CW - 1) / CW;
  if (tid < QB) row_m[tid] = n0 + tid < N ? rowmax[(size_t)b * N + n0 + tid] : 0.f;

  WarpAcc<T, false> qacc[MAXC];
#pragma unroll
  for (int ci = 0; ci < MAXC; ++ci) qacc[ci].zero();
  float dtau = 0.f;

  for (int l0 = 0; l0 < L; l0 += WB) {
    WarpAcc<T, true> sacc, eacc;  // s = qn . tn^T and de = dg . tn^T
    sacc.zero();
    eacc.zero();
    for (int ci = 0; ci < nchunks; ++ci) {
      const int c0 = ci * CW, cw = min(CW, D - c0);
      __syncthreads();
      stage<T, QB>(As0, qn, n0, N, D, c0, cw);
      stage<T, QB>(As1, dgb, n0, N, D, c0, cw);
      stage<T, WB>(Bs, tb, l0, L, D, c0, cw);
      __syncthreads();
      if (kq * 64 < cw) {
        sacc.mma(As0 + rg * 16 * PB + kq * 64, PB, Bs + kq * 64, PB, 64);
        eacc.mma(As1 + rg * 16 * PB + kq * 64, PB, Bs + kq * 64, PB, 64);
      }
    }
    sacc.store(Sp + kq * QB * SP + rg * 16 * SP, SP);
    eacc.store(Sp + (4 + kq) * QB * SP + rg * 16 * SP, SP);
    __syncthreads();
    const float m = row_m[r];
    const bool row_ok = n0 + r < N;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = cseg + j;
      float dc = 0.f;
      if (row_ok && l0 + col < L) {
        const float sh = sum4(Sp, r, col) * inv_tau - m;
        dc = sum4(Sp + 4 * QB * SP, r, col) * exp2f(sh * kLog2e) * inv_tau;
        dtau = fmaf(dc, sh, dtau);
      }
      Cs[r * PE + col] = from_f32<T>(dc);
    }
#pragma unroll
    for (int ci = 0; ci < MAXC; ++ci) {
      if (ci < nchunks) {
        const int c0 = ci * CW, cw = min(CW, D - c0);
        __syncthreads();  // Cs complete; the last users of Bs are done
        stage<T, WB>(Bs, tb, l0, L, D, c0, cw);
        __syncthreads();
        if (kq * 64 < cw) qacc[ci].mma(Cs + rg * 16 * PE, PE, Bs + kq * 64, PB, WB);
      }
    }
  }

  const int GP = D + 4;
  __syncthreads();
#pragma unroll
  for (int ci = 0; ci < MAXC; ++ci)
    if (ci * CW + kq * 64 < D) qacc[ci].store(Gs + rg * 16 * GP + ci * CW + kq * 64, GP);
  __syncthreads();
  for (int i = tid; i < QB * D; i += THREADS) {
    const int rr = i / D, c = i % D, n = n0 + rr;
    if (n < N) dq_part[((size_t)b * N + n) * D + c] += Gs[rr * GP + c];
  }
  for (int o = 16; o > 0; o >>= 1) dtau += __shfl_xor_sync(0xffffffffu, dtau, o);
  if (lane == 0) red[warp] = dtau;
  __syncthreads();
  if (tid == 0) {
    float s = 0.f;
    for (int w = 0; w < THREADS / 32; ++w) s += red[w];
    dtau_part[blockIdx.y * gridDim.x + blockIdx.x] = s;
  }
}

// dq[n, d] = sum over images of dq_part[b, n, d], in order; block 0's first
// warp also folds the dtau slots: dtau = -sum, in a fixed order.
template <typename T>
__global__ void __launch_bounds__(THREADS)
vlc_reduce_kernel(const float* __restrict__ dq_part, const float* __restrict__ dtau_part,
                  T* __restrict__ dq, float* __restrict__ dtau, int ND, int B, int nparts) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i < ND) {
    float s = 0.f;
    for (int b = 0; b < B; ++b) s += dq_part[(size_t)b * ND + i];
    dq[i] = from_f32<T>(s);
  }
  if (blockIdx.x == 0 && threadIdx.x < 32) {
    float s = 0.f;
    for (int k = threadIdx.x; k < nparts; k += 32) s += dtau_part[k];
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (threadIdx.x == 0) dtau[0] = -s;
  }
}

// ---------------------------------------------------------------------------
// K12, pass 2: dtn per (token tile, image), every query block walked in order
// ---------------------------------------------------------------------------

template <typename T>
__host__ __device__ constexpr size_t dtn_smem(int D) {
  return HEAD + max2((size_t)QB * pitch_b<T>() * sizeof(T) +
                         max2((size_t)2 * WB * pitch_b<T>() * sizeof(T),
                              8 * QB * SP * sizeof(float)) +
                         (size_t)2 * QB * pitch_e<T>() * sizeof(T),
                     g_bytes(D));
}

// grid (ceil(L / 32), B). The block's own side is 32 tokens; the tiles of
// the other side are 64 queries, so the score tiles here are transposed:
// s^T = tn . qn^T and de^T = tn . dg^T, (tokens x queries).
template <typename T>
__global__ void __launch_bounds__(THREADS)
vlc_dtn_kernel(const T* __restrict__ qn, const T* __restrict__ tn, const float* __restrict__ tau,
               const T* __restrict__ dg, const float* __restrict__ rowmax,
               T* __restrict__ dtn, int N, int B, int L, int D) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int PB = pitch_b<T>(), PE = pitch_e<T>();
  constexpr size_t UNION = max2((size_t)2 * WB * PB * sizeof(T), 8 * QB * SP * sizeof(float));
  float* q_m = reinterpret_cast<float*>(smem);           // WB: row max of this query block
  T* As = reinterpret_cast<T*>(smem + HEAD);             // QB x PB: token chunk
  unsigned char* un = smem + HEAD + (size_t)QB * PB * sizeof(T);
  T* Bs0 = reinterpret_cast<T*>(un);                     // WB x PB: query chunk
  T* Bs1 = Bs0 + WB * PB;                                // WB x PB: dg chunk
  float* Sp = reinterpret_cast<float*>(un);              // 2 x 4 x QB x SP, aliases Bs0 / Bs1
  T* Es = reinterpret_cast<T*>(un + UNION);              // QB x PE: e^T, operand type
  T* Cs = Es + QB * PE;                                  // QB x PE: dc^T, operand type
  float* Gs = reinterpret_cast<float*>(smem + HEAD);     // epilogue alias

  const int l0 = blockIdx.x * QB, b = blockIdx.y, tid = threadIdx.x;
  const int warp = tid / 32, rg = warp & 1, kq = warp >> 1;
  const int r = tid / 8, cseg = (tid % 8) * 8;
  const T* tb = tn + (size_t)b * L * D;
  const T* dgb = dg + (size_t)b * N * D;
  const float inv_tau = 1.0f / tau[0];
  const int nchunks = (D + CW - 1) / CW;

  WarpAcc<T, false> tacc[MAXC];
#pragma unroll
  for (int ci = 0; ci < MAXC; ++ci) tacc[ci].zero();

  for (int nb0 = 0; nb0 < N; nb0 += WB) {
    WarpAcc<T, true> sacc, eacc;
    sacc.zero();
    eacc.zero();
    for (int ci = 0; ci < nchunks; ++ci) {
      const int c0 = ci * CW, cw = min(CW, D - c0);
      __syncthreads();
      stage<T, QB>(As, tb, l0, L, D, c0, cw);
      stage<T, WB>(Bs0, qn, nb0, N, D, c0, cw);
      stage<T, WB>(Bs1, dgb, nb0, N, D, c0, cw);
      __syncthreads();
      if (kq * 64 < cw) {
        sacc.mma(As + rg * 16 * PB + kq * 64, PB, Bs0 + kq * 64, PB, 64);
        eacc.mma(As + rg * 16 * PB + kq * 64, PB, Bs1 + kq * 64, PB, 64);
      }
    }
    if (tid < WB) q_m[tid] = nb0 + tid < N ? rowmax[(size_t)b * N + nb0 + tid] : 0.f;
    __syncthreads();  // the query / dg chunks are dead: their space takes the partial tiles
    sacc.store(Sp + kq * QB * SP + rg * 16 * SP, SP);
    eacc.store(Sp + (4 + kq) * QB * SP + rg * 16 * SP, SP);
    __syncthreads();
    const bool row_ok = l0 + r < L;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = cseg + j;
      float e = 0.f, dc = 0.f;
      if (row_ok && nb0 + col < N) {
        e = exp2f((sum4(Sp, r, col) * inv_tau - q_m[col]) * kLog2e);
        dc = sum4(Sp + 4 * QB * SP, r, col) * e * inv_tau;
      }
      Es[r * PE + col] = from_f32<T>(e);
      Cs[r * PE + col] = from_f32<T>(dc);
    }
#pragma unroll
    for (int ci = 0; ci < MAXC; ++ci) {
      if (ci < nchunks) {
        const int c0 = ci * CW, cw = min(CW, D - c0);
        __syncthreads();  // Es, Cs complete; the partial tiles are read
        stage<T, WB>(Bs0, qn, nb0, N, D, c0, cw);
        stage<T, WB>(Bs1, dgb, nb0, N, D, c0, cw);
        __syncthreads();
        if (kq * 64 < cw) {
          tacc[ci].mma(Cs + rg * 16 * PE, PE, Bs0 + kq * 64, PB, WB);  // dc^T . qn
          tacc[ci].mma(Es + rg * 16 * PE, PE, Bs1 + kq * 64, PB, WB);  // e^T . dg
        }
      }
    }
  }

  const int GP = D + 4;
  __syncthreads();
#pragma unroll
  for (int ci = 0; ci < MAXC; ++ci)
    if (ci * CW + kq * 64 < D) tacc[ci].store(Gs + rg * 16 * GP + ci * CW + kq * 64, GP);
  __syncthreads();
  for (int i = tid; i < QB * D; i += THREADS) {
    const int rr = i / D, c = i % D, l = l0 + rr;
    if (l < L) dtn[((size_t)b * L + l) * D + c] = from_f32<T>(Gs[rr * GP + c]);
  }
}

// ---------------------------------------------------------------------------
// launch chains
// ---------------------------------------------------------------------------

template <typename T>
cudaError_t launch_rownorm(const void* t, void* tn, int rows, int D, cudaStream_t stream) {
  constexpr int PER = THREADS / 32;
  rownorm_kernel<T><<<(rows + PER - 1) / PER, THREADS, 0, stream>>>(
      static_cast<const T*>(t), static_cast<T*>(tn), rows, D);
  return cudaGetLastError();
}

template <typename T, int MODE>
cudaError_t launch_pass1(const void* qn, const void* tn, const void* tau, const void* dz,
                         void* logits, void* dg, void* rowmax, void* dq_part, int N, int B,
                         int L, int D, cudaStream_t stream) {
  const size_t smem = pass1_smem<T>(D);
  cudaError_t err = allow_smem(vlc_pass1_kernel<T, MODE>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((N + QB - 1) / QB, B);
  vlc_pass1_kernel<T, MODE><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(qn), static_cast<const T*>(tn), static_cast<const float*>(tau),
      static_cast<const float*>(dz), static_cast<float*>(logits), static_cast<T*>(dg),
      static_cast<float*>(rowmax), static_cast<float*>(dq_part), N, B, L, D);
  return cudaGetLastError();
}

template <typename T>
cudaError_t train_fwd(const void* qn, const void* t, const void* tau, void* tn, void* logits,
                      int N, int B, int L, int D, cudaStream_t s) {
  cudaError_t err = launch_rownorm<T>(t, tn, B * L, D, s);
  if (err != cudaSuccess) return err;
  return launch_pass1<T, MODE_LOGITS>(qn, tn, tau, nullptr, logits, nullptr, nullptr, nullptr,
                                      N, B, L, D, s);
}

template <typename T>
cudaError_t train_bwd_dq(const void* qn, const void* t, const void* tau, const void* dz,
                         void* tn, void* dg, void* rowmax, void* dq_part, void* dtau_part,
                         void* dq, void* dtau, int N, int B, int L, int D, cudaStream_t s) {
  cudaError_t err = launch_rownorm<T>(t, tn, B * L, D, s);
  if (err != cudaSuccess) return err;
  err = launch_pass1<T, MODE_BWD>(qn, tn, tau, dz, nullptr, dg, rowmax, dq_part, N, B, L, D, s);
  if (err != cudaSuccess) return err;
  const size_t smem = dq_smem<T>(D);
  err = allow_smem(vlc_dq_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((N + QB - 1) / QB, B);
  vlc_dq_kernel<T><<<grid, THREADS, smem, s>>>(
      static_cast<const T*>(qn), static_cast<const T*>(tn), static_cast<const float*>(tau),
      static_cast<const T*>(dg), static_cast<const float*>(rowmax),
      static_cast<float*>(dq_part), static_cast<float*>(dtau_part), N, B, L, D);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  vlc_reduce_kernel<T><<<(N * D + THREADS - 1) / THREADS, THREADS, 0, s>>>(
      static_cast<const float*>(dq_part), static_cast<const float*>(dtau_part),
      static_cast<T*>(dq), static_cast<float*>(dtau), N * D, B, (int)(grid.x * grid.y));
  return cudaGetLastError();
}

template <typename T>
cudaError_t train_bwd_dtn(const void* qn, const void* t, const void* tau, const void* dz,
                          void* tn, void* dg, void* rowmax, void* dtn, int N, int B, int L,
                          int D, cudaStream_t s) {
  cudaError_t err = launch_rownorm<T>(t, tn, B * L, D, s);
  if (err != cudaSuccess) return err;
  err = launch_pass1<T, MODE_BWD>(qn, tn, tau, dz, nullptr, dg, rowmax, nullptr, N, B, L, D, s);
  if (err != cudaSuccess) return err;
  const size_t smem = dtn_smem<T>(D);
  err = allow_smem(vlc_dtn_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((L + QB - 1) / QB, B);
  vlc_dtn_kernel<T><<<grid, THREADS, smem, s>>>(
      static_cast<const T*>(qn), static_cast<const T*>(tn), static_cast<const float*>(tau),
      static_cast<const T*>(dg), static_cast<const float*>(rowmax), static_cast<T*>(dtn), N, B,
      L, D);
  return cudaGetLastError();
}

}  // namespace vt
}  // namespace rz

static bool vt_shape_ok(int D) { return D % 64 == 0 && D <= rz::vt::CW * rz::vt::MAXC; }

// K10: qn (N, D), t (B, L, D), tau (1,) fp32 -> logits (N, B) fp32.
//      tn (B, L, D), operand type, is scratch the caller allocates.
extern "C" int rz_vlcabs_train_fwd(const void* qn, const void* t, const void* tau, void* tn,
                                   void* logits, int N, int B, int L, int D, int dtype,
                                   void* stream) {
  if (!vt_shape_ok(D)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      dtype == RZ_DTYPE_BF16
          ? rz::vt::train_fwd<__nv_bfloat16>(qn, t, tau, tn, logits, N, B, L, D, s)
          : rz::vt::train_fwd<float>(qn, t, tau, tn, logits, N, B, L, D, s);
  return static_cast<int>(err);
}

// K11: + dz (N, B) fp32 -> dq (N, D) operand type, dtau (1,) fp32. Scratch:
//      tn (B, L, D) and dg (B, N, D), operand type; rowmax (B, N), dq_part
//      (B, N, D) and dtau_part (B * ceil(N / 32)), fp32.
extern "C" int rz_vlcabs_train_bwd_dq(const void* qn, const void* t, const void* tau,
                                      const void* dz, void* tn, void* dg, void* rowmax,
                                      void* dq_part, void* dtau_part, void* dq, void* dtau,
                                      int N, int B, int L, int D, int dtype, void* stream) {
  if (!vt_shape_ok(D)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      dtype == RZ_DTYPE_BF16
          ? rz::vt::train_bwd_dq<__nv_bfloat16>(qn, t, tau, dz, tn, dg, rowmax, dq_part,
                                                dtau_part, dq, dtau, N, B, L, D, s)
          : rz::vt::train_bwd_dq<float>(qn, t, tau, dz, tn, dg, rowmax, dq_part, dtau_part, dq,
                                        dtau, N, B, L, D, s);
  return static_cast<int>(err);
}

// K12: + dz (N, B) fp32 -> dtn (B, L, D) operand type. Scratch: tn, dg, rowmax.
extern "C" int rz_vlcabs_train_bwd_dtn(const void* qn, const void* t, const void* tau,
                                       const void* dz, void* tn, void* dg, void* rowmax,
                                       void* dtn, int N, int B, int L, int D, int dtype,
                                       void* stream) {
  if (!vt_shape_ok(D)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      dtype == RZ_DTYPE_BF16
          ? rz::vt::train_bwd_dtn<__nv_bfloat16>(qn, t, tau, dz, tn, dg, rowmax, dtn, N, B, L,
                                                 D, s)
          : rz::vt::train_bwd_dtn<float>(qn, t, tau, dz, tn, dg, rowmax, dtn, N, B, L, D, s);
  return static_cast<int>(err);
}
