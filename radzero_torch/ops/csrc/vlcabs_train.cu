// K10, K11, K12: the differentiable VL-CABS for Hopper (logits only).
//
// Replace the TPU kernels of radzero_tpu/ops/pallas_vlcabs.py:
//   K10 _train_forward            (_kernel_fwd_logits; in bf16 the forward of
//                                  vlcabs_sm90.cu, whose last launch is
//                                  vlc_logits_kernel here)
//   K11 _train_bwd, first call    (_kernel_bwd_dq:  dq, dtau; in bf16 its
//                                  product runs gemm_sm90.cu's GEMM_BFWD over
//                                  the dc that K12's phase 1 writes)
//   K12 _train_bwd, second call   (_kernel_bwd_dtn: d(normalised tokens); in
//                                  bf16 its products run vlcabs_sm90.cu's
//                                  phase 1 and gemm_sm90.cu's GEMM_DTN)
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
// - One image's tn (1370 x 768) is ten times an SM's shared memory. The
//   fp32 kernels here walk L in tiles and D in chunks of 256 columns;
//   nothing wider than a (32 x 64) score tile and a (32 x 256) / (64 x 256)
//   operand chunk is ever in shared memory. The tokens are normalised once
//   per call into a (B, L, D) buffer of the operand type (a row kernel).
// - g needs the whole row of e, and dg needs g, so the backward cannot be
//   one pass. The fp32 forward kernel (pass 1) takes the row max in a first
//   sweep over L and g in a second, with g (32 x D) held in accumulator
//   registers, spread over the block's 8 warps by (16-row group, 64-column
//   slice), and ends with the logit. Under autograd (MODE_STATS) it also
//   writes the row max (B, N) and g (B, N, D) in fp32, which it holds anyway
//   (as the attention forward keeps lse): the backward's statistics, so that
//   neither K11 nor K12 runs pass 1 again (the bf16 forward of vlcabs_sm90.cu
//   writes the same two from its row pass and its second phase). The backward
//   starts with a row pass (vlc_bwd_rows_kernel, a warp per (image, query))
//   that turns g and dz into dg (B, N, D; operand type) and, for K11, dz ghat
//   (fp32), the arithmetic and order of pass 1's end.
// - bf16: S, dE, e and dc are one pass over (query, token) pairs that K11
//   and K12 share, K12's phase 1 (vlcabs_sm90.cu): it writes dc and e once,
//   rounded, into ce (B, 2 Np, Lp) and, for K11, each work item's share of
//   dtau from its epilogue, where dc is still fp32. K11 is then one product
//   per image over the dc rows, dz ghat + dc[b] . tn[b] added in place into
//   the row pass's (B, N, D) fp32 buffer (gemm_sm90_kernel<EPI_ADDF_F32,
//   GEMM_BFWD>), and the reduce below. Those two launches move dc, tn and
//   dz ghat (0.33 GB at the training step's shape) for 2 N L D B operations,
//   so the memory bounds them: 0.097 ms at 3.35 TB/s against 0.070 ms of
//   products at 989 TFLOP/s. Under autograd the backward runs the
//   tokens' row pass, the backward's row pass and phase 1 once for both
//   (rz_vlcabs_dq_sm90 after rz_vlcabs_dtn_phase1, then K12's phase 2).
// - fp32: K11 runs one block per (32 queries, image) that recomputes s and
//   de tile by tile (vlc_dq_kernel), with dq in registers and no rescaling,
//   writes its dq into the (B, N, D) fp32 buffer and its share of dtau into
//   one slot per block; K12 (vlc_dtn_kernel) runs one block per (32 tokens,
//   image) that walks every 64-query block itself, so dtn is summed in
//   registers and written once, rounded once (the TPU kernel rounds the
//   running sum to the tokens' dtype once per 128-query block).
// - Sums across blocks have a fixed order and use no atomics: the reduce
//   (vlc_reduce_kernel) adds the images up in order and folds the dtau
//   slots in a fixed order.
// - The fp32 kernels' products run on the CUDA cores in true fp32
//   (WarpAcc<float> in common.cuh, whose tiles follow WMMA's interface). The
//   k dimension of a score tile is split over four warps whose partial tiles
//   are added in shared memory.
// This file's pass 1 is K10 in fp32 only; bf16 K10 runs vlcabs_sm90.cu's
// forward (rownorm_kernel, two Hopper phases and a row pass between them,
// then vlc_logits_kernel below).
#include "common.cuh"
#include "gemm_sm90.cuh"

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
// pass 1: row max, g, then the logit (K10) and under autograd the statistics
// ---------------------------------------------------------------------------

enum { MODE_LOGITS = 0, MODE_STATS = 1 };  // MODE_STATS: + row max and g

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
                 const float* __restrict__ tau, float* __restrict__ logits,
                 float* __restrict__ rowmax_out, float* __restrict__ g_out, int N, int B, int L,
                 int D) {
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
    const float norm = fmaxf(sqrtf(sq), 1e-12f);
    if (lane == 0) logits[(size_t)n * B + b] = num / norm;
    if (MODE == MODE_STATS) {
      const size_t o = ((size_t)b * N + n) * D;
      for (int c = lane; c < D; c += 32) g_out[o + c] = Gs[rr * GP + c];
      if (lane == 0) rowmax_out[(size_t)b * N + n] = row_m[rr];
    }
  }
}

// ---------------------------------------------------------------------------
// rows of g: the bf16 forward's logits, the backward's dg and dz ghat
// ---------------------------------------------------------------------------

// (|g| clamped at 1e-12, z = qn . g / that) of one (image, query) row, a warp:
// the sums and their order of pass 1's end, shared by the two kernels below,
// so the bf16 forward's logit and the backward's z have the same bits
template <typename T>
__device__ __forceinline__ float2 row_norm_z(const T* __restrict__ qrow,
                                             const float* __restrict__ grow, int D, int lane) {
  float num = 0.f, sq = 0.f;
  for (int c = lane; c < D; c += 32) {
    const float gv = grow[c];
    num = fmaf(to_f32(qrow[c]), gv, num);
    sq = fmaf(gv, gv, sq);
  }
  for (int o = 16; o > 0; o >>= 1) {
    num += __shfl_xor_sync(0xffffffffu, num, o);
    sq += __shfl_xor_sync(0xffffffffu, sq, o);
  }
  const float norm = fmaxf(sqrtf(sq), 1e-12f);
  return make_float2(norm, num / norm);
}

// one warp per (image, query) row of g (B, N, D) fp32: logits (N, B) = z
template <typename T>
__global__ void __launch_bounds__(THREADS)
vlc_logits_kernel(const T* __restrict__ qn, const float* __restrict__ g,
                  float* __restrict__ logits, int N, int B, int D) {
  const int lane = threadIdx.x % 32, row = blockIdx.x * (THREADS / 32) + threadIdx.x / 32;
  if (row >= B * N) return;
  const int b = row / N, n = row % N;
  const float z = row_norm_z(qn + (size_t)n * D, g + (size_t)row * D, D, lane).y;
  if (lane == 0) logits[(size_t)n * B + b] = z;
}

// one warp per (image, query) row of g (B, N, D) fp32: z = qn . g / |g|, then
// dg = dz (qn - z ghat) / |g| rounded to T, and dq_part = dz ghat in fp32 when
// asked (K11); the sums and their order are pass 1's end, so dg has the bits it
// had when pass 1 wrote it
template <typename T>
__global__ void __launch_bounds__(THREADS)
vlc_bwd_rows_kernel(const T* __restrict__ qn, const float* __restrict__ g,
                    const float* __restrict__ dz, T* __restrict__ dg,
                    float* __restrict__ dq_part, int N, int B, int D) {
  const int lane = threadIdx.x % 32, row = blockIdx.x * (THREADS / 32) + threadIdx.x / 32;
  if (row >= B * N) return;
  const int b = row / N, n = row % N;
  const T* qrow = qn + (size_t)n * D;
  const float* grow = g + (size_t)row * D;
  const float2 nz = row_norm_z(qrow, grow, D, lane);
  const float norm = nz.x, z = nz.y;
  const float dzv = dz[(size_t)n * B + b];
  for (int c = lane; c < D; c += 32) {
    const float ghat = grow[c] / norm;
    dg[(size_t)row * D + c] = from_f32<T>(dzv * (to_f32(qrow[c]) - z * ghat) / norm);
    if (dq_part != nullptr) dq_part[(size_t)row * D + c] = dzv * ghat;
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

// grid (ceil(N / 32), B); dq_part (B, N, D) holds dz ghat on entry (the row pass)
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
// K12 in fp32, pass 2: dtn per (token tile, image), every query block walked in order
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
cudaError_t launch_pass1(const void* qn, const void* tn, const void* tau, void* logits,
                         void* rowmax, void* g, int N, int B, int L, int D, cudaStream_t stream) {
  const size_t smem = pass1_smem<T>(D);
  cudaError_t err = allow_smem(vlc_pass1_kernel<T, MODE>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((N + QB - 1) / QB, B);
  vlc_pass1_kernel<T, MODE><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(qn), static_cast<const T*>(tn), static_cast<const float*>(tau),
      static_cast<float*>(logits), static_cast<float*>(rowmax), static_cast<float*>(g), N, B,
      L, D);
  return cudaGetLastError();
}

template <typename T>
cudaError_t train_fwd(const void* qn, const void* t, const void* tau, void* tn, void* logits,
                      void* rowmax, void* g, int N, int B, int L, int D, cudaStream_t s) {
  cudaError_t err = launch_rownorm<T>(t, tn, B * L, D, s);
  if (err != cudaSuccess) return err;
  return g == nullptr
             ? launch_pass1<T, MODE_LOGITS>(qn, tn, tau, logits, nullptr, nullptr, N, B, L, D, s)
             : launch_pass1<T, MODE_STATS>(qn, tn, tau, logits, rowmax, g, N, B, L, D, s);
}

template <typename T>
cudaError_t logits_rows(const void* qn, const void* g, void* logits, int N, int B, int D,
                        cudaStream_t s) {
  constexpr int PER = THREADS / 32;
  vlc_logits_kernel<T><<<(B * N + PER - 1) / PER, THREADS, 0, s>>>(
      static_cast<const T*>(qn), static_cast<const float*>(g), static_cast<float*>(logits), N, B,
      D);
  return cudaGetLastError();
}

template <typename T>
cudaError_t bwd_rows(const void* qn, const void* g, const void* dz, void* dg, void* dq_part,
                     int N, int B, int D, cudaStream_t s) {
  constexpr int PER = THREADS / 32;
  vlc_bwd_rows_kernel<T><<<(B * N + PER - 1) / PER, THREADS, 0, s>>>(
      static_cast<const T*>(qn), static_cast<const float*>(g), static_cast<const float*>(dz),
      static_cast<T*>(dg), static_cast<float*>(dq_part), N, B, D);
  return cudaGetLastError();
}

template <typename T>
cudaError_t reduce(const void* dq_part, const void* dtau_part, void* dq, void* dtau, int ND, int B,
                   int nparts, cudaStream_t s) {
  vlc_reduce_kernel<T><<<(ND + THREADS - 1) / THREADS, THREADS, 0, s>>>(
      static_cast<const float*>(dq_part), static_cast<const float*>(dtau_part),
      static_cast<T*>(dq), static_cast<float*>(dtau), ND, B, nparts);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dq_pass(const void* qn, const void* tn, const void* tau, const void* dg,
                    const void* rowmax, void* dq_part, void* dtau_part, void* dq, void* dtau,
                    int N, int B, int L, int D, cudaStream_t s) {
  const size_t smem = dq_smem<T>(D);
  cudaError_t err = allow_smem(vlc_dq_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((N + QB - 1) / QB, B);
  vlc_dq_kernel<T><<<grid, THREADS, smem, s>>>(
      static_cast<const T*>(qn), static_cast<const T*>(tn), static_cast<const float*>(tau),
      static_cast<const T*>(dg), static_cast<const float*>(rowmax),
      static_cast<float*>(dq_part), static_cast<float*>(dtau_part), N, B, L, D);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return reduce<T>(dq_part, dtau_part, dq, dtau, N * D, B, (int)(grid.x * grid.y), s);
}

template <typename T>
cudaError_t dtn_tiles(const void* qn, const void* tn, const void* tau, const void* dg,
                      const void* rowmax, void* dtn, int N, int B, int L, int D,
                      cudaStream_t s) {
  const size_t smem = dtn_smem<T>(D);
  cudaError_t err = allow_smem(vlc_dtn_kernel<T>, smem);
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

// the instantiation of a launcher for the operand type
#define RZ_VT_PICK(dtype, fn) \
  ((dtype) == RZ_DTYPE_BF16 ? rz::vt::fn<__nv_bfloat16> : rz::vt::fn<float>)

// K10 in fp32: qn (N, D), t (B, L, D), tau (1,) fp32 -> logits (N, B) fp32; with
//      g non-null (autograd) also the statistics rowmax (B, N) and g (B, N, D),
//      fp32. tn (B, L, D) fp32 is scratch the caller allocates.
extern "C" int rz_vlcabs_train_fwd(const void* qn, const void* t, const void* tau, void* tn,
                                   void* logits, void* rowmax, void* g, int N, int B, int L,
                                   int D, int dtype, void* stream) {
  if (!vt_shape_ok(D) || dtype != RZ_DTYPE_F32) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(rz::vt::train_fwd<float>(qn, t, tau, tn, logits, rowmax, g, N, B, L,
                                                   D, static_cast<cudaStream_t>(stream)));
}

// tn (rows, D) = t * rsqrt(sum(t^2) + 1e-24), rounded to the operand type
extern "C" int rz_vlcabs_rownorm(const void* t, void* tn, int rows, int D, int dtype,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(RZ_VT_PICK(dtype, launch_rownorm)(t, tn, rows, D, s));
}

// the bf16 forward's last launch: qn (N, D), g (B, N, D) fp32 -> logits (N, B) fp32,
// z = qn . g / max(|g|, 1e-12) with the backward row pass's arithmetic
extern "C" int rz_vlcabs_logits(const void* qn, const void* g, void* logits, int N, int B, int D,
                                int dtype, void* stream) {
  if (B * N == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(RZ_VT_PICK(dtype, logits_rows)(qn, g, logits, N, B, D, s));
}

// the backward's row pass: qn (N, D), g (B, N, D) fp32 and dz (N, B) fp32 ->
// dg (B, N, D) operand type and, unless null, dq_part (B, N, D) fp32 = dz ghat
extern "C" int rz_vlcabs_bwd_rows(const void* qn, const void* g, const void* dz, void* dg,
                                  void* dq_part, int N, int B, int D, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(RZ_VT_PICK(dtype, bwd_rows)(qn, g, dz, dg, dq_part, N, B, D, s));
}

// K11 in fp32 after the row pass: dq (N, D) and dtau (1,) fp32 from tn, dg, rowmax
// and dq_part (dz ghat on entry, the per-image sums on exit); dtau_part
// (B * ceil(N / 32)) fp32 scratch
extern "C" int rz_vlcabs_dq(const void* qn, const void* tn, const void* tau, const void* dg,
                            const void* rowmax, void* dq_part, void* dtau_part, void* dq,
                            void* dtau, int N, int B, int L, int D, int dtype, void* stream) {
  if (!vt_shape_ok(D) || dtype != RZ_DTYPE_F32) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(rz::vt::dq_pass<float>(qn, tn, tau, dg, rowmax, dq_part, dtau_part, dq,
                                                 dtau, N, B, L, D,
                                                 static_cast<cudaStream_t>(stream)));
}

// K11 in bf16 after K12's phase 1 (rz_vlcabs_dtn_phase1 with its dtau slots): from
// ce (B, 2 Np, Lp), whose rows [0, Np) of each image hold dc, and tn (B, L, D),
// dq_part (B, N, D) fp32 += dc[b] . tn[b] in place (dz ghat on entry), then dq (N, D)
// bf16 = the images' sum in order and dtau (1,) = -(the sum of the nslots slots)
extern "C" int rz_vlcabs_dq_sm90(const void* ce, const void* tn, void* dq_part,
                                 const void* dtau_slots, void* dq, void* dtau, int N, int Np,
                                 int B, int L, int Lp, int D, int nslots, void* stream) {
  if (D % 64 || Np % 64 || Lp % 64 || N > Np || L > Lp || N <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = rz::gemm_sm90_vlc_g(ce, tn, static_cast<float*>(dq_part), N, 2 * Np, B, L,
                                        Lp, D, true, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      rz::vt::reduce<__nv_bfloat16>(dq_part, dtau_slots, dq, dtau, N * D, B, nslots, s));
}

// K12 in fp32 after the row pass: dtn (B, L, D) from tn, dg and rowmax
extern "C" int rz_vlcabs_dtn_tiles(const void* qn, const void* tn, const void* tau,
                                   const void* dg, const void* rowmax, void* dtn, int N, int B,
                                   int L, int D, int dtype, void* stream) {
  if (!vt_shape_ok(D) || dtype != RZ_DTYPE_F32) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(rz::vt::dtn_tiles<float>(qn, tn, tau, dg, rowmax, dtn, N, B, L, D,
                                                   static_cast<cudaStream_t>(stream)));
}
