// The attention kernels for Hopper: K13 flash_attention, K14 its backward,
// K15 flash_attention_bias, K16 its backward, and the packed-layout pair K2
// flash_attention_packed / K7 its backward, which are K13 / K14 over three
// strided views of one (B, L, 3D) buffer.
//
// Replace the TPU kernels of radzero_tpu/ops/flash_attention.py:
//   K13 _forward       (_kernel)        softmax(q k^T scale) v
//   K14 _unbiased_bwd  (_bwd_kernel)    dq, dk, dv
//   K15 _forward_b     (_kernel_b)      softmax(q k^T scale + bias[h] + neg[b]) v
//   K16 _bwd_b         (_bwd_kernel_b)  dq, dk, dv and d(bias) summed over the batch
// and of radzero_tpu/ops/fused_layer.py:
//   K2 flash_attention_packed (_packed_attn_kernel)      merged heads (B, L, D)
//   K7 _packed_vjp_bwd        (_packed_attn_bwd_kernel)  packed d(qkv)
// with the same contracts: fp32 scores and softmax on fp32 or bf16 operands,
// exp2 with log2(e) folded into the score, the division deferred to the
// (query, 64) output, keys >= kv_len masked; the softmax weights are rounded
// to the operand type before P.V, P and dS before their products; bias and
// neg are fp32 and d(bias) is the sum of dS before the scale.
//
// What differs from the TPU kernels, and why:
// - Layout. q, k and v are (B, L, H, 64) read by stride (a batch and a row
//   stride each), and the outputs are written by stride, so three slices of
//   one packed (B, L, 3D) product need no copy, K2 / K7 are the same device
//   code, and no (B * H, L, 64) transposes or lane padding exist.
// - One head's K and V do not fit an SM's shared memory, so the forward is
//   an online softmax over 64-key tiles with a running max (always
//   subtracted: the TPU's bf16 shortcut stable=False is not mirrored), and
//   the backward of fp32 and of K16 recomputes the row statistics (max,
//   1 / sum, delta = rowsum(dP P)) in a first kernel: ten score-sized
//   products where five would do with statistics saved by the forward. S and
//   P.V pass through warp-private shared memory, because WMMA leaves its
//   accumulator layout unspecified.
// - No sequence-length limit and no eager fallback: every loop walks tiles.
// - dK / dV: the TPU adds them up across sequential grid steps. Here one
//   block per key tile walks the query tiles with fp32 accumulators in
//   registers and rounds once. No atomics.
// - d(bias): the TPU adds it up over the batch on a sequential grid. Here a
//   block (query tile, key tile, head, batch chunk) walks its sentences in
//   order with the 16 x 64 dS tile of each warp in registers, and writes one
//   fp32 partial per chunk; the fixed-order reduce of fused_layer_bwd.cu adds
//   the chunks. A gradient has the same bits from run to run.
// - Small L: a (sentence, head) of 32 tokens is one 32 x 32 score tile, so
//   the kernels whose warps own query rows take 2 warps for L <= 32 and 4 for
//   L <= 64 (forward) instead of 8; the dK/dV kernel keeps 64 x 64 tiles.
// - A row whose keys are all masked (a fully padded sentence: neg is the
//   type's most negative number and overflows to -inf times log2 e) comes
//   out as NaN, as from the TPU kernel.
// - bf16 without a bias (K13 / K14, and K2 / K7 over their thirds) runs the
//   Hopper kernels of flash_fwd_sm90.cu and flash_bwd_sm90.cu (wgmma, TMA,
//   the softmax in registers; the forward writes the row statistic lse, the
//   backward reads it and the forward's output); fwd_kernel and the bwd_*
//   kernels below are the forward and backward of fp32 and of K15 / K16.
// What bounds them on the H100: K13 / K14 at 1370 tokens are bound by the
// math units (4 and 10 B H L^2 64 operations), K15 / K16 at 32 to 64 tokens
// by bytes. Not yet done (later work): wgmma and TMA in K15 / K16, one block
// per (sentence, head) at small L.
#include "common.cuh"
#include "flash_fwd_sm90.cuh"

namespace rz {
namespace fa {

constexpr int HD = 64;      // head dim
constexpr int TK = 64;      // keys per tile
constexpr int AP = HD + 8;  // operand pitch (elements)
constexpr int SP = TK + 4;  // fp32 score pitch
constexpr int PP = 64 + 8;  // pitch of the transposed P / dS tiles

// One (B, L, H, 64) operand read by stride: element (b, l, h, c) is
// p[b * bs + l * rs + h * 64 + c].
template <typename T>
struct Op {
  const T* p;
  long long bs, rs;
  __device__ __forceinline__ const T* head(int b, int h) const {
    return p + (size_t)b * bs + h * HD;
  }
};

// One (B, L, H, 64) result written by stride, the same addressing.
template <typename T>
struct Out {
  T* p;
  long long bs, rs;
  __device__ __forceinline__ T* row(int b, int l, int h) const {
    return p + (size_t)b * bs + (size_t)l * rs + h * HD;
  }
};

// rows [r0, r0 + rows) x 64 columns of src (row stride ld) -> dst (rows x AP);
// rows >= lim are zero
template <typename T, int NT>
__device__ __forceinline__ void load_rows(T* dst, const T* __restrict__ src, long long ld,
                                          int r0, int rows, int lim) {
  constexpr int VEC = 16 / sizeof(T), PER_ROW = HD / VEC;
  for (int i = threadIdx.x; i < rows * PER_ROW; i += NT) {
    const int r = i / PER_ROW, c = (i % PER_ROW) * VEC, row = r0 + r;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (row < lim) v = *reinterpret_cast<const uint4*>(src + (size_t)row * ld + c);
    *reinterpret_cast<uint4*>(dst + r * AP + c) = v;
  }
}

// One thread's share of the next K and V tiles, held in registers while the
// current tiles are in use (the 8-warp forward only).
template <typename T, int NT>
struct KVRegs {
  static constexpr int VEC = 16 / sizeof(T), PER_ROW = HD / VEC;
  static constexpr int N = TK * HD / VEC / NT;
  uint4 k[N], v[N];

  __device__ __forceinline__ void load(const T* __restrict__ kb, long long krs,
                                       const T* __restrict__ vb, long long vrs, int k0, int lim) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int idx = threadIdx.x + i * NT;
      const int r = idx / PER_ROW, c = (idx % PER_ROW) * VEC, key = k0 + r;
      const bool ok = key < lim;
      k[i] = ok ? *reinterpret_cast<const uint4*>(kb + (size_t)key * krs + c)
                : make_uint4(0, 0, 0, 0);
      v[i] = ok ? *reinterpret_cast<const uint4*>(vb + (size_t)key * vrs + c)
                : make_uint4(0, 0, 0, 0);
    }
  }

  __device__ __forceinline__ void store(T* Ks, T* Vs) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int idx = threadIdx.x + i * NT;
      const int off = (idx / PER_ROW) * AP + (idx % PER_ROW) * VEC;
      *reinterpret_cast<uint4*>(Ks + off) = k[i];
      *reinterpret_cast<uint4*>(Vs + off) = v[i];
    }
  }
};

// The score of (query, key) times log2 e from the raw product acc = q . k:
// -inf for a key >= Lk; with BIAS (acc scale + bias[h, q, key] + neg[b, key])
// log2 e, else acc (scale log2 e). brow and nrow are the query's bias row and
// the sentence's mask row.
template <bool BIAS>
__device__ __forceinline__ float score(float acc, int key, int Lk, float scale, float sl2,
                                       const float* __restrict__ brow,
                                       const float* __restrict__ nrow) {
  if (key >= Lk) return -INFINITY;
  if (BIAS) return (acc * scale + brow[key] + nrow[key]) * kLog2e;
  return acc * sl2;
}

// ---------------------------------------------------------------------------
// K13 / K2 in fp32 and K15 forward: grid (ceil(L / (16 NW)), H, B); each warp
// owns 16 query rows from scores to output
// ---------------------------------------------------------------------------

template <typename T, int NW>
size_t fwd_smem() {
  return (size_t)(NW * 16 + 2 * TK) * AP * sizeof(T) +
         NW * (16 * SP * sizeof(float) + 16 * AP * sizeof(T));
}

// two blocks an SM, but one for the 8-warp fp32 kernel, whose 145 KB of shared
// memory admit no second block: it may keep its registers
template <typename T, int NW, bool BIAS>
__global__ void __launch_bounds__(NW * 32, (sizeof(T) == 4 && NW == 8) ? 1 : 2)
fwd_kernel(Op<T> q, Op<T> k, Op<T> v, const float* __restrict__ bias,
           const float* __restrict__ neg, Out<T> out, int L, int Lk, int H, float scale,
           float sl2) {
  constexpr int TQ = NW * 16, NT = NW * 32;
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  T* Qs = reinterpret_cast<T*>(smem);
  T* Ks = Qs + TQ * AP;
  T* Vs = Ks + TK * AP;
  unsigned char* wbase = reinterpret_cast<unsigned char*>(Vs + TK * AP) +
                         warp * (16 * SP * sizeof(float) + 16 * AP * sizeof(T));
  float* Sw = reinterpret_cast<float*>(wbase);                    // 16 x SP
  T* Pw = reinterpret_cast<T*>(wbase + 16 * SP * sizeof(float));  // 16 x AP

  const int q0 = blockIdx.x * TQ, h = blockIdx.y, b = blockIdx.z;
  const T* qb = q.head(b, h);
  const T* kb = k.head(b, h);
  const T* vb = v.head(b, h);
  load_rows<T, NT>(Qs, qb, q.rs, q0, TQ, L);
  const T* Qw = Qs + warp * 16 * AP;

  // lane ownership: row r of the warp's 16, columns / dims [half * 32, + 32)
  const int r = lane / 2, half = lane % 2;
  const int qrow = q0 + warp * 16 + r;
  const float* brow = BIAS ? bias + ((size_t)h * L + min(qrow, L - 1)) * L : nullptr;
  const float* nrow = BIAS ? neg + (size_t)b * L : nullptr;
  float o[32];
#pragma unroll
  for (int j = 0; j < 32; ++j) o[j] = 0.f;
  float m = -INFINITY, l = 0.f;

  KVRegs<T, NT> next;
  if constexpr (NW == 8) next.load(kb, k.rs, vb, v.rs, 0, Lk);
  for (int k0 = 0; k0 < Lk; k0 += TK) {
    if constexpr (NW == 8) {
      next.store(Ks, Vs);
      __syncthreads();
      if (k0 + TK < Lk) next.load(kb, k.rs, vb, v.rs, k0 + TK, Lk);
    } else {
      load_rows<T, NT>(Ks, kb, k.rs, k0, TK, Lk);
      load_rows<T, NT>(Vs, vb, v.rs, k0, TK, Lk);
      __syncthreads();
    }

    WarpAcc<T, true> s;  // S = Q . K^T for this warp's rows
    s.zero();
    s.mma(Qw, AP, Ks, AP, HD);
    s.store(Sw, SP);
    __syncwarp();

    float tmax = -INFINITY;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int col = half * 32 + j;
      const float sv = score<BIAS>(Sw[r * SP + col], k0 + col, Lk, scale, sl2, brow, nrow);
      Sw[r * SP + col] = sv;
      tmax = fmaxf(tmax, sv);
    }
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    const float m_new = fmaxf(m, tmax);
    // a tile whose keys are all masked leaves the maximum at -inf: shift by 0
    const float m_use = m_new == -INFINITY ? 0.f : m_new;
    const float alpha = exp2f(m - m_use);  // 0 while m is -inf
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int col = half * 32 + j;
      const float p = exp2f(Sw[r * SP + col] - m_use);
      psum += p;
      Pw[r * AP + col] = from_f32<T>(p);
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    l = l * alpha + psum;
    m = m_new;
    __syncwarp();

    WarpAcc<T, false> pv;  // P . V
    pv.zero();
    pv.mma(Pw, AP, Vs, AP, TK);
    pv.store(Sw, SP);
    __syncwarp();
#pragma unroll
    for (int j = 0; j < 32; ++j) o[j] = o[j] * alpha + Sw[r * SP + half * 32 + j];
    __syncthreads();  // K/V (and Sw) are rewritten next step
  }

  if (qrow < L) {
    T* dst = out.row(b, qrow, h) + half * 32;
#pragma unroll
    for (int j = 0; j < 32; ++j) dst[j] = from_f32<T>(o[j] / l);
  }
}

// ---------------------------------------------------------------------------
// K14 / K16 backward, 64-key tiles
// ---------------------------------------------------------------------------

// this warp's 16 x 64 tiles S = Q K^T and dP = dO V^T -> Sw, Dw (fp32, pitch SP)
template <typename T>
__device__ __forceinline__ void score_tiles(const T* Qw, const T* dOw, const T* Ks, const T* Vs,
                                            float* Sw, float* Dw) {
  WarpAcc<T, true> s;
  s.zero();
  s.mma(Qw, AP, Ks, AP, HD);
  s.store(Sw, SP);
  WarpAcc<T, true> d;
  d.zero();
  d.mma(dOw, AP, Vs, AP, HD);
  d.store(Dw, SP);
  __syncwarp();
}

// smem of a kernel whose NW warps own 16 query rows each: Q, dO, K, V tiles,
// two fp32 tiles a warp and, with pw, a rounded dS tile a warp
template <typename T, int NW>
size_t rows_smem(bool pw) {
  return (size_t)(2 * NW * 16 + 2 * TK) * AP * sizeof(T) +
         NW * (2 * (size_t)16 * SP * sizeof(float) + (pw ? (size_t)16 * AP * sizeof(T) : 0));
}

// grid (ceil(L / (16 NW)), H, B): per query row the max m of the score, 1 / sum
// exp2(score - m) and delta = sum_k dP P  -> three (B, H, L) arrays
template <typename T, int NW, bool BIAS>
__global__ void __launch_bounds__(NW * 32)
bwd_stats_kernel(Op<T> q, Op<T> k, Op<T> v, const float* __restrict__ bias,
                 const float* __restrict__ neg, Op<T> dout, float* __restrict__ row_m,
                 float* __restrict__ row_il, float* __restrict__ row_delta, int L, int Lk, int H,
                 float scale, float sl2) {
  constexpr int TQ = NW * 16, NT = NW * 32;
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  T* Qs = reinterpret_cast<T*>(smem);
  T* dOs = Qs + TQ * AP;
  T* Ks = dOs + TQ * AP;
  T* Vs = Ks + TK * AP;
  float* Sw = reinterpret_cast<float*>(Vs + TK * AP) + warp * 2 * 16 * SP;
  float* Dw = Sw + 16 * SP;
  const int q0 = blockIdx.x * TQ, h = blockIdx.y, b = blockIdx.z;
  const T* kb = k.head(b, h);
  const T* vb = v.head(b, h);
  load_rows<T, NT>(Qs, q.head(b, h), q.rs, q0, TQ, L);
  load_rows<T, NT>(dOs, dout.head(b, h), dout.rs, q0, TQ, L);
  const T* Qw = Qs + warp * 16 * AP;
  const T* dOw = dOs + warp * 16 * AP;
  const int r = lane / 2, half = lane % 2;
  const int qrow = q0 + warp * 16 + r;
  const float* brow = BIAS ? bias + ((size_t)h * L + min(qrow, L - 1)) * L : nullptr;
  const float* nrow = BIAS ? neg + (size_t)b * L : nullptr;

  float m = -INFINITY, l = 0.f;
  for (int k0 = 0; k0 < Lk; k0 += TK) {  // sweep 1: row max and row sum
    __syncthreads();
    load_rows<T, NT>(Ks, kb, k.rs, k0, TK, Lk);
    __syncthreads();
    WarpAcc<T, true> s;
    s.zero();
    s.mma(Qw, AP, Ks, AP, HD);
    s.store(Sw, SP);
    __syncwarp();
    float tmax = -INFINITY;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int col = half * 32 + j;
      const float sv = score<BIAS>(Sw[r * SP + col], k0 + col, Lk, scale, sl2, brow, nrow);
      Sw[r * SP + col] = sv;
      tmax = fmaxf(tmax, sv);
    }
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    const float m_new = fmaxf(m, tmax);
    const float m_use = m_new == -INFINITY ? 0.f : m_new;
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < 32; ++j) psum += exp2f(Sw[r * SP + half * 32 + j] - m_use);
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    l = l * exp2f(m - m_use) + psum;
    m = m_new;
    __syncwarp();
  }
  const float il = 1.0f / l;
  float delta = 0.f;
  for (int k0 = 0; k0 < Lk; k0 += TK) {  // sweep 2: delta
    __syncthreads();
    load_rows<T, NT>(Ks, kb, k.rs, k0, TK, Lk);
    load_rows<T, NT>(Vs, vb, v.rs, k0, TK, Lk);
    __syncthreads();
    score_tiles<T>(Qw, dOw, Ks, Vs, Sw, Dw);
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int col = half * 32 + j;
      const float sv = score<BIAS>(Sw[r * SP + col], k0 + col, Lk, scale, sl2, brow, nrow);
      delta += exp2f(sv - m) * il * Dw[r * SP + col];
    }
    __syncwarp();
  }
  delta += __shfl_xor_sync(0xffffffffu, delta, 1);
  if (half == 0 && qrow < L) {
    const size_t o = ((size_t)b * H + h) * L + qrow;
    row_m[o] = m;
    row_il[o] = il;
    row_delta[o] = delta;
  }
}

template <typename T>
size_t dkdv_smem() {
  return (size_t)4 * 64 * AP * sizeof(T) + 2 * (size_t)TK * PP * sizeof(T) +
         4 * (2 * (size_t)16 * SP * sizeof(float));
}

// grid (ceil(L / 64), H, B) over key tiles, 4 warps: dK and dV of one key
// tile, every query tile walked in order
template <typename T, bool BIAS>
__global__ void __launch_bounds__(128)
bwd_dkdv_kernel(Op<T> q, Op<T> k, Op<T> v, const float* __restrict__ bias,
                const float* __restrict__ neg, Op<T> dout, const float* __restrict__ row_m,
                const float* __restrict__ row_il, const float* __restrict__ row_delta,
                Out<T> dk_out, Out<T> dv_out, int L, int Lk, int H, float scale, float sl2) {
  constexpr int NT = 128;
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  T* Ks = reinterpret_cast<T*>(smem);
  T* Vs = Ks + 64 * AP;
  T* Qs = Vs + 64 * AP;
  T* dOs = Qs + 64 * AP;
  T* Pt = dOs + 64 * AP;  // (keys x queries), pitch PP
  T* dSt = Pt + TK * PP;
  float* Sw = reinterpret_cast<float*>(dSt + TK * PP) + warp * 2 * 16 * SP;
  float* Dw = Sw + 16 * SP;
  const int k0 = blockIdx.x * TK, h = blockIdx.y, b = blockIdx.z;
  const T* qb = q.head(b, h);
  const T* dob = dout.head(b, h);
  const size_t srow = ((size_t)b * H + h) * L;
  load_rows<T, NT>(Ks, k.head(b, h), k.rs, k0, TK, Lk);
  load_rows<T, NT>(Vs, v.head(b, h), v.rs, k0, TK, Lk);
  const int r = lane / 2, half = lane % 2;
  const float* nrow = BIAS ? neg + (size_t)b * L : nullptr;

  WarpAcc<T, false> dv, dk;
  dv.zero();
  dk.zero();
  for (int q0 = 0; q0 < L; q0 += 64) {
    __syncthreads();  // the last products have read Qs, dOs, Pt and dSt
    load_rows<T, NT>(Qs, qb, q.rs, q0, 64, L);
    load_rows<T, NT>(dOs, dob, dout.rs, q0, 64, L);
    __syncthreads();
    score_tiles<T>(Qs + warp * 16 * AP, dOs + warp * 16 * AP, Ks, Vs, Sw, Dw);
    const int qrow = q0 + warp * 16 + r;
    const bool q_ok = qrow < L;
    const float mq = q_ok ? row_m[srow + qrow] : 0.f, il = q_ok ? row_il[srow + qrow] : 0.f;
    const float dl = q_ok ? row_delta[srow + qrow] : 0.f;
    const float* brow = BIAS ? bias + ((size_t)h * L + min(qrow, L - 1)) * L : nullptr;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int col = half * 32 + j;
      float p = 0.f;
      if (q_ok)
        p = exp2f(score<BIAS>(Sw[r * SP + col], k0 + col, Lk, scale, sl2, brow, nrow) - mq) * il;
      const float ds = p * (Dw[r * SP + col] - dl) * scale;
      Pt[col * PP + warp * 16 + r] = from_f32<T>(p);
      dSt[col * PP + warp * 16 + r] = from_f32<T>(ds);
    }
    __syncthreads();
    dv.mma(Pt + warp * 16 * PP, PP, dOs, AP, 64);  // P^T dO
    dk.mma(dSt + warp * 16 * PP, PP, Qs, AP, 64);  // dS^T Q
  }

  const int key = k0 + warp * 16 + r;
  dv.store(Sw, SP);
  __syncwarp();
  if (key < L) {
    T* drow = dv_out.row(b, key, h) + half * 32;
#pragma unroll
    for (int j = 0; j < 32; ++j) drow[j] = from_f32<T>(Sw[r * SP + half * 32 + j]);
  }
  __syncwarp();
  dk.store(Sw, SP);
  __syncwarp();
  if (key < L) {
    T* drow = dk_out.row(b, key, h) + half * 32;
#pragma unroll
    for (int j = 0; j < 32; ++j) drow[j] = from_f32<T>(Sw[r * SP + half * 32 + j]);
  }
}

// grid (ceil(L / (16 NW)), H, B) over query tiles: dQ, every key tile walked in
// order; each warp owns 16 query rows end to end
template <typename T, int NW, bool BIAS>
__global__ void __launch_bounds__(NW * 32)
bwd_dq_kernel(Op<T> q, Op<T> k, Op<T> v, const float* __restrict__ bias,
              const float* __restrict__ neg, Op<T> dout, const float* __restrict__ row_m,
              const float* __restrict__ row_il, const float* __restrict__ row_delta,
              Out<T> dq_out, int L, int Lk, int H, float scale, float sl2) {
  constexpr int TQ = NW * 16, NT = NW * 32;
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  T* Qs = reinterpret_cast<T*>(smem);
  T* dOs = Qs + TQ * AP;
  T* Ks = dOs + TQ * AP;
  T* Vs = Ks + TK * AP;
  unsigned char* wbase = reinterpret_cast<unsigned char*>(Vs + TK * AP) +
                         warp * (2 * 16 * SP * sizeof(float) + 16 * AP * sizeof(T));
  float* Sw = reinterpret_cast<float*>(wbase);
  float* Dw = Sw + 16 * SP;
  T* Pw = reinterpret_cast<T*>(Dw + 16 * SP);  // dS, rounded: 16 x AP
  const int q0 = blockIdx.x * TQ, h = blockIdx.y, b = blockIdx.z;
  const T* kb = k.head(b, h);
  const T* vb = v.head(b, h);
  load_rows<T, NT>(Qs, q.head(b, h), q.rs, q0, TQ, L);
  load_rows<T, NT>(dOs, dout.head(b, h), dout.rs, q0, TQ, L);
  const int r = lane / 2, half = lane % 2;
  const int qrow = q0 + warp * 16 + r;
  const bool q_ok = qrow < L;
  const size_t srow = ((size_t)b * H + h) * L;
  const float mq = q_ok ? row_m[srow + qrow] : 0.f, il = q_ok ? row_il[srow + qrow] : 0.f;
  const float dl = q_ok ? row_delta[srow + qrow] : 0.f;
  const float* brow = BIAS ? bias + ((size_t)h * L + min(qrow, L - 1)) * L : nullptr;
  const float* nrow = BIAS ? neg + (size_t)b * L : nullptr;

  WarpAcc<T, false> dq;
  dq.zero();
  for (int k0 = 0; k0 < Lk; k0 += TK) {
    __syncthreads();
    load_rows<T, NT>(Ks, kb, k.rs, k0, TK, Lk);
    load_rows<T, NT>(Vs, vb, v.rs, k0, TK, Lk);
    __syncthreads();
    score_tiles<T>(Qs + warp * 16 * AP, dOs + warp * 16 * AP, Ks, Vs, Sw, Dw);
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int col = half * 32 + j;
      float p = 0.f;
      if (q_ok)
        p = exp2f(score<BIAS>(Sw[r * SP + col], k0 + col, Lk, scale, sl2, brow, nrow) - mq) * il;
      Pw[r * AP + col] = from_f32<T>(p * (Dw[r * SP + col] - dl) * scale);
    }
    __syncwarp();
    dq.mma(Pw, AP, Ks, AP, TK);  // dS K
  }
  dq.store(Sw, SP);
  __syncwarp();
  if (q_ok) {
    T* drow = dq_out.row(b, qrow, h) + half * 32;
#pragma unroll
    for (int j = 0; j < 32; ++j) drow[j] = from_f32<T>(Sw[r * SP + half * 32 + j]);
  }
}

// K16 only. grid (query tiles x key tiles, H, chunks): the dS tile before the
// scale, summed in fp32 over the sentences [c per, c per + per) in order ->
// part (chunks, H, L, L)
template <typename T, int NW>
__global__ void __launch_bounds__(NW * 32)
bwd_dbias_kernel(Op<T> q, Op<T> k, Op<T> v, const float* __restrict__ bias,
                 const float* __restrict__ neg, Op<T> dout, const float* __restrict__ row_m,
                 const float* __restrict__ row_il, const float* __restrict__ row_delta,
                 float* __restrict__ part, int B, int L, int Lk, int H, int per, float scale,
                 float sl2) {
  constexpr int TQ = NW * 16, NT = NW * 32;
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  T* Qs = reinterpret_cast<T*>(smem);
  T* dOs = Qs + TQ * AP;
  T* Ks = dOs + TQ * AP;
  T* Vs = Ks + TK * AP;
  float* Sw = reinterpret_cast<float*>(Vs + TK * AP) + warp * 2 * 16 * SP;
  float* Dw = Sw + 16 * SP;
  const int nk = (L + TK - 1) / TK;
  const int q0 = (blockIdx.x / nk) * TQ, k0 = (blockIdx.x % nk) * TK;
  const int h = blockIdx.y, c = blockIdx.z;
  const int r = lane / 2, half = lane % 2;
  const int qrow = q0 + warp * 16 + r;
  const bool q_ok = qrow < L;
  const float* brow = bias + ((size_t)h * L + min(qrow, L - 1)) * L;

  float acc[32];
#pragma unroll
  for (int j = 0; j < 32; ++j) acc[j] = 0.f;
  const int b_end = min(B, (c + 1) * per);
  for (int b = c * per; b < b_end; ++b) {
    __syncthreads();
    load_rows<T, NT>(Qs, q.head(b, h), q.rs, q0, TQ, L);
    load_rows<T, NT>(dOs, dout.head(b, h), dout.rs, q0, TQ, L);
    load_rows<T, NT>(Ks, k.head(b, h), k.rs, k0, TK, Lk);
    load_rows<T, NT>(Vs, v.head(b, h), v.rs, k0, TK, Lk);
    __syncthreads();
    score_tiles<T>(Qs + warp * 16 * AP, dOs + warp * 16 * AP, Ks, Vs, Sw, Dw);
    if (q_ok) {
      const size_t srow = ((size_t)b * H + h) * L + qrow;
      const float mq = row_m[srow], il = row_il[srow], dl = row_delta[srow];
      const float* nrow = neg + (size_t)b * L;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int col = half * 32 + j;
        const float p =
            exp2f(score<true>(Sw[r * SP + col], k0 + col, Lk, scale, sl2, brow, nrow) - mq) * il;
        acc[j] += p * (Dw[r * SP + col] - dl);
      }
    }
  }
  if (q_ok) {
    float* prow = part + (((size_t)c * H + h) * L + qrow) * L;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int key = k0 + half * 32 + j;
      if (key < L) prow[key] = acc[j];
    }
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

struct Args {  // the operands of one call, as the C entry points receive them
  const void *q, *k, *v;
  long long q_bs, q_rs, k_bs, k_rs, v_bs, v_rs;
  const float *bias, *neg;  // null without a bias
  int B, L, H, Lk;
  float scale;
  long long o_bs, o_rs;  // strides of the results: out, or dq, dk and dv

  void packed(const void* qkv, int dtype) {  // q, k, v: the thirds of a (B, L, 3D) buffer
    const long long d = (long long)H * HD;
    const size_t third = (size_t)d * (dtype == RZ_DTYPE_BF16 ? 2 : 4);
    q = qkv;
    k = static_cast<const char*>(qkv) + third;
    v = static_cast<const char*>(qkv) + 2 * third;
    q_rs = k_rs = v_rs = 3 * d;
    q_bs = k_bs = v_bs = 3 * d * L;
  }
  void contiguous_results() {
    o_rs = (long long)H * HD;
    o_bs = o_rs * L;
  }
};

template <typename T>
Op<T> op(const void* p, long long bs, long long rs) {
  return Op<T>{static_cast<const T*>(p), bs, rs};
}

template <typename T>
Out<T> result(void* p, const Args& a) {
  return Out<T>{static_cast<T*>(p), a.o_bs, a.o_rs};
}

template <typename T, int NW, bool BIAS>
cudaError_t launch_fwd(const Args& a, void* out, cudaStream_t s) {
  const size_t smem = fwd_smem<T, NW>();
  cudaError_t err = allow_smem(fwd_kernel<T, NW, BIAS>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.L + NW * 16 - 1) / (NW * 16), a.H, a.B);
  fwd_kernel<T, NW, BIAS><<<grid, NW * 32, smem, s>>>(
      op<T>(a.q, a.q_bs, a.q_rs), op<T>(a.k, a.k_bs, a.k_rs), op<T>(a.v, a.v_bs, a.v_rs), a.bias,
      a.neg, result<T>(out, a), a.L, a.Lk, a.H, a.scale, a.scale * kLog2e);
  return cudaGetLastError();
}

// bf16 without a bias: the Hopper kernel of flash_fwd_sm90.cu at every length,
// which also writes lse (B, H, L) when it is not null. Else (no lse) the
// forward's tile by length: 2 warps (32 queries) up to 32 tokens, 4 up to 64,
// else 8 (128 queries) with the next K/V tile in flight
template <typename T, bool BIAS>
cudaError_t forward(const Args& a, void* out, float* lse, cudaStream_t s) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value && !BIAS) {
    return forward_sm90(a.q, a.k, a.v, a.q_bs, a.q_rs, a.k_bs, a.k_rs, a.v_bs, a.v_rs, out,
                        a.o_bs, a.o_rs, lse, a.B, a.L, a.H, a.Lk, a.scale, s);
  } else {
    if (lse != nullptr) return cudaErrorInvalidValue;
    if (a.L <= 32) return launch_fwd<T, 2, BIAS>(a, out, s);
    if (a.L <= 64) return launch_fwd<T, 4, BIAS>(a, out, s);
    return launch_fwd<T, 8, BIAS>(a, out, s);
  }
}

struct BwdArgs {
  const void* dout;  // (B, L, H, 64) contiguous
  const void* out;   // the forward's output, (B, L, H, 64) contiguous: bf16 without a bias only
  const float* lse;  // the forward's row statistic (B, H, L): bf16 without a bias only
  float *row_m, *row_il, *row_delta;  // (B, H, L) scratch; bf16 without a bias: row_delta only
  void *dq, *dk, *dv;                 // (B, L, H, 64) by the strides of Args
  float* dbias_part;                  // (chunks, H, L, L), K16 only
  int chunks;
};

// NW: warps of the kernels whose warps own query rows (statistics, dQ, d(bias))
template <typename T, int NW, bool BIAS>
cudaError_t launch_bwd(const Args& a, const BwdArgs& g, cudaStream_t s) {
  const Op<T> q = op<T>(a.q, a.q_bs, a.q_rs), k = op<T>(a.k, a.k_bs, a.k_rs);
  const Op<T> v = op<T>(a.v, a.v_bs, a.v_rs);
  const Op<T> dout = op<T>(g.dout, (long long)a.L * a.H * HD, (long long)a.H * HD);
  const float sl2 = a.scale * kLog2e;
  const int nq = (a.L + NW * 16 - 1) / (NW * 16), nk = (a.L + TK - 1) / TK;
  dim3 qgrid(nq, a.H, a.B), kgrid(nk, a.H, a.B);

  size_t smem = rows_smem<T, NW>(false);
  cudaError_t err = allow_smem(bwd_stats_kernel<T, NW, BIAS>, smem);
  if (err != cudaSuccess) return err;
  bwd_stats_kernel<T, NW, BIAS><<<qgrid, NW * 32, smem, s>>>(
      q, k, v, a.bias, a.neg, dout, g.row_m, g.row_il, g.row_delta, a.L, a.Lk, a.H, a.scale, sl2);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  smem = dkdv_smem<T>();
  if ((err = allow_smem(bwd_dkdv_kernel<T, BIAS>, smem)) != cudaSuccess) return err;
  bwd_dkdv_kernel<T, BIAS><<<kgrid, 128, smem, s>>>(
      q, k, v, a.bias, a.neg, dout, g.row_m, g.row_il, g.row_delta, result<T>(g.dk, a),
      result<T>(g.dv, a), a.L, a.Lk, a.H, a.scale, sl2);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  smem = rows_smem<T, NW>(true);
  if ((err = allow_smem(bwd_dq_kernel<T, NW, BIAS>, smem)) != cudaSuccess) return err;
  bwd_dq_kernel<T, NW, BIAS><<<qgrid, NW * 32, smem, s>>>(
      q, k, v, a.bias, a.neg, dout, g.row_m, g.row_il, g.row_delta, result<T>(g.dq, a), a.L,
      a.Lk, a.H, a.scale, sl2);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  if constexpr (BIAS) {
    smem = rows_smem<T, NW>(false);
    if ((err = allow_smem(bwd_dbias_kernel<T, NW>, smem)) != cudaSuccess) return err;
    const int per = (a.B + g.chunks - 1) / g.chunks;
    dim3 bgrid(nq * nk, a.H, g.chunks);
    bwd_dbias_kernel<T, NW><<<bgrid, NW * 32, smem, s>>>(
        q, k, v, a.bias, a.neg, dout, g.row_m, g.row_il, g.row_delta, g.dbias_part, a.B, a.L,
        a.Lk, a.H, per, a.scale, sl2);
    err = cudaGetLastError();
  }
  return err;
}

// bf16 without a bias: the Hopper kernels of flash_bwd_sm90.cu, which read the
// forward's out and lse (an error without them). Else the statistics, dK/dV
// and dQ kernels above, by length
template <typename T, bool BIAS>
cudaError_t backward(const Args& a, const BwdArgs& g, cudaStream_t s) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value && !BIAS) {
    if (g.out == nullptr || g.lse == nullptr || g.row_delta == nullptr)
      return cudaErrorInvalidValue;
    return backward_sm90(a.q, a.k, a.v, a.q_bs, a.q_rs, a.k_bs, a.k_rs, a.v_bs, a.v_rs, g.out,
                         g.dout, g.lse, g.row_delta, g.dq, g.dk, g.dv, a.o_bs, a.o_rs, a.B, a.L,
                         a.H, a.Lk, a.scale, s);
  } else {
    if (a.L <= 32) return launch_bwd<T, 2, BIAS>(a, g, s);
    return launch_bwd<T, 4, BIAS>(a, g, s);
  }
}

inline bool bad(const Args& a, int hd) {
  return hd != HD || a.B < 1 || a.L < 1 || a.H < 1 || a.Lk < 1 || a.Lk > a.L;
}

}  // namespace fa
}  // namespace rz

using bf16 = __nv_bfloat16;
namespace fa = rz::fa;

static fa::Args make_args(const void* q, const void* k, const void* v, long long q_bs,
                          long long q_rs, long long k_bs, long long k_rs, long long v_bs,
                          long long v_rs, const void* bias, const void* neg, int B, int L, int H,
                          int kv_len, float scale) {
  fa::Args a{q, k, v, q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, static_cast<const float*>(bias),
             static_cast<const float*>(neg), B, L, H, kv_len, scale, 0, 0};
  a.contiguous_results();
  return a;
}

template <bool BIAS>
static int run_forward(const fa::Args& a, int hd, void* out, float* lse, int dtype,
                       void* stream) {
  if (fa::bad(a, hd)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dtype == RZ_DTYPE_BF16 ? fa::forward<bf16, BIAS>(a, out, lse, s)
                                                 : fa::forward<float, BIAS>(a, out, lse, s));
}

// the scratch of a backward: (3, B, H, L) fp32 for the statistics kernel, or,
// in bf16 without a bias, (1, B, H, L) for delta alone
static fa::BwdArgs bwd_args(const void* dout, const void* out, const void* lse, float* st,
                            size_t n, void* dq, void* dk, void* dv, int dtype, bool bias) {
  const bool sm90 = dtype == RZ_DTYPE_BF16 && !bias;
  return {dout, out, static_cast<const float*>(lse), sm90 ? nullptr : st,
          sm90 ? nullptr : st + n, sm90 ? st : st + 2 * n, dq, dk, dv, nullptr, 0};
}

template <bool BIAS>
static int run_backward(const fa::Args& a, int hd, const fa::BwdArgs& g, int dtype,
                        void* stream) {
  if (fa::bad(a, hd)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dtype == RZ_DTYPE_BF16 ? fa::backward<bf16, BIAS>(a, g, s)
                                                 : fa::backward<float, BIAS>(a, g, s));
}

// K13: q, k, v (B, L, H, 64) by stride -> out (B, L, H, 64) contiguous; keys
// >= kv_len are masked. lse (B, H, L) fp32 or null: the row statistic the bf16
// backward reads (bf16 only)
extern "C" int rz_flash_attention(const void* q, const void* k, const void* v, void* out,
                                  void* lse, long long q_bs, long long q_rs, long long k_bs,
                                  long long k_rs, long long v_bs, long long v_rs, int B, int L,
                                  int H, int hd, int kv_len, float scale, int dtype,
                                  void* stream) {
  const fa::Args a = make_args(q, k, v, q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, nullptr, nullptr, B,
                               L, H, kv_len, scale);
  return run_forward<false>(a, hd, out, static_cast<float*>(lse), dtype, stream);
}

// K15: the same with bias (H, L, L) fp32 and neg (B, L) fp32 added to the score
extern "C" int rz_flash_attention_bias(const void* q, const void* k, const void* v,
                                       const void* bias, const void* neg, void* out,
                                       long long q_bs, long long q_rs, long long k_bs,
                                       long long k_rs, long long v_bs, long long v_rs, int B,
                                       int L, int H, int hd, int kv_len, float scale, int dtype,
                                       void* stream) {
  const fa::Args a = make_args(q, k, v, q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, bias, neg, B, L, H,
                               kv_len, scale);
  return run_forward<true>(a, hd, out, nullptr, dtype, stream);
}

// K14: cotangent dout (B, L, H, 64) contiguous -> dq, dk, dv (B, L, H, 64)
// contiguous. bf16: out (the forward's output, contiguous) and lse (its row
// statistic) are required and stats is (1, B, H, L) fp32 scratch; fp32: out
// and lse are ignored and stats is (3, B, H, L)
extern "C" int rz_flash_attention_bwd(const void* q, const void* k, const void* v,
                                      const void* dout, const void* out, const void* lse,
                                      void* stats, void* dq, void* dk, void* dv, long long q_bs,
                                      long long q_rs, long long k_bs, long long k_rs,
                                      long long v_bs, long long v_rs, int B, int L, int H, int hd,
                                      int kv_len, float scale, int dtype, void* stream) {
  const fa::Args a = make_args(q, k, v, q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, nullptr, nullptr, B,
                               L, H, kv_len, scale);
  return run_backward<false>(a, hd,
                             bwd_args(dout, out, lse, static_cast<float*>(stats),
                                      (size_t)B * H * L, dq, dk, dv, dtype, false),
                             dtype, stream);
}

// K16: as K14 with the bias and the key mask, plus dbias_part (chunks, H, L, L)
// fp32: the sum of dS before the scale over each chunk of ceil(B / chunks)
// sentences, to be added up over the chunks by rz_reduce_parts
extern "C" int rz_flash_attention_bias_bwd(const void* q, const void* k, const void* v,
                                           const void* bias, const void* neg, const void* dout,
                                           void* stats, void* dq, void* dk, void* dv,
                                           void* dbias_part, int chunks, long long q_bs,
                                           long long q_rs, long long k_bs, long long k_rs,
                                           long long v_bs, long long v_rs, int B, int L, int H,
                                           int hd, int kv_len, float scale, int dtype,
                                           void* stream) {
  if (chunks < 1 || chunks > B) return static_cast<int>(cudaErrorInvalidValue);
  const fa::Args a = make_args(q, k, v, q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, bias, neg, B, L, H,
                               kv_len, scale);
  fa::BwdArgs g = bwd_args(dout, nullptr, nullptr, static_cast<float*>(stats),
                           (size_t)B * H * L, dq, dk, dv, dtype, true);
  g.dbias_part = static_cast<float*>(dbias_part);
  g.chunks = chunks;
  return run_backward<true>(a, hd, g, dtype, stream);
}

// K2: qkv (B, L, 3D) packed [q | k | v] -> out (B, L, D) merged heads, D = H * 64:
// K13 over the three thirds, no key masked; lse as for K13
extern "C" int rz_packed_attention(const void* qkv, void* out, void* lse, int B, int L, int H,
                                   int hd, float scale, int dtype, void* stream) {
  fa::Args a = make_args(nullptr, nullptr, nullptr, 0, 0, 0, 0, 0, 0, nullptr, nullptr, B, L, H,
                         L, scale);
  a.packed(qkv, dtype);
  return run_forward<false>(a, hd, out, static_cast<float*>(lse), dtype, stream);
}

// K7: qkv (B, L, 3D), dout (B, L, D) -> dqkv (B, L, 3D): K14 writing dq, dk and
// dv into the thirds of dqkv; out (B, L, D) and lse as for K14. row_m, row_il
// and row_delta are (B, H, L) fp32 scratch (bf16: row_delta only, the others
// may be null)
extern "C" int rz_packed_attention_bwd(const void* qkv, const void* dout, const void* out,
                                       const void* lse, void* row_m, void* row_il,
                                       void* row_delta, void* dqkv, int B, int L, int H, int hd,
                                       float scale, int dtype, void* stream) {
  fa::Args a = make_args(nullptr, nullptr, nullptr, 0, 0, 0, 0, 0, 0, nullptr, nullptr, B, L, H,
                         L, scale);
  a.packed(qkv, dtype);
  a.o_bs = a.q_bs;
  a.o_rs = a.q_rs;
  const size_t third = static_cast<const char*>(a.k) - static_cast<const char*>(a.q);
  char* d = static_cast<char*>(dqkv);
  return run_backward<false>(a, hd,
                             {dout, out, static_cast<const float*>(lse),
                              static_cast<float*>(row_m), static_cast<float*>(row_il),
                              static_cast<float*>(row_delta), d, d + third, d + 2 * third, nullptr,
                              0},
                             dtype, stream);
}
