// The bf16 attention with a batch-shared bias at short lengths: K15
// flash_attention_bias and K16 flash_attention_bias_bwd at L <= 64 (MPNet's
// sentences: 32 tokens in the training step, 64 in the scorer). fp32, and
// bf16 at L > 64, stay on fwd_kernel / bwd_*_kernel of flash_attention.cu.
//
// Replaces the TPU kernels radzero_tpu/ops/flash_attention.py _forward_b
// (_kernel_b, the pallas_call at :333) and _bwd_b (_bwd_kernel_b, :470), with
// their contract: fp32 scores (acc scale + bias + neg) log2 e, keys >= Lk at
// -inf, the row maximum always subtracted; forward: the unnormalised
// exp2(s - m) rounded to bf16 before P.V, the division deferred to the
// output; backward: P = e / sum in fp32, bf16(P) for dV = P^T dO, dP = dO V^T,
// delta = rowsum(dP P) in fp32, dS0 = P (dP - delta) from unrounded P,
// d(bias) the fp32 sum of dS0 over the batch, dS = bf16(dS0 scale) for dQ =
// dS K and dK = dS^T Q; every result rounded once. A fully padded sentence
// (neg the type's most negative number, which times log2 e is -inf) gives
// NaN, as from the TPU kernel: -inf minus the row maximum -inf.
//
// What bounds it on the H100: bytes. At 512 sentences x 32 tokens x 12 heads
// the forward does 4 B H L^2 64 = 1.6 G operations on 100 MB, the backward
// 10 B H L^2 64 = 4 G on 176 MB, far under the card's ~295 operations a byte.
// A (sentence, head) is one L x L score tile, so the design reads each
// operand once, keeps loads in flight and keeps S, P, dP and dS in
// registers:
// - One block per (head, chunk of sentences), grid (H, chunks); L / 16 warps
//   (L rounded up to 32 or 64), each owning 16 query rows and all keys. The
//   block loads its head's bias tile into shared memory once and walks its
//   sentences in order, the next sentence's Q, K, V (and dO) and mask row
//   arriving by cp.async (16 bytes, .cg) into a second buffer while it
//   computes this one. Rows and keys >= L arrive as zeros.
// - mma.sync m16n8k16 (bf16, fp32 accumulators) with operands through
//   ldmatrix: at 32 tokens wgmma's 64-row tiles would be half empty. The
//   accumulator layout is documented, so the softmax runs on it, and two
//   adjacent n-tiles of a C fragment are the A fragment of the next product
//   (P.V, dS.K) with no shuffle. Row max, sum and delta by quad shuffles.
// - The backward: S, P, dP, delta, dS0 and dS for the warp's rows in
//   registers, its 16 x L slice of d(bias) added to fp32 registers in
//   sentence order; bf16(P) and dS go to shared memory, whence dK = dS^T Q and
//   dV = P^T dO read them transposed (ldmatrix.trans) for the warp's 16 keys.
//   At the end of its chunk the block writes its d(bias) partial (rows owned
//   by one warp each); the fixed-order reduce of fused_layer_bwd.cu adds the
//   chunks. No atomics: a second backward gives the same bits.
// - Results are staged in the finished operand rows and written in 16-byte
//   stores by stride. Query rows >= L get P = 0 and dS0 = 0, so they add
//   nothing to dK, dV or d(bias); rows and keys >= L are never written.
#include "flash_bias_small.cuh"
#include "sm90.cuh"

namespace rz {
namespace fa {
namespace {

using sm90::pack_bf16;
using sm90::smem_addr;
using bf16 = __nv_bfloat16;

constexpr int HD = 64;      // head dim
constexpr int AP = HD + 8;  // operand row pitch (elements): 144 bytes, ldmatrix without conflicts

// one (B, L, H, 64) operand read by stride
struct Src {
  const bf16* p;
  long long bs, rs;
};

__device__ __forceinline__ void cp16(void* dst, const void* src, bool ok) {  // zeros if !ok
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(smem_addr(dst)), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp4(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(smem_addr(dst)), "l"(src),
               "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }
__device__ __forceinline__ void cp_wait() { asm volatile("cp.async.wait_group 0;" ::: "memory"); }

__device__ __forceinline__ void ldsm(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

// d (16 x 8 fp32) += a (16 x 16) . b (16 x 8)
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The element of a row-major array (pitch ld) whose address a lane gives
// ldmatrix.x4 for the 16 x 16 tile at (r0, c0); the four 8 x 8 matrices come
// back in the order
// - down_first: (rows 0-7, cols 0-7), (8-15, 0-7), (0-7, 8-15), (8-15, 8-15):
//   the A fragment a0..a3 (non-transposed), or .trans of a tile with rows
//   along k: the B fragments {b0, b1} of the n-tile at c0, then of c0 + 8;
// - across_first: (rows 0-7, cols 0-7), (0-7, 8-15), (8-15, 0-7), (8-15, 8-15):
//   of a tile with rows along n, {b0, b1} of the n-tile at r0, then of r0 + 8
//   (non-transposed), or .trans of a tile with rows along k: the A fragment
//   of its transpose.
__device__ __forceinline__ int down_first(int lane, int r0, int c0, int ld) {
  return (r0 + (lane & 15)) * ld + c0 + (lane >> 4) * 8;
}
__device__ __forceinline__ int across_first(int lane, int r0, int c0, int ld) {
  return (r0 + (lane & 7) + (lane >> 4) * 8) * ld + c0 + ((lane >> 3) & 1) * 8;
}

// d[NJ] (16 x 8 NJ) = A (16 rows at ra of a, pitch AP) . B^T (rows of b along n)
template <int NJ>
__device__ __forceinline__ void product_nt(float (&d)[NJ][4], const bf16* a, int ra,
                                           const bf16* b, int lane) {
#pragma unroll
  for (int j = 0; j < NJ; ++j) d[j][0] = d[j][1] = d[j][2] = d[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < HD; kk += 16) {
    uint32_t af[4];
    ldsm(af, a + down_first(lane, ra, kk, AP));
#pragma unroll
    for (int j = 0; j < NJ; j += 2) {
      uint32_t bf[4];
      ldsm(bf, b + across_first(lane, 8 * j, kk, AP));
      mma(d[j], af, bf[0], bf[1]);
      mma(d[j + 1], af, bf[2], bf[3]);
    }
  }
}

// d (16 x 64) += A (16 x 16, fragment) . B (the 16 rows at rb of b, pitch AP)
__device__ __forceinline__ void product_tn(float (&d)[8][4], const uint32_t (&af)[4],
                                           const bf16* b, int rb, int lane) {
#pragma unroll
  for (int n = 0; n < 8; n += 2) {
    uint32_t bf[4];
    ldsm_t(bf, b + down_first(lane, rb, 8 * n, AP));
    mma(d[n], af, bf[0], bf[1]);
    mma(d[n + 1], af, bf[2], bf[3]);
  }
}

// the A fragment of k-step kk (keys 16 kk..) from an accumulator over keys
template <int NJ>
__device__ __forceinline__ void as_a(uint32_t (&a)[4], const float (&c)[NJ][4], int kk) {
  a[0] = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
  a[1] = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
  a[2] = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
  a[3] = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <int LT>
struct Tiles {  // shared memory beside the operand buffers
  float bias[LT][LT + 8];  // this head's bias, zeros past L; the pitch spreads rows over banks
  float neg[2][LT];        // the mask row of each buffer's sentence
};

template <int LT, int OPS>
struct Ops : Tiles<LT> {
  bf16 op[2][OPS][LT][AP];  // two buffers of Q, K, V (, dO)
};

template <int LT>
struct BwdSmem : Ops<LT, 4> {
  bf16 p[LT][LT + 8];   // bf16(P) of the sentence
  bf16 ds[LT][LT + 8];  // dS
};

// Everything a block walks: grid (H, chunks), ceil(B / chunks) sentences a chunk.
struct Walk {
  Src src[4];  // q, k, v, dout
  const float* bias;
  const float* neg;
  int B, L, Lk, per;
  float scale;
};

// the head's bias tile (zeros past L) -> t.bias
template <int LT, int NT>
__device__ __forceinline__ void load_bias(Tiles<LT>& t, const Walk& w, int h) {
  for (int i = threadIdx.x; i < LT * LT; i += NT) {
    const int r = i / LT, c = i % LT;
    const bool ok = r < w.L && c < w.L;
    cp4(&t.bias[r][c], w.bias + ((size_t)h * w.L + (ok ? r : 0)) * w.L + (ok ? c : 0), ok);
  }
}

// sentence b's OPS operands of head h and its mask row -> buffer buf (one group)
template <int LT, int OPS, int NT>
__device__ __forceinline__ void load_sentence(Ops<LT, OPS>& s, const Walk& w, int b, int h,
                                              int buf) {
#pragma unroll
  for (int o = 0; o < OPS; ++o) {
    const bf16* base = w.src[o].p + (size_t)b * w.src[o].bs + h * HD;
#pragma unroll
    for (int i = threadIdx.x; i < LT * 8; i += NT) {  // 8 pieces of 16 bytes a row
      const int r = i / 8, c = (i % 8) * 8;
      const bool ok = r < w.L;
      cp16(&s.op[buf][o][r][c], base + (ok ? (size_t)r * w.src[o].rs + c : 0), ok);
    }
  }
  for (int i = threadIdx.x; i < LT; i += NT)
    cp4(&s.neg[buf][i], w.neg + (size_t)b * w.L + (i < w.L ? i : 0), i < w.L);
  cp_commit();
}

// The scores of the warp's rows times log2 e on the accumulator s (key 8 j + 2 t
// + (e & 1) of row r0 + 8 (e >> 1)), keys >= Lk at -inf; -> the row maxima
template <int LT>
__device__ __forceinline__ void scores(float (&s)[LT / 8][4], const Tiles<LT>& t, int buf,
                                       int r0, int tq, int Lk, float scale, float (&m)[2]) {
  m[0] = m[1] = -INFINITY;
#pragma unroll
  for (int j = 0; j < LT / 8; ++j) {
    const int key = 8 * j + 2 * tq;
    const float2 ng = *reinterpret_cast<const float2*>(&t.neg[buf][key]);
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const float2 bs = *reinterpret_cast<const float2*>(&t.bias[r0 + 8 * hi][key]);
      float& s0 = s[j][2 * hi];
      float& s1 = s[j][2 * hi + 1];
      s0 = key < Lk ? (s0 * scale + bs.x + ng.x) * kLog2e : -INFINITY;
      s1 = key + 1 < Lk ? (s1 * scale + bs.y + ng.y) * kLog2e : -INFINITY;
      m[hi] = fmaxf(m[hi], fmaxf(s0, s1));
    }
  }
  m[0] = quad_max(m[0]);
  m[1] = quad_max(m[1]);
}

// 16 rows x 64 of the accumulator d, rounded, into rows r0.. of tile (pitch AP)
__device__ __forceinline__ void stage(bf16* tile, int r0, const float (&d)[8][4], int g, int tq) {
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    bf16* at = tile + (r0 + g) * AP + 8 * n + 2 * tq;
    *reinterpret_cast<uint32_t*>(at) = pack_bf16(d[n][0], d[n][1]);
    *reinterpret_cast<uint32_t*>(at + 8 * AP) = pack_bf16(d[n][2], d[n][3]);
  }
}

// rows r0 .. r0 + 15 (those < L) of tile -> head h of sentence b of dst, 16-byte stores
__device__ __forceinline__ void store_rows(bf16* dst, long long bs, long long rs, int b, int h,
                                           const bf16* tile, int r0, int L, int lane) {
#pragma unroll
  for (int i = lane; i < 16 * 8; i += 32) {
    const int r = r0 + i / 8, c = (i % 8) * 8;
    if (r < L)
      *reinterpret_cast<uint4*>(dst + (size_t)b * bs + (size_t)r * rs + h * HD + c) =
          *reinterpret_cast<const uint4*>(tile + r * AP + c);
  }
}

// ---------------------------------------------------------------------------
// K15
// ---------------------------------------------------------------------------

template <int LT>
__global__ void __launch_bounds__(LT * 2)
flash_bias_fwd_small_kernel(Walk w, bf16* __restrict__ out, long long o_bs, long long o_rs) {
  constexpr int NT = LT * 2, NJ = LT / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  auto& s = *reinterpret_cast<Ops<LT, 3>*>(smem);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, tq = lane % 4;
  const int h = blockIdx.x, b0 = blockIdx.y * w.per, b_end = min(w.B, b0 + w.per);
  const int r0 = warp * 16 + g;  // this thread's query rows: r0 and r0 + 8

  if (b0 < b_end) {  // the bias tile comes in with the first sentence
    load_bias<LT, NT>(s, w, h);
    load_sentence<LT, 3, NT>(s, w, b0, h, 0);
  }
  for (int b = b0; b < b_end; ++b) {
    const int buf = (b - b0) & 1;
    cp_wait();
    __syncthreads();  // this buffer is in; every warp is done with the other one
    if (b + 1 < b_end) load_sentence<LT, 3, NT>(s, w, b + 1, h, buf ^ 1);
    bf16* Q = &s.op[buf][0][0][0];
    const bf16* K = &s.op[buf][1][0][0];
    const bf16* V = &s.op[buf][2][0][0];

    float e[NJ][4], m[2];
    product_nt<NJ>(e, Q, warp * 16, K, lane);
    scores<LT>(e, s, buf, r0, tq, w.Lk, w.scale, m);
    float l[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        e[j][i] = exp2f(e[j][i] - m[i >> 1]);  // NaN on a fully padded row, as in the contract
        l[i >> 1] += e[j][i];
      }
    l[0] = quad_sum(l[0]);
    l[1] = quad_sum(l[1]);

    float o[8][4] = {};
#pragma unroll
    for (int kk = 0; kk < NJ / 2; ++kk) {  // P.V with the unnormalised e rounded to bf16
      uint32_t a[4];
      as_a<NJ>(a, e, kk);
      product_tn(o, a, V, 16 * kk, lane);
    }
    // the warp's Q rows are spent: stage out = o / l there, then store
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      bf16* at = Q + r0 * AP + 8 * n + 2 * tq;
      *reinterpret_cast<uint32_t*>(at) = pack_bf16(o[n][0] / l[0], o[n][1] / l[0]);
      *reinterpret_cast<uint32_t*>(at + 8 * AP) =
          pack_bf16(o[n][2] / l[1], o[n][3] / l[1]);
    }
    __syncwarp();
    store_rows(out, o_bs, o_rs, b, h, Q, warp * 16, w.L, lane);
  }
}

// ---------------------------------------------------------------------------
// K16
// ---------------------------------------------------------------------------

template <int LT>
__global__ void __launch_bounds__(LT * 2)
flash_bias_bwd_small_kernel(Walk w, bf16* __restrict__ dq, bf16* __restrict__ dk,
                            bf16* __restrict__ dv, long long g_bs, long long g_rs,
                            float* __restrict__ part) {
  constexpr int NT = LT * 2, NJ = LT / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  auto& s = *reinterpret_cast<BwdSmem<LT>*>(smem);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, tq = lane % 4;
  const int h = blockIdx.x, b0 = blockIdx.y * w.per, b_end = min(w.B, b0 + w.per);
  const int r0 = warp * 16 + g;
  const bool row_ok[2] = {r0 < w.L, r0 + 8 < w.L};

  float dbias[NJ][4] = {};  // this warp's 16 x LT slice of d(bias), in sentence order
  if (b0 < b_end) {
    load_bias<LT, NT>(s, w, h);
    load_sentence<LT, 4, NT>(s, w, b0, h, 0);
  }
  for (int b = b0; b < b_end; ++b) {
    const int buf = (b - b0) & 1;
    cp_wait();
    __syncthreads();
    if (b + 1 < b_end) load_sentence<LT, 4, NT>(s, w, b + 1, h, buf ^ 1);
    bf16* Q = &s.op[buf][0][0][0];
    bf16* K = &s.op[buf][1][0][0];
    bf16* V = &s.op[buf][2][0][0];
    const bf16* dO = &s.op[buf][3][0][0];

    float p[NJ][4], m[2];
    product_nt<NJ>(p, Q, warp * 16, K, lane);
    scores<LT>(p, s, buf, r0, tq, w.Lk, w.scale, m);
    float l[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        p[j][i] = exp2f(p[j][i] - m[i >> 1]);
        l[i >> 1] += p[j][i];
      }
    l[0] = quad_sum(l[0]);
    l[1] = quad_sum(l[1]);

    float dp[NJ][4];
    product_nt<NJ>(dp, dO, warp * 16, V, lane);
    float delta[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {  // P normalised in fp32; rows >= L add nothing
        p[j][i] = row_ok[i >> 1] ? p[j][i] / l[i >> 1] : 0.f;
        delta[i >> 1] += dp[j][i] * p[j][i];
      }
    delta[0] = quad_sum(delta[0]);
    delta[1] = quad_sum(delta[1]);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float ds0 = p[j][i] * (dp[j][i] - delta[i >> 1]);
        dbias[j][i] += ds0;
        dp[j][i] = ds0 * w.scale;  // dS before its rounding
      }
      const int key = 8 * j + 2 * tq;
      *reinterpret_cast<uint32_t*>(&s.p[r0][key]) = pack_bf16(p[j][0], p[j][1]);
      *reinterpret_cast<uint32_t*>(&s.p[r0 + 8][key]) = pack_bf16(p[j][2], p[j][3]);
      *reinterpret_cast<uint32_t*>(&s.ds[r0][key]) = pack_bf16(dp[j][0], dp[j][1]);
      *reinterpret_cast<uint32_t*>(&s.ds[r0 + 8][key]) = pack_bf16(dp[j][2], dp[j][3]);
    }

    float gq[8][4] = {};  // dQ = dS K
#pragma unroll
    for (int kk = 0; kk < NJ / 2; ++kk) {
      uint32_t a[4];
      as_a<NJ>(a, dp, kk);
      product_tn(gq, a, K, 16 * kk, lane);
    }
    __syncthreads();  // bf16(P) and dS of every query row are in
    float gk[8][4] = {}, gv[8][4] = {};  // dK = dS^T Q, dV = P^T dO for keys warp * 16..
#pragma unroll
    for (int kk = 0; kk < NJ / 2; ++kk) {
      uint32_t a[4];
      ldsm_t(a, &s.ds[0][0] + across_first(lane, 16 * kk, warp * 16, LT + 8));
      product_tn(gk, a, Q, 16 * kk, lane);
      ldsm_t(a, &s.p[0][0] + across_first(lane, 16 * kk, warp * 16, LT + 8));
      product_tn(gv, a, dO, 16 * kk, lane);
    }
    __syncthreads();  // every warp is done with this buffer: stage the results in it
    stage(Q, warp * 16, gq, g, tq);
    stage(K, warp * 16, gk, g, tq);
    stage(V, warp * 16, gv, g, tq);
    __syncwarp();
    store_rows(dq, g_bs, g_rs, b, h, Q, warp * 16, w.L, lane);
    store_rows(dk, g_bs, g_rs, b, h, K, warp * 16, w.L, lane);
    store_rows(dv, g_bs, g_rs, b, h, V, warp * 16, w.L, lane);
  }

  float* dst = part + ((size_t)blockIdx.y * gridDim.x + h) * w.L * w.L;
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = r0 + 8 * (i >> 1), key = 8 * j + 2 * tq + (i & 1);
      if (row < w.L && key < w.L) dst[row * w.L + key] = dbias[j][i];
    }
}

Walk make_walk(const void* q, const void* k, const void* v, const void* dout, long long q_bs,
               long long q_rs, long long k_bs, long long k_rs, long long v_bs, long long v_rs,
               const float* bias, const float* neg, int B, int L, int H, int Lk, float scale,
               int chunks) {
  const long long d = (long long)H * HD;
  return Walk{{{static_cast<const bf16*>(q), q_bs, q_rs},
               {static_cast<const bf16*>(k), k_bs, k_rs},
               {static_cast<const bf16*>(v), v_bs, v_rs},
               {static_cast<const bf16*>(dout), d * L, d}},
              bias, neg, B, L, Lk, (B + chunks - 1) / chunks, scale};
}

template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, size_t smem, int H, int chunks, int threads, cudaStream_t stream,
                   Args... args) {
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(H, chunks), threads, smem, stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace

cudaError_t forward_bias_small(const void* q, const void* k, const void* v, long long q_bs,
                               long long q_rs, long long k_bs, long long k_rs, long long v_bs,
                               long long v_rs, const float* bias, const float* neg, void* out,
                               long long o_bs, long long o_rs, int B, int L, int H, int Lk,
                               float scale, int chunks, cudaStream_t stream) {
  if (L > kSmallL || chunks < 1 || chunks > B) return cudaErrorInvalidValue;
  const Walk w = make_walk(q, k, v, nullptr, q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, bias, neg, B, L,
                           H, Lk, scale, chunks);
  bf16* o = static_cast<bf16*>(out);
  if (L <= 32)
    return launch(flash_bias_fwd_small_kernel<32>, sizeof(Ops<32, 3>), H, chunks, 64, stream, w,
                  o, o_bs, o_rs);
  return launch(flash_bias_fwd_small_kernel<64>, sizeof(Ops<64, 3>), H, chunks, 128, stream, w, o,
                o_bs, o_rs);
}

cudaError_t backward_bias_small(const void* q, const void* k, const void* v, long long q_bs,
                                long long q_rs, long long k_bs, long long k_rs, long long v_bs,
                                long long v_rs, const float* bias, const float* neg,
                                const void* dout, void* dq, void* dk, void* dv, long long g_bs,
                                long long g_rs, float* part, int B, int L, int H, int Lk,
                                float scale, int chunks, cudaStream_t stream) {
  if (L > kSmallL || chunks < 1 || chunks > B) return cudaErrorInvalidValue;
  const Walk w = make_walk(q, k, v, dout, q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, bias, neg, B, L, H,
                           Lk, scale, chunks);
  bf16 *gq = static_cast<bf16*>(dq), *gk = static_cast<bf16*>(dk), *gv = static_cast<bf16*>(dv);
  if (L <= 32)
    return launch(flash_bias_bwd_small_kernel<32>, sizeof(BwdSmem<32>), H, chunks, 64, stream, w,
                  gq, gk, gv, g_bs, g_rs, part);
  return launch(flash_bias_bwd_small_kernel<64>, sizeof(BwdSmem<64>), H, chunks, 128, stream, w,
                gq, gk, gv, g_bs, g_rs, part);
}

}  // namespace fa
}  // namespace rz
