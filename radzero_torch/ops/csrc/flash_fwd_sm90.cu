// The bf16 forward of the unbiased attention for Hopper: K13 flash_attention
// and K2 flash_attention_packed (K13 over the thirds of one packed buffer)
// call it for every bf16 operand; fp32 and the biased K15 stay on fwd_kernel
// of flash_attention.cu.
//
// Replaces the TPU kernels radzero_tpu/ops/flash_attention.py _forward
// (_kernel, the pallas_call at :122) and radzero_tpu/ops/fused_layer.py
// flash_attention_packed (_packed_attn_kernel, :175), with their contract:
// fp32 scores, exp2 with scale * log2(e) folded into the score, the running
// maximum always subtracted (0 while it is -inf), the row sum over the
// unrounded fp32 weights, the weights rounded to bf16 before P.V, the
// division deferred to the output, keys >= Lk masked, every query row
// computed and rows >= L not written.
//
// What bounds it on the H100: the math units. Per (image, head) it does
// 4 L^2 64 operations on the tensor cores and L^2 exp2 on the SFU; at head
// dim 64 the two take about the same time on this card (989 TFLOP/s of bf16
// against 16 ex2 a clock per SM), so the softmax has to stay out of shared
// memory and off the tensor cores' path. What holds it back today is the
// latency of each warpgroup's softmax (removing every product leaves the
// time unchanged; removing the softmax cuts a third).
//
// Design (one block per 128 query rows of one (image, head); grid
// (ceil(L / 128), H, B), 384 threads):
// - Warpgroup 0 is the producer: setmaxnreg hands its registers to the
//   consumers, and one thread issues TMA loads (cp.async.bulk.tensor) of Q
//   once and of K and V into a ring of STAGES 128-key tiles, each stage with
//   a full and an empty mbarrier. The tensor maps are 4-D (64, H, L, B) with
//   the operands' strides, so the thirds of a packed buffer need no copy;
//   rows past L come in as zeros. Every tile is 128 rows of 128 bytes under
//   the 128-byte swizzle, 1024-byte aligned.
// - Warpgroups 1 and 2 are consumers, 64 query rows each. S = Q K^T is four
//   wgmma m64n128k16 with both operands in shared memory (K-major); the
//   online softmax runs on the accumulator registers: a thread holds two
//   rows, the row maximum takes two shuffles within a quad, the row sum stays
//   a per-thread partial until the end. P is rounded to bf16 in registers and
//   is the register A operand of eight wgmma m64n64k16 with V from shared
//   memory as an MN-major B operand; the fp32 O accumulator stays in
//   registers and is rescaled by alpha per row. Keys >= Lk (the ragged last
//   tile, kv_len, the zero rows TMA adds) are masked by column index.
// - Overlap: S of tile t is issued with P.V of t - 1, and the softmax of t
//   runs while P.V of t - 1 is on the tensor cores; the two warpgroups take
//   turns to issue (named barriers), so one's softmax meets the other's
//   products. ptxas holds the consumers to the launch bound's 168 registers
//   (S 64, O 32, P 32 live at once): a second S accumulator, to issue S of
//   t + 1 before the softmax of t, spills.
// - The epilogue divides by the row sum, rounds to bf16 and writes by stride;
//   with a non-null lse (an instantiation of its own, so that the forward
//   without it keeps its code) it also writes m + log2(l) per real row, the row
//   statistic the Hopper backward (flash_bwd_sm90.cu) reads instead of
//   recomputing it: P = exp2(s sl2 - lse).
#include "flash_fwd_sm90.cuh"
#include "sm90.cuh"

namespace rz {
namespace fa {
namespace {

using namespace sm90;

constexpr int BM = 128;          // query rows of a block, two consumer warpgroups of 64
constexpr int BN = BOX;          // keys of a tile
constexpr int STAGES = 4;        // K / V tiles in flight
constexpr int THREADS = 384;     // producer warpgroup + two consumer warpgroups
constexpr int BAR_OFF = TILE * (1 + 2 * STAGES);  // Q, then K and V of each stage
constexpr size_t SMEM = BAR_OFF + 8 * (1 + 2 * STAGES) + 1024;  // + room to align to 1024

// issue S = Q K^T of one tile (async): four m64n128k16 over the head dim
__device__ __forceinline__ void issue_scores(float (&acc)[64], uint64_t dq, uint32_t sK) {
  wg_fence();
  const uint64_t dk = desc(sK, 1, 64);
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) wgmma_ss_n128(acc, dq + 2 * kk, dk + 2 * kk, kk);
  wg_commit();
}

// O = alpha O, then issue O += P V of one tile (async): eight m64n64k16 over the keys
__device__ __forceinline__ void issue_pv(float (&o)[32], const uint32_t (&pa)[32],
                                         const float (&alpha)[2], uint32_t sV) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      o[4 * j + 2 * i] *= alpha[i];
      o[4 * j + 2 * i + 1] *= alpha[i];
    }
  pin(o);
  wg_fence();
  const uint64_t dv = desc(sV, 64, 64);
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) wgmma_rs_n64(o, pa + 4 * kk, dv + 128 * kk);
  wg_commit();
}

// the online softmax of one tile on the score registers, in place: keys >= Lk
// masked, the running maximum m (scaled) and partial row sum l moved on, alpha
// = exp2(m_old - m_new), and acc[x] = exp2(acc[x] sl2 - m_new) in fp32
__device__ __forceinline__ void softmax(float (&acc)[64], int k0, int Lk, int quad, float sl2,
                                        float (&m)[2], float (&l)[2], float (&alpha)[2]) {
  if (k0 + BN > Lk) {  // the last tile: keys >= Lk (kv_len, ragged tail, TMA's zero rows)
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (k0 + 8 * j + 2 * quad + e >= Lk) acc[4 * j + e] = acc[4 * j + 2 + e] = -INFINITY;
  }
  // the reductions of a row run as four (max) and eight (sum) independent
  // chains: with two consumer warps on a scheduler, a 32-long chain of
  // dependent max or add would stall it
  float mx[2][4], ps[2][8];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      mx[i][c] = fmaxf(acc[4 * c + 2 * i], acc[4 * c + 2 * i + 1]);
#pragma unroll
      for (int j = c + 4; j < 16; j += 4)
        mx[i][c] = fmaxf(mx[i][c], fmaxf(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]));
    }
  float mu[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float r = fmaxf(fmaxf(mx[i][0], mx[i][1]), fmaxf(mx[i][2], mx[i][3]));
    r = fmaxf(r, __shfl_xor_sync(0xffffffffu, r, 1));
    r = fmaxf(r, __shfl_xor_sync(0xffffffffu, r, 2));
    const float m_new = fmaxf(m[i], r * sl2);           // sl2 > 0: max of the scaled scores
    mu[i] = m_new == -INFINITY ? 0.f : m_new;            // a fully masked row so far: shift by 0
    alpha[i] = ex2(m[i] - mu[i]);                        // 0 while m is -inf
    m[i] = m_new;
  }
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float p = ex2(fmaf(acc[4 * j + 2 * i + e], sl2, -mu[i]));
        acc[4 * j + 2 * i + e] = p;
        const int c = 2 * (j % 4) + e;
        ps[i][c] = j < 4 ? p : ps[i][c] + p;
      }
#pragma unroll
  for (int i = 0; i < 2; ++i)
    l[i] = l[i] * alpha[i] + (((ps[i][0] + ps[i][1]) + (ps[i][2] + ps[i][3])) +
                              ((ps[i][4] + ps[i][5]) + (ps[i][6] + ps[i][7])));
}

// P in bf16 as the A fragments of 8 k-steps of 16 keys, 4 registers each: the
// accumulator's (row, key pair) layout is the A operand's
__device__ __forceinline__ void pack_p(const float (&acc)[64], uint32_t (&pa)[32]) {
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      pa[4 * (j / 2) + 2 * (j % 2) + i] = pack_bf16(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
}

// LSE: also write lse (serving and the scorer run the instantiation without it)
template <bool LSE>
__global__ void __launch_bounds__(THREADS, 1)
fwd_sm90_kernel(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
                const __grid_constant__ CUtensorMap mv, __nv_bfloat16* __restrict__ out,
                long long o_bs, long long o_rs, float* __restrict__ lse, int L, int Lk,
                float sl2) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base;
  const uint32_t bar_q = base + BAR_OFF;  // then full[STAGES], empty[STAGES]
  const int q0 = blockIdx.x * BM, h = blockIdx.y, b = blockIdx.z;
  const int ntiles = (Lk + BN - 1) / BN;
  auto full = [&](int t) { return bar_q + 8 * (1 + t % STAGES); };
  auto empty = [&](int t) { return bar_q + 8 * (1 + STAGES + t % STAGES); };
  auto sK = [&](int t) { return base + TILE * (1 + 2 * (t % STAGES)); };

  if (threadIdx.x == 0) {
    bar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      bar_init(full(s), 1);
      bar_init(empty(s), CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // producer warpgroup: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x == 0) {
      bar_expect_tx(bar_q, TILE);
      tma_load(sQ, &mq, bar_q, h, q0, b);
      for (int t = 0; t < ntiles; ++t) {
        bar_wait(empty(t), ((t / STAGES) & 1) ^ 1);  // stage released by both consumers
        bar_expect_tx(full(t), 2 * TILE);
        tma_load(sK(t), &mk, full(t), h, t * BN, b);
        tma_load(sK(t) + TILE, &mv, full(t), h, t * BN, b);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
  const int ct = threadIdx.x - 128;
  const int wg = ct / 128, warp = (ct % 128) / 32, lane = ct % 32, quad = lane % 4;
  const uint64_t dq = desc(sQ + wg * 64 * 128, 1, 64);  // this warpgroup's 64 query rows
  // The warpgroups take turns to issue their products (warpgroup 0 first), so
  // one's softmax runs while the tensor cores work on the other's products.
  const int turn = 1 + wg, pass = 2 - wg;
  if (wg == 1) named_arrive(pass);

  float o[32];  // O: rows lane / 4 (+ 8), columns 8 j + 2 quad (+ 1): o[4 j + 2 i + e]
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // scaled running max, partial sum
  float alpha[2];
  float acc[64];    // S, then P in fp32: rows lane / 4 (+ 8), keys 8 j + 2 quad (+ 1)
  uint32_t pa[32];  // P of the previous tile in bf16, the A operand of its P.V

  bar_wait(bar_q, 0);
  bar_wait(full(0), 0);
  named_sync(turn);
  issue_scores(acc, dq, sK(0));
  named_arrive(pass);
  wg_wait_all();
  pin(acc);
  softmax(acc, 0, Lk, quad, sl2, m, l, alpha);
  pack_p(acc, pa);
  // tile t: S of t runs beside P.V of t - 1, the softmax of t beside that P.V
  for (int t = 1; t < ntiles; ++t) {
    bar_wait(full(t), (t / STAGES) & 1);
    named_sync(turn);
    issue_scores(acc, dq, sK(t));
    issue_pv(o, pa, alpha, sK(t - 1) + TILE);
    named_arrive(pass);
    wg_wait_one();  // S of t is in
    pin(acc);
    softmax(acc, t * BN, Lk, quad, sl2, m, l, alpha);
    wg_wait_all();  // P.V of t - 1 is in: its P registers and stage are free
    pin(o);
    hold(pa);
    bar_arrive(empty(t - 1));
    pack_p(acc, pa);
  }
  named_sync(turn);
  issue_pv(o, pa, alpha, sK(ntiles - 1) + TILE);
  if (wg == 0) named_arrive(pass);  // warpgroup 1 takes its last turn; nothing follows it
  wg_wait_all();
  pin(o);

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float li = l[i];
    li += __shfl_xor_sync(0xffffffffu, li, 1);
    li += __shfl_xor_sync(0xffffffffu, li, 2);
    const int row = q0 + wg * 64 + warp * 16 + lane / 4 + 8 * i;
    if (row >= L) continue;
    if (LSE && quad == 0)  // the backward's row statistic, in the log2 domain
      lse[((size_t)b * gridDim.y + h) * L + row] = m[i] + log2f(li);
    __nv_bfloat16* dst = out + (size_t)b * o_bs + (size_t)row * o_rs + h * HD + 2 * quad;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const uint32_t v = pack_bf16(o[4 * j + 2 * i] / li, o[4 * j + 2 * i + 1] / li);
      *reinterpret_cast<uint32_t*>(dst + 8 * j) = v;
    }
  }
}

}  // namespace

cudaError_t forward_sm90(const void* q, const void* k, const void* v, long long q_bs,
                         long long q_rs, long long k_bs, long long k_rs, long long v_bs,
                         long long v_rs, void* out, long long o_bs, long long o_rs, float* lse,
                         int B, int L, int H, int Lk, float scale, cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  if (!make_map(&mq, q, q_bs, q_rs, B, L, H) || !make_map(&mk, k, k_bs, k_rs, B, L, H) ||
      !make_map(&mv, v, v_bs, v_rs, B, L, H))
    return cudaErrorInvalidValue;
  const auto kernel = lse != nullptr ? fwd_sm90_kernel<true> : fwd_sm90_kernel<false>;
  cudaError_t err = allow_smem(kernel, SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((L + BM - 1) / BM, H, B);
  kernel<<<grid, THREADS, SMEM, stream>>>(mq, mk, mv, static_cast<__nv_bfloat16*>(out), o_bs, o_rs,
                                          lse, L, Lk, scale * kLog2e);
  return cudaGetLastError();
}

}  // namespace fa
}  // namespace rz
