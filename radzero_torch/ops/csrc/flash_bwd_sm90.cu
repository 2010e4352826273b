// The bf16 backward of the unbiased attention for Hopper: K14
// flash_attention_bwd and K7 flash_attention_packed_bwd (K14 over the thirds
// of one packed buffer) call it for every bf16 operand; fp32 and the biased
// K16 stay on the bwd_*_kernel of flash_attention.cu.
//
// Replaces the TPU kernels radzero_tpu/ops/flash_attention.py _unbiased_bwd
// (_bwd_kernel, the pallas_call at :214) and radzero_tpu/ops/fused_layer.py
// _packed_vjp_bwd (_packed_attn_bwd_kernel, :281), with their contract: fp32
// scores with scale * log2(e) folded in, P rounded to bf16 before P^T dO, dO
// in bf16, dS = P (dP - delta) scale rounded to bf16 before dS K and dS^T Q,
// fp32 accumulators each rounded once, keys >= Lk masked, rows >= L not
// written. One point differs: the TPU kernel takes delta = rowsum(dP P) with
// P unrounded fp32; here delta = rowsum(dO O) over the forward's bf16 output
// (FlashAttention-2's identity), the same sum reassociated, which differs
// only by the rounding of P before P.V and of O to bf16. The plain twins keep
// the contract's delta.
//
// What bounds it on the H100: the tensor cores. The five products of the
// contract take 10 B H L^2 64 operations; these kernels do seven (S and dP
// in both), with L^2 exp2 in each. The row statistics come from the forward
// (lse = m + log2 l per query row, written by fwd_sm90_kernel), so no kernel
// recomputes them.
//
// Design: two kernels on one stream, grid (ceil(L / 128), H, B), 384
// threads: a producer warpgroup (setmaxnreg.dec; one thread issues TMA loads
// through the 4-D maps of sm90.cuh, so K7's thirds are read in place) and two
// consumer warpgroups of 64 rows each. Each block owns the rows it writes: no
// atomics, sums in a fixed order, the same bits from run to run. Inner steps
// are 64 wide so that S and dP (32 fp32 registers each) fit beside the
// accumulators under the launch bound's 168 registers (ptxas gave a
// 288-thread block with one producer warp no more: it spilled).
// - bwd_dq_sm90_kernel, one block per 128 query rows: Q, dO and O by TMA
//   once, then a ring of STAGES 128-key K / V tiles. delta = rowsum(dO O) in
//   fp32 from the swizzled O and dO tiles, written to a (B, H, L) scratch for
//   the second kernel. Per 64-key half-tile: S = Q K^T and dP = dO V^T (wgmma
//   m64n64k16, both operands in shared memory), P = exp2(S sl2 - lse) and dS
//   on the accumulator registers, dS rounded to bf16 as the register A
//   operand of dQ += dS K (K as an MN-major B operand), issued beside S and dP
//   of the next half-tile; the warpgroups take turns to issue (named
//   barriers), as in the forward. Keys >= Lk are masked by column index;
//   query rows >= L (zeros from TMA) take lse = +inf, so P = 0.
// - bwd_dkdv_sm90_kernel, one block per 128 keys: K and V by TMA once, then a
//   ring of 128-query Q / dO tiles; a second producer warp copies the tiles'
//   lse and delta rows into the ring (+inf and 0 past L). Per 64-query
//   half-tile: S^T = K Q^T and dP^T = V dO^T, P^T and dS^T on the registers,
//   dV += bf16(P^T) dO and dK += bf16(dS^T) Q with register A operands, all
//   four products waited for in turn: the products of the next half-tile
//   beside these spill at 168 registers. Without turn-taking it runs 5%
//   faster than with it (ops/ablate_sm90.py). Keys >= Lk get P^T = 0, so zero
//   dK / dV rows, written for every key < L.
// Every mbarrier wait traps after ~19 s instead of hanging the card.
#include "flash_fwd_sm90.cuh"
#include "sm90.cuh"

namespace rz {
namespace fa {
namespace {

using namespace sm90;

constexpr int SUB = 64;          // rows of an inner step: half a TMA tile
constexpr int STAGES = 4;        // ring tiles in flight
constexpr int THREADS = 384;     // producer warpgroup + two consumer warpgroups
constexpr int ROW_BYTES = HD * 2;
// dQ kernel: Q, dO, O, then K and V of each stage, then the barriers
constexpr int DQ_BAR = TILE * (3 + 2 * STAGES);
constexpr size_t DQ_SMEM = DQ_BAR + 8 * (1 + 2 * STAGES) + 1024;  // + room to align to 1024
// dK/dV kernel: K, V, then Q and dO of each stage, lse and delta rows of each
// stage (2 BOX floats), then the barriers
constexpr int KV_ROWS = TILE * (2 + 2 * STAGES);
constexpr int KV_BAR = KV_ROWS + STAGES * 2 * BOX * 4;
constexpr size_t KV_SMEM = KV_BAR + 8 * (1 + 2 * STAGES) + 1024;

// issue acc (64 x 64) = A (this warpgroup's 64 rows, smem, K-major) . B^T (B:
// 64 rows, smem, K-major): four m64n64k16 over the head dim. No fence or commit.
__device__ __forceinline__ void issue_ss(float (&acc)[32], uint32_t sa, uint32_t sb) {
  const uint64_t da = desc(sa, 1, 64), db = desc(sb, 1, 64);
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) wgmma_ss_n64(acc, da + 2 * kk, db + 2 * kk, kk);
}

// issue acc (64 x 64) += A (64 x 64 bf16, registers) . B (64 rows, smem,
// MN-major): four m64n64k16 over B's rows. No fence or commit.
__device__ __forceinline__ void issue_rs(float (&acc)[32], const uint32_t (&a)[16], uint32_t sb) {
  const uint64_t db = desc(sb, 64, 64);
#pragma unroll
  for (int kk = 0; kk < SUB / 16; ++kk) wgmma_rs_n64(acc, a + 4 * kk, db + 128 * kk);
}

// a 64 x 64 fp32 accumulator in bf16 as the A fragments of four k-steps of 16
// columns, 4 registers each: the accumulator's (row, column pair) layout is
// the A operand's
__device__ __forceinline__ void pack_a(const float (&acc)[32], uint32_t (&a)[16]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      a[4 * (j / 2) + 2 * (j % 2) + i] = pack_bf16(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
}

// dS of one 64-key half-tile of the dQ kernel, in place of S: rows lane / 4
// (+ 8) with their lse and delta, keys k0 + 8 j + 2 quad (+ 1), masked >= Lk
__device__ __forceinline__ void ds_rows(float (&s)[32], const float (&dp)[32], int k0, int Lk,
                                        int quad, float sl2, float scale, const float (&lse)[2],
                                        const float (&dl)[2]) {
  const bool edge = k0 + SUB > Lk;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int x = 4 * j + 2 * i + e;
        float p = ex2(fmaf(s[x], sl2, -lse[i]));
        if (edge && k0 + 8 * j + 2 * quad + e >= Lk) p = 0.f;
        s[x] = p * (dp[x] - dl[i]) * scale;
      }
}

// P^T and dS^T of one 64-query half-tile of the dK/dV kernel, in place of S^T
// and dP^T: rows are keys (dead: >= Lk), columns queries 8 j + 2 quad (+ 1)
// with their lse and delta at st[c], st[BOX + c]
__device__ __forceinline__ void ds_cols(float (&s)[32], float (&dp)[32], const float* st,
                                        const bool (&dead)[2], int quad, float sl2, float scale) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 lz = *reinterpret_cast<const float2*>(st + 8 * j + 2 * quad);
    const float2 dz = *reinterpret_cast<const float2*>(st + BOX + 8 * j + 2 * quad);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int x = 4 * j + 2 * i + e;
        const float p = dead[i] ? 0.f : ex2(fmaf(s[x], sl2, -(e ? lz.y : lz.x)));
        s[x] = p;
        dp[x] = p * (dp[x] - (e ? dz.y : dz.x)) * scale;
      }
  }
}

// rows r0 + 8 i (i = 0, 1) of a 64-column fp32 accumulator in bf16 -> dst
// rows of stride rs, rows >= lim not written
__device__ __forceinline__ void store_rows(const float (&acc)[32], __nv_bfloat16* dst,
                                           long long rs, int r0, int lim, int quad) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + 8 * i;
    if (row >= lim) continue;
    __nv_bfloat16* d = dst + (size_t)row * rs + 2 * quad;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<uint32_t*>(d + 8 * j) = pack_bf16(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
  }
}

__global__ void __launch_bounds__(THREADS, 1)
bwd_dq_sm90_kernel(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
                   const __grid_constant__ CUtensorMap mv, const __grid_constant__ CUtensorMap mo,
                   const __grid_constant__ CUtensorMap mdo, const float* __restrict__ lse,
                   float* __restrict__ delta, __nv_bfloat16* __restrict__ dq, long long g_bs,
                   long long g_rs, int L, int Lk, float sl2, float scale) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const unsigned char* gen = smem_raw + (base - raw);  // base as a generic pointer
  const uint32_t sQ = base, sdO = base + TILE, sO = base + 2 * TILE;
  const uint32_t bar_q = base + DQ_BAR;  // then full[STAGES], empty[STAGES]
  const int q0 = blockIdx.x * BOX, h = blockIdx.y, b = blockIdx.z;
  const size_t srow = ((size_t)b * gridDim.y + h) * L;
  const int ntiles = (Lk + BOX - 1) / BOX, nsub = (Lk + SUB - 1) / SUB;
  auto full = [&](int t) { return bar_q + 8 * (1 + t % STAGES); };
  auto empty = [&](int t) { return bar_q + 8 * (1 + STAGES + t % STAGES); };
  auto sK = [&](int t) { return base + TILE * (3 + 2 * (t % STAGES)); };  // V at + TILE

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
      bar_expect_tx(bar_q, 3 * TILE);
      tma_load(sQ, &mq, bar_q, h, q0, b);
      tma_load(sdO, &mdo, bar_q, h, q0, b);
      tma_load(sO, &mo, bar_q, h, q0, b);
      for (int t = 0; t < ntiles; ++t) {
        bar_wait(empty(t), ((t / STAGES) & 1) ^ 1);  // stage released by both consumers
        bar_expect_tx(full(t), 2 * TILE);
        tma_load(sK(t), &mk, full(t), h, t * BOX, b);
        tma_load(sK(t) + TILE, &mv, full(t), h, t * BOX, b);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
  const int ct = threadIdx.x - 128;
  const int wg = ct / 128, warp = (ct % 128) / 32, lane = ct % 32, quad = lane % 4;
  const int r0 = wg * 64 + warp * 16 + lane / 4;  // this thread's rows r0, r0 + 8 of the tile
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + r0 + 8 * i;
    lse_r[i] = row < L ? lse[srow + row] : INFINITY;  // rows >= L: P = 0
  }
  const int turn = 1 + wg, pass = 2 - wg;
  if (wg == 1) named_arrive(pass);

  bar_wait(bar_q, 0);
  // delta = rowsum(dO O) in fp32: the thread's two 16-byte chunks of each of
  // its rows (chunk c of row r lies at c ^ (r % 8) under the 128-byte
  // swizzle), then the quad, in a fixed order
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 8 * i;
    float acc = 0.f;
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int off = r * ROW_BYTES + (((2 * quad + c) ^ (r & 7)) * 16);
      const uint4 g4 = *reinterpret_cast<const uint4*>(gen + TILE + off);
      const uint4 o4 = *reinterpret_cast<const uint4*>(gen + 2 * TILE + off);
      const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&g4);
      const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&o4);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 gf = __bfloat1622float2(g2[e]), of = __bfloat1622float2(o2[e]);
        acc = fmaf(gf.x, of.x, acc);
        acc = fmaf(gf.y, of.y, acc);
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    delta_r[i] = acc;
    if (quad == 0 && q0 + r < L) delta[srow + q0 + r] = acc;
  }

  const uint32_t qa = sQ + wg * 64 * ROW_BYTES, ga = sdO + wg * 64 * ROW_BYTES;
  auto kh = [&](int j) { return sK(j / 2) + (j % 2) * SUB * ROW_BYTES; };  // K of half-tile j
  float dqa[32];  // dQ: rows lane / 4 (+ 8), columns 8 j + 2 quad (+ 1): dqa[4 j + 2 i + e]
#pragma unroll
  for (int i = 0; i < 32; ++i) dqa[i] = 0.f;
  float s[32], dp[32];  // S then dS, and dP, of the current half-tile
  uint32_t da[16];      // dS of the previous half-tile in bf16, the A operand of its dS K

  bar_wait(full(0), 0);
  named_sync(turn);
  wg_fence();
  issue_ss(s, qa, kh(0));
  issue_ss(dp, ga, kh(0) + TILE);
  wg_commit();
  named_arrive(pass);
  wg_wait_all();
  pin(s);
  pin(dp);
  ds_rows(s, dp, 0, Lk, quad, sl2, scale, lse_r, delta_r);
  pack_a(s, da);
  // half-tile j: S and dP of j run beside dQ += dS K of j - 1, dS of j beside that product
  for (int j = 1; j < nsub; ++j) {
    if (j % 2 == 0) bar_wait(full(j / 2), (j / 2 / STAGES) & 1);
    named_sync(turn);
    wg_fence();
    issue_ss(s, qa, kh(j));
    issue_ss(dp, ga, kh(j) + TILE);
    wg_commit();
    issue_rs(dqa, da, kh(j - 1));
    wg_commit();
    named_arrive(pass);
    wg_wait_one();  // S and dP of j are in
    pin(s);
    pin(dp);
    ds_rows(s, dp, j * SUB, Lk, quad, sl2, scale, lse_r, delta_r);
    wg_wait_all();  // dS K of j - 1 is in: da is free, and at even j the tile of j - 2, j - 1
    pin(dqa);
    hold(da);
    if (j % 2 == 0) bar_arrive(empty(j / 2 - 1));
    pack_a(s, da);
  }
  named_sync(turn);
  wg_fence();
  issue_rs(dqa, da, kh(nsub - 1));
  wg_commit();
  if (wg == 0) named_arrive(pass);  // warpgroup 1 takes its last turn; nothing follows it
  wg_wait_all();
  pin(dqa);

  store_rows(dqa, dq + (size_t)b * g_bs + h * HD, g_rs, q0 + r0, L, quad);
}

__global__ void __launch_bounds__(THREADS, 1)
bwd_dkdv_sm90_kernel(const __grid_constant__ CUtensorMap mq,
                     const __grid_constant__ CUtensorMap mk,
                     const __grid_constant__ CUtensorMap mv,
                     const __grid_constant__ CUtensorMap mdo, const float* __restrict__ lse,
                     const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
                     __nv_bfloat16* __restrict__ dv, long long g_bs, long long g_rs, int L, int Lk,
                     float sl2, float scale) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  float* rows = reinterpret_cast<float*>(smem_raw + (base - raw) + KV_ROWS);  // lse, delta
  const uint32_t sK = base, sV = base + TILE;
  const uint32_t bar_kv = base + KV_BAR;  // then full[STAGES], empty[STAGES]
  const int k0 = blockIdx.x * BOX, h = blockIdx.y, b = blockIdx.z;
  const size_t srow = ((size_t)b * gridDim.y + h) * L;
  const int ntiles = (L + BOX - 1) / BOX, nsub = (L + SUB - 1) / SUB;
  auto full = [&](int t) { return bar_kv + 8 * (1 + t % STAGES); };
  auto empty = [&](int t) { return bar_kv + 8 * (1 + STAGES + t % STAGES); };
  auto sQ = [&](int t) { return base + TILE * (2 + 2 * (t % STAGES)); };  // dO at + TILE
  auto stats = [&](int t) { return rows + (t % STAGES) * 2 * BOX; };

  if (threadIdx.x == 0) {
    bar_init(bar_kv, 1);
    for (int s = 0; s < STAGES; ++s) {
      bar_init(full(s), 1 + 32);  // the TMA thread and the 32 lanes of the row copier
      bar_init(empty(s), CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // producer warpgroup: the TMA thread and the row copier
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x == 0) {
      bar_expect_tx(bar_kv, 2 * TILE);
      tma_load(sK, &mk, bar_kv, h, k0, b);
      tma_load(sV, &mv, bar_kv, h, k0, b);
      for (int t = 0; t < ntiles; ++t) {
        bar_wait(empty(t), ((t / STAGES) & 1) ^ 1);  // stage released by both consumers
        bar_expect_tx(full(t), 2 * TILE);
        tma_load(sQ(t), &mq, full(t), h, t * BOX, b);
        tma_load(sQ(t) + TILE, &mdo, full(t), h, t * BOX, b);
      }
    } else if (threadIdx.x / 32 == 1) {  // lse and delta rows of each query tile
      const int lane = threadIdx.x % 32;
      for (int t = 0; t < ntiles; ++t) {
        bar_wait(empty(t), ((t / STAGES) & 1) ^ 1);
        float* st = stats(t);
#pragma unroll
        for (int r = 0; r < BOX / 32; ++r) {
          const int c = 32 * r + lane, q = t * BOX + c;
          st[c] = q < L ? lse[srow + q] : INFINITY;  // queries >= L: P = 0
          st[BOX + c] = q < L ? delta[srow + q] : 0.f;
        }
        bar_arrive(full(t));
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
  const int ct = threadIdx.x - 128;
  const int wg = ct / 128, warp = (ct % 128) / 32, lane = ct % 32, quad = lane % 4;
  const int r0 = wg * 64 + warp * 16 + lane / 4;  // this thread's keys k0 + r0 (+ 8)
  const bool dead[2] = {k0 + r0 >= Lk, k0 + r0 + 8 >= Lk};
  const uint32_t ka = sK + wg * 64 * ROW_BYTES, va = sV + wg * 64 * ROW_BYTES;

  float dka[32], dva[32];  // dK, dV: rows keys, columns 8 j + 2 quad (+ 1) of the head dim
#pragma unroll
  for (int i = 0; i < 32; ++i) dka[i] = dva[i] = 0.f;
  float s[32], dp[32];     // S^T then P^T, dP^T then dS^T: columns queries
  uint32_t pa[16], da[16];  // P^T and dS^T in bf16, the A operands of the two products

  bar_wait(bar_kv, 0);
  for (int j = 0; j < nsub; ++j) {
    const int t = j / 2;
    if (j % 2 == 0) bar_wait(full(t), (t / STAGES) & 1);
    const uint32_t qb = sQ(t) + (j % 2) * SUB * ROW_BYTES, gb = qb + TILE;
    wg_fence();
    issue_ss(s, ka, qb);
    issue_ss(dp, va, gb);
    wg_commit();
    wg_wait_all();
    pin(s);
    pin(dp);
    ds_cols(s, dp, stats(t) + (j % 2) * SUB, dead, quad, sl2, scale);
    pack_a(s, pa);
    pack_a(dp, da);
    wg_fence();
    issue_rs(dva, pa, gb);
    issue_rs(dka, da, qb);
    wg_commit();
    wg_wait_all();
    pin(dva);
    pin(dka);
    hold(pa);
    hold(da);
    if (j % 2 == 1) bar_arrive(empty(t));
  }

  store_rows(dka, dk + (size_t)b * g_bs + h * HD, g_rs, k0 + r0, L, quad);
  store_rows(dva, dv + (size_t)b * g_bs + h * HD, g_rs, k0 + r0, L, quad);
}

}  // namespace

cudaError_t backward_sm90(const void* q, const void* k, const void* v, long long q_bs,
                          long long q_rs, long long k_bs, long long k_rs, long long v_bs,
                          long long v_rs, const void* out, const void* dout, const float* lse,
                          float* delta, void* dq, void* dk, void* dv, long long g_bs,
                          long long g_rs, int B, int L, int H, int Lk, float scale,
                          cudaStream_t stream) {
  const long long rs = (long long)H * HD, bs = rs * L;  // out and dout: contiguous
  CUtensorMap mq, mk, mv, mo, mdo;
  if (!make_map(&mq, q, q_bs, q_rs, B, L, H) || !make_map(&mk, k, k_bs, k_rs, B, L, H) ||
      !make_map(&mv, v, v_bs, v_rs, B, L, H) || !make_map(&mo, out, bs, rs, B, L, H) ||
      !make_map(&mdo, dout, bs, rs, B, L, H))
    return cudaErrorInvalidValue;
  const dim3 grid((L + BOX - 1) / BOX, H, B);
  const float sl2 = scale * kLog2e;
  cudaError_t err = allow_smem(bwd_dq_sm90_kernel, DQ_SMEM);
  if (err != cudaSuccess) return err;
  bwd_dq_sm90_kernel<<<grid, THREADS, DQ_SMEM, stream>>>(
      mq, mk, mv, mo, mdo, lse, delta, static_cast<__nv_bfloat16*>(dq), g_bs, g_rs, L, Lk, sl2,
      scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = allow_smem(bwd_dkdv_sm90_kernel, KV_SMEM)) != cudaSuccess) return err;
  bwd_dkdv_sm90_kernel<<<grid, THREADS, KV_SMEM, stream>>>(
      mq, mk, mv, mdo, lse, delta, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), g_bs, g_rs, L, Lk, sl2, scale);
  return cudaGetLastError();
}

}  // namespace fa
}  // namespace rz
