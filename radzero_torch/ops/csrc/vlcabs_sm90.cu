// The bf16 VL-CABS kernels for Hopper: the forward of K5 vlcabs_fused and
// K10 vlcabs_train_forward (below), and the first phase of the backward,
// which K12 vlcabs_train_bwd_dtn and K11 vlcabs_train_bwd_dq share.
//
// K5 / K10 replace the TPU kernels radzero_tpu/ops/pallas_vlcabs.py
// vlcabs_fused (_kernel, the pallas_call at :115) and _train_forward
// (_kernel_fwd_logits, :310), with their contract: per image b, tn =
// t rsqrt(sum t^2 + 1e-24) rounded, s = qn . tn^T / tau in fp32 (columns past
// L out of the row max), e = exp(s - rowmax(s)) rounded to bf16, g = e . tn
// summed in fp32, logit = qn . g / max(|g|, 1e-12); K5 also returns s as the
// map, K10 under autograd the row max and g, which K11 and K12 read.
//
// What bounds them on the H100: at the training step (N 512, B 64, L 1370,
// D 768) the two products, 4 N L D B = 138 GFLOP, 0.14 ms at 989 TFLOP/s; at
// serving's 14 prompts x 8 images the bytes, s (0.6 MB) and the tokens (17
// MB), 0.005 ms. The TPU kernels hold an image's whole token set and its
// (N, L) scores in VMEM, one grid step an image; here that is 8 blocks at
// serving's shape, each walking 1370 tokens. So the forward is split over
// tokens into five launches, each with work for every SM:
// - rownorm_kernel (vlcabs_train.cu) writes tn once, bf16 (B, L, D);
// - phase 1 (vlc_scores_sm90_kernel, here) runs over (image, 128-query,
//   128-token) work items, a persistent block an SM: a producer warp keeps a
//   ring of five 32 KB stages in flight by TMA (qn and tn as stored, K-major,
//   tn through a 3-D map with an image coordinate so that rows past an image
//   come in as zeros), each consumer warpgroup accumulates its 64 queries'
//   S = qn . tn^T on wgmma m64n128k16 (a warpgroup whose queries all lie past
//   N issues none) and, on the accumulators, takes s = S / tau and the
//   maximum of each row over the item's real tokens into tmax (B, N,
//   ceil(L / 128)), and stages s in shared memory, whence one thread stores
//   it by TMA into s (B, N, Lp), Lp L rounded up to 64 (zeros in [L, Lp):
//   the tokens there come in as zeros), while the warpgroup goes on to its
//   next item (a row of L = 1370 fp32 values is no multiple of 16 bytes, so
//   TMA cannot store into an unpadded map; stores from the registers, which
//   no product overlaps, took phase 1 0.237-0.241 ms against 0.169-0.172 at
//   the training step's shape on an H100 80GB HBM3 at 700 W);
// - the row pass (vlc_exp_rows_kernel, here), a warp a row of e (B, Np, Lp),
//   Np N rounded up to 64: the row max from the tile maxima, e = exp2((s -
//   m) log2 e) rounded to bf16, zeros past L and in the rows past N, so phase
//   2 reads nothing uninitialised, and the row max (B, N); for K5 also the
//   map, s without its padding, (B, N, L) fp32;
// - phase 2, g[b] = e[b] . tn[b] on gemm_sm90_kernel<EPI_F32, GEMM_BFWD>
//   (gemm_sm90.cu), written once in fp32;
// - vlc_logits_kernel (vlcabs_train.cu), a warp an (image, query): z = qn . g
//   / max(|g|, 1e-12) with the backward's row pass's arithmetic and order, so
//   the forward's logit and the backward's z have the same bits.
// Nothing is summed across blocks: a second call gives the same bits.
//
// K12 computes the gradient of the normalised tokens in two phases, after the
// backward's row pass of vlcabs_train.cu (dg from the forward's g) and with
// the forward's row max. Its first phase also serves K11 (dq, dtau): K11's
// dc is the dc it writes, and its epilogue adds up K11's dtau.
//
// K12 replaces the TPU kernel radzero_tpu/ops/pallas_vlcabs.py _train_bwd's
// second pallas_call (_kernel_bwd_dtn, :403), and phase 1 the S, dE and dtau
// of its first (_kernel_bwd_dq, :381: dtau = -sum dc (s - rowmax) with dc
// unrounded; K11's dq = sum_b dc tn + dz ghat is gemm_sm90.cu's, over the dc
// rows written here), with K12's contract: per image
// b, s = qn . tn^T / tau and de = dg . tn^T in fp32, e = exp(s - rowmax(s)),
// dc = de e / tau, dtn = dc^T . qn + e^T . dg, e and dc rounded to bf16
// before their products (e unrounded inside dc), dtn summed in fp32 and
// rounded once.
//
// What bounds it on the H100: the tensor cores. Its four products are
// 8 N L D B operations (276 GFLOP at N 512, B 64, L 1370, D 768: 0.28 ms at
// 989 TFLOP/s) over ~0.3 GB of operands. Why two phases: dtn for a 64-token
// tile over D = 768 is a 192 KB fp32 accumulator, three quarters of an SM's
// registers before S and dE, and slicing D across blocks would recompute S
// and dE once a slice. So:
// - Phase 1 (vlc_dtn_phase1_sm90_kernel, here) writes e and dc of every
//   (query, token) pair once, in bf16, into ce (B, 2 Np, Lp): image b's dc
//   in rows [0, Np), its e in rows [Np, 2 Np); Np and Lp are N and L rounded
//   up to 64, and the rows past N and the columns past L hold zeros. The
//   persistent grid (one 288-thread block an SM) walks (image, 64-query,
//   128-token) output tiles, tokens fastest. A producer warp keeps a ring of
//   five 32 KB stages in flight by TMA, each a 64-deep k-step of D: 128 rows
//   of tn and 64 rows each of qn and dg, all read as stored (K-major, 3-D
//   maps with an image coordinate, so rows past an image's end come in as
//   zeros). Consumer warpgroup 0 accumulates S = qn . tn^T and warpgroup 1
//   dE = dg . tn^T, each wgmma m64n128k16 into 64 fp32 registers a thread,
//   one accumulator each rather than two m64n64 ones. In the epilogue
//   warpgroup 0 computes e in fp32 from S and the forward's row max, masks
//   the rows past N and the columns past L to zero, hands e in fp32 to
//   warpgroup 1 through shared memory (the two share the accumulator layout,
//   so a thread's value i goes to word i of its own column) and stages e in
//   bf16; warpgroup 1 stages dc = dE e / tau. Each stores its 64 x 128 tile
//   by TMA, e rows after the dc rows, and goes on while the store drains.
//   For K11 (dtau_slots non-null) warpgroup 1 also writes its fp32 dc back
//   into the exchange word it read e from, and after one more barrier
//   warpgroup 0, which still holds S, adds dc (S / tau - rowmax) over its
//   values, then the warp's lanes by shuffles, then its four warps in order,
//   one store a work item into dtau_slots: no atomics. Past N and L dc is 0
//   and S / tau - rowmax finite (those rows and tokens came in as zeros and
//   the row max is 0 past N), so no 0 * inf arises. Shared memory holds no
//   second fp32 exchange (five 32 KB stages, 32 KB of staging and 32 KB of
//   exchange take ~224 KB of 227): the one exchange serves both ways.
// - Phase 2 is one product a (128-token, 128-column) tile, contracted over
//   2 Np: dtn[b] = ce[b]^T . [qn; dg[b]], gemm_sm90_kernel's GEMM_DTN layout
//   (gemm_sm90.cu), bf16 written once, no partial sums.
// Sums run in a fixed order, with no atomics: a second backward gives the
// same bits. Every mbarrier wait traps after ~19 s instead of hanging.
#include "gemm_sm90.cuh"
#include "sm90.cuh"

namespace rz {
namespace vt {

using namespace fa::sm90;

namespace p1 {
constexpr int QT = 64;                         // queries of an output tile
constexpr int LT = 128;                        // tokens of an output tile
constexpr int KS = 64;                         // k-step: 64 columns of D
constexpr int THREADS = 288;                   // two consumer warpgroups + the producer warp
constexpr int TN_BYTES = LT * KS * 2;          // 16 KB: 128 tokens x 64
constexpr int Q_BYTES = QT * KS * 2;           // 8 KB: 64 queries (or dg rows) x 64
constexpr int STAGE = TN_BYTES + 2 * Q_BYTES;  // tn, qn, dg
constexpr int STAGES = 5;
constexpr int OUT_WG = QT * LT * 2;            // a warpgroup's bf16 tile: two 64 x 64 boxes
constexpr int XCH = 128 * 64 * 4;              // e in fp32, 64 values a consumer thread
constexpr int OUT_OFF = STAGES * STAGE;
constexpr int XCH_OFF = OUT_OFF + 2 * OUT_WG;
constexpr int BAR_OFF = XCH_OFF + XCH;
constexpr int RED_OFF = BAR_OFF + 8 * 2 * STAGES;  // warpgroup 0's four warp sums of dtau
constexpr size_t SMEM = RED_OFF + 16 + 1024;       // + room to align
static_assert(SMEM <= 232448, "over the 227 KB a block can have");
}  // namespace p1

// grid: min(work items, SMs); ce as a 3-D map (Lp, 2 Np, B) in 64 x 64 boxes
__global__ void __launch_bounds__(p1::THREADS, 1)
vlc_dtn_phase1_sm90_kernel(const __grid_constant__ CUtensorMap mq,
                           const __grid_constant__ CUtensorMap mt,
                           const __grid_constant__ CUtensorMap mg,
                           const __grid_constant__ CUtensorMap mo,
                           const float* __restrict__ rowmax, const float* __restrict__ tau,
                           float* __restrict__ dtau_slots, int N, int Np, int B, int L, int Lp,
                           int D) {
  using namespace p1;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t bars = base + BAR_OFF;  // full[STAGES], empty[STAGES]
  auto full = [&](int it) { return bars + 8 * (it % STAGES); };
  auto empty = [&](int it) { return bars + 8 * (STAGES + it % STAGES); };
  auto stage = [&](int it) { return base + STAGE * (it % STAGES); };
  const int tiles_l = (L + LT - 1) / LT, per_image = Np / QT * tiles_l;
  const int items = per_image * B, ksteps = D / KS;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      bar_init(full(s), 1);
      bar_init(empty(s), CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {  // the producer warp: one thread keeps the ring full
    if (threadIdx.x == CONSUMERS) {
      int it = 0;
      for (int t = blockIdx.x; t < items; t += gridDim.x) {
        const int b = t / per_image, r = t % per_image;
        const int n0 = r / tiles_l * QT, l0 = r % tiles_l * LT;
        for (int ks = 0; ks < ksteps; ++ks, ++it) {
          const uint32_t st = stage(it);
          bar_wait(empty(it), ((it / STAGES) & 1) ^ 1);  // released by both warpgroups
          bar_expect_tx(full(it), STAGE);
          tma_load_3d(st, &mt, full(it), ks * KS, l0, b);
          tma_load_2d(st + TN_BYTES, &mq, full(it), ks * KS, n0);
          tma_load_3d(st + TN_BYTES + Q_BYTES, &mg, full(it), ks * KS, n0, b);
        }
      }
    }
    return;
  }

  const int ct = threadIdx.x;
  const int wg = ct / 128, warp = (ct % 128) / 32, lane = ct % 32, quad = lane % 4;
  const bool leader = ct % 128 == 0;                  // issues its warpgroup's TMA stores
  const uint32_t stg = base + OUT_OFF + wg * OUT_WG;  // its 64 rows, staged
  const uint32_t xch = base + XCH_OFF + (ct % 128) * 4;  // its value i at xch + 512 i
  const int rl = warp * 16 + lane / 4;  // its first row in the tile's 64
  const float inv_tau = 1.0f / tau[0];
  float acc[64];  // rows rl (+ 8), columns 8 j + 2 quad (+ 1): acc[4 j + 2 i + e]
  int it = 0;
  for (int t = blockIdx.x; t < items; t += gridDim.x) {
    const int b = t / per_image, r = t % per_image;
    const int n0 = r / tiles_l * QT, l0 = r % tiles_l * LT;
    for (int ks = 0; ks < ksteps; ++ks, ++it) {
      bar_wait(full(it), (it / STAGES) & 1);
      const uint32_t st = stage(it);
      const uint64_t da = desc(st + TN_BYTES + wg * Q_BYTES, 1, 64);  // qn (0) or dg (1)
      const uint64_t db = desc(st, 1, 64);                            // tn, K-major
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < KS / 16; ++kk)
        wgmma_n128<0, 0>(acc, da + 2 * kk, db + 2 * kk, ks > 0 || kk > 0);
      wg_commit();
      if (ks > 0) {  // the last k-step's products are in: its stage is free
        wg_wait_one();
        bar_arrive(empty(it - 1));
      }
    }
    wg_wait_all();
    pin(acc);
    bar_arrive(empty(it - 1));

    // epilogue: e (warpgroup 0) and dc (warpgroup 1) into the staging tiles
    if (leader) bulk_wait_read();  // the last tile's stores have read the staging tile
    consumers_sync();              // and warpgroup 1 has read the last tile's e
    float m[2];                    // warpgroup 0: its rows' maxima, 0 past N
    if (wg == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int n = n0 + rl + 8 * i;
        m[i] = n < N ? rowmax[(size_t)b * N + n] : 0.f;
      }
#pragma unroll
      for (int j = 0; j < LT / 8; ++j) {
        const int c = 8 * j + 2 * quad;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const bool row = n0 + rl + 8 * i < N;
          float e[2];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int k = 4 * j + 2 * i + h;
            e[h] = row && l0 + c + h < L ? exp2f((acc[k] * inv_tau - m[i]) * kLog2e) : 0.f;
            asm volatile("st.shared.f32 [%0], %1;" ::"r"(xch + 512 * k), "f"(e[h]));
          }
          sts_bf2(stg + swz<2>(64, rl + 8 * i, c), e[0], e[1]);
        }
      }
    }
    consumers_sync();  // the exchange holds this tile's e
    if (wg == 1) {
#pragma unroll
      for (int j = 0; j < LT / 8; ++j) {
        const int c = 8 * j + 2 * quad;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float dc[2];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int k = 4 * j + 2 * i + h;
            float e;
            asm volatile("ld.shared.f32 %0, [%1];" : "=f"(e) : "r"(xch + 512 * k));
            dc[h] = acc[k] * e * inv_tau;
            if (dtau_slots != nullptr)  // dc in fp32 back into e's word, for dtau
              asm volatile("st.shared.f32 [%0], %1;" ::"r"(xch + 512 * k), "f"(dc[h]));
          }
          sts_bf2(stg + swz<2>(64, rl + 8 * i, c), dc[0], dc[1]);
        }
      }
    }
    fence_async_smem();
    wg_sync(wg);
    if (leader) {  // dc rows first, then e rows
      const int row = (wg == 0 ? Np : 0) + n0;
#pragma unroll
      for (int x = 0; x < LT / 64; ++x)
        if (l0 + 64 * x < Lp) tma_store_3d(&mo, stg + x * 64 * 128, l0 + 64 * x, row, b);
      bulk_commit();
    }
    if (dtau_slots != nullptr) {  // the item's share of sum dc (s - rowmax), dc unrounded
      consumers_sync();           // the exchange holds this tile's dc
      if (wg == 0) {
        float part = 0.f;
#pragma unroll
        for (int k = 0; k < 64; ++k) {
          float dc;
          asm volatile("ld.shared.f32 %0, [%1];" : "=f"(dc) : "r"(xch + 512 * k));
          part = fmaf(dc, acc[k] * inv_tau - m[(k / 2) % 2], part);
        }
        for (int o = 16; o > 0; o >>= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
        const uint32_t red = base + RED_OFF;
        if (lane == 0) asm volatile("st.shared.f32 [%0], %1;" ::"r"(red + 4 * warp), "f"(part));
        wg_sync(0);
        if (ct == 0) {  // the four warps in order, one store: no atomics
          float w[4];
#pragma unroll
          for (int x = 0; x < 4; ++x)
            asm volatile("ld.shared.f32 %0, [%1];" : "=f"(w[x]) : "r"(red + 4 * x));
          dtau_slots[t] = ((w[0] + w[1]) + w[2]) + w[3];
        }
      }
    }
  }
  if (leader) bulk_wait_read();  // the shared memory outlives the last stores' reads
}

// ---------------------------------------------------------------------------
// K5 / K10 in bf16: phase 1 (s and the tile maxima) and the row pass (e)
// ---------------------------------------------------------------------------

namespace fw {
constexpr int QT = 128;                   // queries of a work item: 64 a consumer warpgroup
constexpr int LT = 128;                   // tokens of a work item: the span of a tile maximum
constexpr int KS = 64;                    // k-step: 64 columns of D
constexpr int THREADS = 288;              // two consumer warpgroups + the producer warp
constexpr int Q_BYTES = QT * KS * 2;      // 16 KB: 128 queries x 64
constexpr int TN_BYTES = LT * KS * 2;     // 16 KB: 128 tokens x 64
constexpr int STAGE = Q_BYTES + TN_BYTES;
constexpr int STAGES = 5;
constexpr int OUT_WG = 64 * LT * 4;       // a warpgroup's s in fp32: four 64 x 32 boxes
constexpr int OUT_OFF = STAGES * STAGE;
constexpr int BAR_OFF = OUT_OFF + 2 * OUT_WG;
constexpr size_t SMEM = BAR_OFF + 8 * 2 * STAGES + 1024;  // + room to align
static_assert(SMEM <= 232448, "over the 227 KB a block can have");
constexpr int ROW_WARPS = 8;              // the row pass: warps (rows) a block
}  // namespace fw

// grid: min(work items, SMs); work items (image, 128 queries, 128 tokens), tokens
// fastest; s as a 3-D fp32 map (Lp, N, B) in 32 x 64 boxes
__global__ void __launch_bounds__(fw::THREADS, 1)
vlc_scores_sm90_kernel(const __grid_constant__ CUtensorMap mq,
                       const __grid_constant__ CUtensorMap mt,
                       const __grid_constant__ CUtensorMap ms, const float* __restrict__ tau,
                       float* __restrict__ tmax, int N, int B, int L, int Lp, int D) {
  using namespace fw;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t bars = base + BAR_OFF;  // full[STAGES], empty[STAGES]
  auto full = [&](int it) { return bars + 8 * (it % STAGES); };
  auto empty = [&](int it) { return bars + 8 * (STAGES + it % STAGES); };
  auto stage = [&](int it) { return base + STAGE * (it % STAGES); };
  const int tiles_l = (L + LT - 1) / LT, per_image = (N + QT - 1) / QT * tiles_l;
  const int items = per_image * B, ksteps = (D + KS - 1) / KS;

  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      bar_init(full(i), 1);
      bar_init(empty(i), CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {  // the producer warp: one thread keeps the ring full
    if (threadIdx.x == CONSUMERS) {
      int it = 0;
      for (int t = blockIdx.x; t < items; t += gridDim.x) {
        const int b = t / per_image, r = t % per_image;
        const int n0 = r / tiles_l * QT, l0 = r % tiles_l * LT;
        for (int ks = 0; ks < ksteps; ++ks, ++it) {
          const uint32_t st = stage(it);
          bar_wait(empty(it), ((it / STAGES) & 1) ^ 1);  // released by both warpgroups
          bar_expect_tx(full(it), STAGE);  // boxes past N, L or D count, as zeros
          tma_load_2d(st, &mq, full(it), ks * KS, n0);
          tma_load_3d(st + Q_BYTES, &mt, full(it), ks * KS, l0, b);
        }
      }
    }
    return;
  }

  const int ct = threadIdx.x;
  const int wg = ct / 128, warp = (ct % 128) / 32, lane = ct % 32, quad = lane % 4;
  const bool leader = ct % 128 == 0;                  // issues its warpgroup's TMA stores
  const uint32_t stg = base + OUT_OFF + wg * OUT_WG;  // its 64 rows of s, staged
  const int rl = warp * 16 + lane / 4;  // its first row in the warpgroup's 64
  const float inv_tau = 1.0f / tau[0];
  float acc[64];  // rows rl (+ 8), columns 8 j + 2 quad (+ 1): acc[4 j + 2 i + e]
  int it = 0;
  for (int t = blockIdx.x; t < items; t += gridDim.x) {
    const int b = t / per_image, r = t % per_image;
    const int n0 = r / tiles_l * QT + wg * 64, l0 = r % tiles_l * LT;  // this warpgroup's
    const bool live = n0 < N;  // any of its 64 queries is real
    for (int ks = 0; ks < ksteps; ++ks, ++it) {
      bar_wait(full(it), (it / STAGES) & 1);
      if (!live) {
        bar_arrive(empty(it));
        continue;
      }
      const uint32_t st = stage(it);
      const uint64_t da = desc(st + wg * 64 * 128, 1, 64);  // its 64 queries, K-major
      const uint64_t db = desc(st + Q_BYTES, 1, 64);        // 128 tokens, K-major
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < KS / 16; ++kk)
        wgmma_n128<0, 0>(acc, da + 2 * kk, db + 2 * kk, ks > 0 || kk > 0);
      wg_commit();
      if (ks > 0) {  // the last k-step's products are in: its stage is free
        wg_wait_one();
        bar_arrive(empty(it - 1));
      }
    }
    if (!live) continue;
    wg_wait_all();
    pin(acc);
    bar_arrive(empty(it - 1));

    // epilogue on the accumulators: s = S / tau staged for the TMA store, the
    // row's maximum over the item's real tokens into tmax
    if (leader) bulk_wait_read();  // the last item's stores have read the staging tile
    wg_sync(wg);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int n = n0 + rl + 8 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < LT / 8; ++j) {
        const int c = 8 * j + 2 * quad, l = l0 + c;
        const float v0 = acc[4 * j + 2 * i] * inv_tau, v1 = acc[4 * j + 2 * i + 1] * inv_tau;
        if (l < L) mx = fmaxf(mx, v0);
        if (l + 1 < L) mx = fmaxf(mx, v1);
        sts_f2(stg + swz<4>(64, rl + 8 * i, c), v0, v1);
      }
      // the row's four quad lanes hold its 128 columns
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      if (quad == 0 && n < N) tmax[((size_t)b * N + n) * tiles_l + l0 / LT] = mx;
    }
    fence_async_smem();
    wg_sync(wg);
    if (leader) {  // rows past N and columns past Lp are not written
#pragma unroll
      for (int x = 0; x < LT / 32; ++x)
        if (l0 + 32 * x < Lp) tma_store_3d(&ms, stg + x * 64 * 128, l0 + 32 * x, n0, b);
      bulk_commit();
    }
  }
  if (leader) bulk_wait_read();  // the shared memory outlives the last stores' reads
}

// one warp a row of e (B, Np, Lp): m = the maximum of the row's tile maxima,
// then e = exp2((s - m) log2 e) rounded to bf16 from s (B, N, Lp), zeros past
// L; the rows past N are zeros; rowmax (B, N) gets m and, unless it is null,
// map (B, N, L) the row's s
__global__ void __launch_bounds__(fw::ROW_WARPS * 32)
vlc_exp_rows_kernel(const float* __restrict__ s, const float* __restrict__ tmax,
                    __nv_bfloat16* __restrict__ e, float* __restrict__ rowmax,
                    float* __restrict__ map, int N, int Np, int B, int L, int Lp) {
  const int lane = threadIdx.x % 32, row = blockIdx.x * fw::ROW_WARPS + threadIdx.x / 32;
  if (row >= B * Np) return;
  const int b = row / Np, n = row % Np, tiles = (L + fw::LT - 1) / fw::LT;
  __nv_bfloat162* erow = reinterpret_cast<__nv_bfloat162*>(e + (size_t)row * Lp);
  if (n >= N) {
    for (int c = lane; c < Lp / 2; c += 32) erow[c] = __floats2bfloat162_rn(0.f, 0.f);
    return;
  }
  const size_t r = (size_t)b * N + n;
  float m = -INFINITY;
  for (int k = lane; k < tiles; k += 32) m = fmaxf(m, tmax[r * tiles + k]);
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  if (lane == 0) rowmax[r] = m;
  const float2* srow = reinterpret_cast<const float2*>(s + r * Lp);
  float* mrow = map == nullptr ? nullptr : map + r * L;
  for (int c = lane; c < Lp / 2; c += 32) {
    const int l = 2 * c;
    const float2 v = srow[c];
    const float e0 = l < L ? exp2f((v.x - m) * kLog2e) : 0.f;
    const float e1 = l + 1 < L ? exp2f((v.y - m) * kLog2e) : 0.f;
    erow[c] = __floats2bfloat162_rn(e0, e1);
    if (mrow != nullptr) {
      if (l < L) mrow[l] = v.x;
      if (l + 1 < L) mrow[l + 1] = v.y;
    }
  }
}

}  // namespace vt
}  // namespace rz

static bool vt_sm90_ok(int N, int Np, int L, int Lp, int D) {
  return D % 64 == 0 && Np % 64 == 0 && Lp % 64 == 0 && N <= Np && L <= Lp && N > 0 && L > 0;
}

// the card's SMs: a persistent grid's size
static int vt_sms(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return static_cast<int>(err);
}

// K12 phase 1 (bf16): qn (N, D), tn (B, L, D), dg (B, N, D), rowmax (B, N) fp32 and
// tau (1,) fp32 -> ce (B, 2 Np, Lp): dc rows, then e rows, zeros past N and L; unless
// dtau_slots is null also, per work item (image, 64 queries, 128 tokens), its share of
// sum dc (s - rowmax) into dtau_slots (B * Np / 64 * ceil(L / 128)) fp32
extern "C" int rz_vlcabs_dtn_phase1(const void* qn, const void* tn, const void* dg,
                                    const void* rowmax, const void* tau, void* ce,
                                    void* dtau_slots, int N, int Np, int B, int L, int Lp, int D,
                                    void* stream) {
  using namespace rz::vt;
  if (!vt_sm90_ok(N, Np, L, Lp, D)) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  CUtensorMap mq, mt, mg, mo;
  if (!make_map_2d(&mq, qn, N, D, p1::QT) || !make_map_3d(&mt, tn, B, L, D, p1::LT) ||
      !make_map_3d(&mg, dg, B, N, D, p1::QT) || !make_map_3d(&mo, ce, B, 2 * Np, Lp, 64))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = rz::allow_smem(vlc_dtn_phase1_sm90_kernel, p1::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  int sms = 0;
  if (const int e = vt_sms(&sms)) return e;
  const int items = B * (Np / p1::QT) * ((L + p1::LT - 1) / p1::LT);
  vlc_dtn_phase1_sm90_kernel<<<items < sms ? items : sms, p1::THREADS, p1::SMEM,
                               static_cast<cudaStream_t>(stream)>>>(
      mq, mt, mg, mo, static_cast<const float*>(rowmax), static_cast<const float*>(tau),
      static_cast<float*>(dtau_slots), N, Np, B, L, Lp, D);
  return static_cast<int>(cudaGetLastError());
}

// K12 phase 2 (bf16): dtn (B, L, D) = ce[b]^T . [qn; dg[b]] per image, rounded once
extern "C" int rz_vlcabs_dtn_phase2(const void* ce, const void* qn, const void* dg, void* dtn,
                                    int N, int Np, int B, int L, int Lp, int D, void* stream) {
  if (!vt_sm90_ok(N, Np, L, Lp, D)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      rz::gemm_sm90_dtn(ce, qn, dg, dtn, N, Np, B, L, Lp, D, static_cast<cudaStream_t>(stream)));
}

// K5 / K10 phase 1 (bf16): qn (N, D), tn (B, L, D), tau (1,) fp32 -> s (B, N, Lp)
// fp32 = qn . tn^T / tau, zeros in [L, Lp), and tmax (B, N, ceil(L / 128)) fp32,
// each row's maximum over each 128-token tile
extern "C" int rz_vlcabs_fwd_scores(const void* qn, const void* tn, const void* tau, void* s,
                                    void* tmax, int N, int B, int L, int Lp, int D,
                                    void* stream) {
  using namespace rz::vt;
  if (D % 8 || N <= 0 || L <= 0 || Lp % 64 || L > Lp)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  CUtensorMap mq, mt, ms;
  if (!make_map_2d(&mq, qn, N, D, fw::QT) || !make_map_3d(&mt, tn, B, L, D, fw::LT) ||
      !make_map_3d(&ms, s, B, N, Lp, 64, true))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = rz::allow_smem(vlc_scores_sm90_kernel, fw::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  int sms = 0;
  if (const int e = vt_sms(&sms)) return e;
  const int items = B * ((N + fw::QT - 1) / fw::QT) * ((L + fw::LT - 1) / fw::LT);
  vlc_scores_sm90_kernel<<<items < sms ? items : sms, fw::THREADS, fw::SMEM,
                           static_cast<cudaStream_t>(stream)>>>(
      mq, mt, ms, static_cast<const float*>(tau), static_cast<float*>(tmax), N, B, L, Lp, D);
  return static_cast<int>(cudaGetLastError());
}

// K5 / K10 row pass: s (B, N, Lp), tmax (B, N, ceil(L / 128)) fp32 -> e (B, Np, Lp)
// bf16, zeros past N and L, the row max (B, N) fp32 and, unless map is null, the map
// (B, N, L) fp32 = s without its padding
extern "C" int rz_vlcabs_fwd_rows(const void* s, const void* tmax, void* e, void* rowmax,
                                  void* map, int N, int Np, int B, int L, int Lp, void* stream) {
  using namespace rz::vt;
  if (!vt_sm90_ok(N, Np, L, Lp, 64)) return static_cast<int>(cudaErrorInvalidValue);
  const int rows = B * Np;
  if (rows == 0) return 0;
  vlc_exp_rows_kernel<<<(rows + fw::ROW_WARPS - 1) / fw::ROW_WARPS, fw::ROW_WARPS * 32, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(s), static_cast<const float*>(tmax),
      static_cast<__nv_bfloat16*>(e), static_cast<float*>(rowmax), static_cast<float*>(map), N,
      Np, B, L, Lp);
  return static_cast<int>(cudaGetLastError());
}

// K5 / K10 phase 2 (bf16): g (B, N, D) fp32 = e[b] . tn[b] per image, from the row
// pass's e (B, Np, Lp) and tn (B, L, D)
extern "C" int rz_vlcabs_fwd_g(const void* e, const void* tn, void* g, int N, int Np, int B,
                               int L, int Lp, int D, void* stream) {
  if (!vt_sm90_ok(N, Np, L, Lp, 64) || D % 8) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(rz::gemm_sm90_vlc_g(e, tn, static_cast<float*>(g), N, Np, B, L, Lp, D,
                                              false, static_cast<cudaStream_t>(stream)));
}
