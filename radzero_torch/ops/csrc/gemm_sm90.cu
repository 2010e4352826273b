// The bf16 GEMM for Hopper, gemm_sm90_kernel<EPI, MODE>: every bf16 product
// of K1 fused_preattn, K3 fused_postattn and K4 fused_mpnet_post
// (rz_fused_preattn, rz_fused_postattn and rz_fused_mpnet_post of
// fused_layer.cu call it after a row pass that writes each row's LayerNorm
// once as a bf16 operand), of the backward chains K6, K8 and K9 (rz_bwd_gemm
// and rz_wgrad of fused_layer_bwd.cu: their forward recompute, their dX
// products and their dW products), K12's second phase and K5 / K10's second
// phase in bf16 (vlcabs_sm90.cu) and K11's dq product (vlcabs_train.cu).
// fp32 stays on gemm_f32_kernel / wgrad_f32_kernel (gemm.cuh).
//
// Replaces the products of the TPU kernels radzero_tpu/ops/fused_layer.py
// fused_preattn (_preattn_kernel, the pallas_call at :92), fused_postattn
// (_postattn_kernel, :913), _mpnet_post_call (:760), _preattn_vjp_bwd (:390),
// _postattn_vjp_bwd (:568) and _mpnet_post_vjp_bwd (:820), and of
// radzero_tpu/ops/pallas_vlcabs.py _train_bwd's _kernel_bwd_dtn (:403) and
// _kernel_bwd_dq's dc . tn (:381), and vlcabs_fused / _train_forward's e . tn
// (:115, :310), with their contract:
// bf16 operands, fp32
// accumulation, the epilogue in fp32 on the accumulators (bias, LayerScale,
// residual, exact-erf GELU and its derivative), rounded to bf16 where the JAX
// code rounds (qkv, the GELU output, the layer output, dh1; K3's y and the
// chains' h1, proj, y, u, v, m and dX sums stay fp32). Rows are masked, never
// padded; every sum runs in a fixed order, without atomics.
//
// What bounds it on the H100: the tensor cores. At 8 images (M = 10 960) K1
// does 2 M 768 2304 operations and K3 2 M 768 (768 + 2 3072), 39 and 118 us at
// 989 TFLOP/s, against 3.35 TB/s for their operands and outputs; K9's chain at
// 16 384 rows does three times K3's products, 0.53 ms. What held the forward
// at 1.5-1.8x its cuBLAS products (ops/ablate_sm90.py gemm) is not the
// products, whose removal leaves the qkv and fc2 times as they were, but the
// ring, which turns a 32 KB stage round in ~0.4 us an SM at any depth, and
// fc1's exact-erf epilogue, which no product overlaps.
//
// Design (C = A . B, 128 x 128 output tiles, column tiles fastest so that the
// blocks in flight share an A row tile in L2; a persistent grid of one
// 288-thread block per SM walks the work items with a stride of the grid):
// - A ninth warp is the producer: one thread keeps a ring of STAGES 64-deep
//   k-steps in flight by TMA, each stage with a full and an empty mbarrier,
//   running on into the next item while the consumers finish the last. Three
//   operand layouts (MODE), one 32 KB stage each:
//   GEMM_FWD, C = A . W: A (M, K) row-major is a K-major operand, one 128 x 64
//     box; W (K, N) row-major an MN-major B operand (the descriptor's
//     transpose bit): two 64 x 64 boxes side by side, the two 64-column
//     swizzle atoms of the tile, 8 KB apart (the descriptor's leading byte
//     offset); a box wholly past N is not loaded.
//   GEMM_DX, C = G . W^T with W (N, K) row-major as stored: a K-major B
//     operand, one 128 x 64 box like A's, transpose bit off, so no transposed
//     copy of W is written.
//   GEMM_DW, part[chunk] = A^T . G over a chunk of rows (the reduction): A
//     (rows, Ka) row-major is an MN-major A operand (A's transpose bit), two
//     64-row x 64-column boxes, one a warpgroup; G (rows, Nb) an MN-major B
//     as W above. Chunks are whole multiples of the k-step, so only the last
//     reads past the rows (zeros); each (tile, chunk) is one work item, chunk
//     slowest, and rz_reduce_parts adds the chunks in order afterwards.
//   GEMM_DTN, K12's dtn[b] = [dc[b]; e[b]]^T . [qn; dg[b]] per image b
//     (gemm_sm90_dtn): GEMM_DW's layout with an image coordinate (3-D maps)
//     and one chunk, the whole contraction, so the epilogue writes bf16 once;
//     the B rows come from qn for k < k_split and from dg[b] after, through
//     two maps rather than a copy.
//   GEMM_BFWD, K5 / K10's g[b] = e[b] . tn[b] and K11's dz ghat[b] + dc[b] . tn[b]
//     per image b (gemm_sm90_vlc_g): GEMM_FWD's layout with an image coordinate
//     on A, B, the output and EPI_ADDF_F32's residual (3-D maps), so an image's
//     rows past its end come in as zeros; A's rows per image may exceed M (K11
//     reads dc, the first Np of each image's 2 Np rows of K12's ce).
//   Rows past M, columns past N and k past K come in as zeros, so K needs no
//   multiple of 64. Under a 384-thread block (a producer warpgroup) ptxas held
//   the kernel to 168 registers and the GELU epilogue spilled; under 288
//   threads it takes 163 and spills nothing.
// - Warpgroups 0 and 1 are consumers, 64 rows each: per k-step four wgmma
//   m64n128k16 from shared memory into 64 fp32 registers a thread; the stage
//   is released once the next k-step's products are issued and the last are in.
// - The epilogue runs on the accumulator registers (a thread owns rows lane /
//   4 (+ 8) and column pairs 8 j + 2 quad; bias and LayerScale read once per
//   pair) and writes each warpgroup's 64 x 128 values into a staging tile in
//   shared memory, laid out as TMA's 128-byte swizzle lays out a box (the
//   xor of the 16-byte chunk with the row keeps the warp's stores free of
//   bank conflicts); one thread then stores the tile by TMA, which clips rows
//   >= M and columns >= N, and the warpgroup goes on to its next tile while
//   the store drains. An epilogue's input tile (x in bf16 for the
//   o-projections, y32 for K3's fc2, h1 for the GELU derivative) comes by TMA
//   into shared memory too, loaded by the producer while the tile's products
//   run. Without this, scattered 4- and 8-byte stores and loads of the
//   epilogue took 40% of the kernel's time (ops/ablate_sm90.py gemm).
// - Shared memory (227 KB a block; a stage is 32 KB, the fp32 staging of a
//   tile or an fp32 input tile 64 KB) sets the ring's depth per epilogue
//   (Layout): five stages where the extra tiles take at most 64 KB, else
//   four. EPI_ADDF_F32 (fp32 in, fp32 out) loads its residual straight into
//   the output staging tile, in the store's box layout, and adds in place,
//   so it keeps five; each warpgroup's leader lets the residual in once the
//   last tile's stores have read the staging tile, a few k-steps into the
//   next tile. EPI_PROJ2's two fp32 outputs share one staging tile: proj is
//   stored first and x + ls proj staged once that store has read it.
//   EPI_DGELU's column sums: each column pair is summed over the thread's
//   two rows, then over the warp's 8 row lanes by shuffles; one partial per
//   warp goes into the h1 tile at the warp's first row (read by that same
//   lane and dead after), and after a barrier of both warpgroups one thread
//   a column adds the 8 partials in order into colpart[row tile, column].
// Every mbarrier wait traps after ~19 s instead of hanging the card.
#include "gemm_sm90.cuh"
#include "sm90.cuh"

namespace rz {
namespace {

using namespace fa::sm90;
using bf16 = __nv_bfloat16;

enum Mode { GEMM_FWD = 0, GEMM_DX = 1, GEMM_DW = 2, GEMM_DTN = 3, GEMM_BFWD = 4 };  // above

// a product per image: the work items run over the images, the maps are 3-D
__host__ __device__ constexpr bool batched(int mode) {
  return mode == GEMM_DTN || mode == GEMM_BFWD;
}

constexpr int BM = kSm90RowTile, BN = 128, BK = 64;  // output tile, k-step
constexpr int THREADS = 288;                 // two consumer warpgroups + one producer warp
constexpr int A_BYTES = BM * BK * 2;         // one 128 x 64 box
constexpr int BOX64 = 64 * 64 * 2;           // one 64 x 64 box: half a 128-wide operand tile
constexpr int STAGE_BYTES = A_BYTES + 2 * BOX64;

// shared memory of one epilogue: the ring, the output tile staged for the TMA
// store (fp32 or bf16), a second fp32 output's (EPI_GELU_H1's h1), the input
// tile (x in bf16; y32 or h1 in fp32) where the epilogue has one, then the
// barriers. EPI_ADDF_F32's fp32 residual comes into the output staging tile.
template <int EPI>
struct Layout {
  static constexpr int IN_ES =  // bytes an input value
      EPI == EPI_RESID_F32 || EPI == EPI_ADD_F32 || EPI == EPI_PROJ2             ? 2
      : EPI == EPI_RESID_OUT || EPI == EPI_DGELU || EPI == EPI_ADDF_F32 ? 4
                                                                          : 0;
  static constexpr bool IN = IN_ES != 0;
  static constexpr bool INPLACE = EPI == EPI_ADDF_F32;
  static constexpr bool LS = EPI == EPI_RESID_F32 || EPI == EPI_RESID_OUT || EPI == EPI_PROJ2;
  static constexpr int OUT_ES = EPI == EPI_RESID_F32 || EPI == EPI_ADD_F32 ||
                                        EPI == EPI_ADDF_F32 || EPI == EPI_PROJ2 || EPI == EPI_F32
                                    ? 4
                                    : 2;  // bytes an output value
  static constexpr int OUT_WG = 64 * BN * OUT_ES;                       // one warpgroup's 64 rows
  static constexpr int OUT2_WG = EPI == EPI_GELU_H1 ? 64 * BN * 4 : 0;  // its h1 rows
  static constexpr int IN_BYTES = IN && !INPLACE ? BM * BN * IN_ES : 0;
  static constexpr int EXTRA = 2 * (OUT_WG + OUT2_WG) + IN_BYTES;
  static constexpr int STAGES = EXTRA <= 65536 ? 5 : 4;  // k-steps in flight
  static constexpr int OUT_OFF = STAGES * STAGE_BYTES;
  static constexpr int OUT2_OFF = OUT_OFF + 2 * OUT_WG;
  static constexpr int IN_OFF = OUT2_OFF + 2 * OUT2_WG;
  static constexpr int BAR_OFF = IN_OFF + IN_BYTES;
  static constexpr size_t SMEM = BAR_OFF + 8 * (2 * STAGES + 2) + 1024;  // + room to align
  static_assert(SMEM <= 232448, "over the 227 KB a block can have");
};

__device__ __forceinline__ float2 pair(const void* p, int n) {
  return p == nullptr ? make_float2(0.f, 0.f)
                      : __bfloat1622float2(
                            *reinterpret_cast<const __nv_bfloat162*>(static_cast<const bf16*>(p) + n));
}

// gelu'(h) = Phi(h) + h * pdf(h), as epilogue() of gemm.cuh computes it
__device__ __forceinline__ float dgelu(float h) {
  return gelu_phi(h) + h * (kInvSqrt2Pi * exp2f(-(h * h) * (0.5f * kLog2e)));
}

// one work item: an output tile and, for GEMM_DW, a chunk of the reduction
struct Item {
  int m0, n0;  // the tile's first row and column
  int k0;      // its first k (GEMM_DW: the chunk's first row)
  int ksteps;  // its k-steps (GEMM_DW: 0 for a chunk wholly past the rows)
  int orow;    // the output row of its first row (GEMM_DW: in part[chunk])
  int b;       // GEMM_DTN, GEMM_BFWD: its image
};

template <int MODE>
__device__ __forceinline__ Item item_of(const GemmArgs& g, int t, int tiles, int tiles_n) {
  const int tile = t % tiles;
  Item w{tile / tiles_n * BM, tile % tiles_n * BN, 0, (g.K + BK - 1) / BK, tile / tiles_n * BM,
         t / tiles};
  if (MODE == GEMM_DW) {
    const int chunk = t / tiles;
    w.k0 = chunk * g.chunk_steps * BK;
    const int left = w.k0 < g.K ? (g.K - w.k0 + BK - 1) / BK : 0;
    w.ksteps = left < g.chunk_steps ? left : g.chunk_steps;
    w.orow = chunk * g.M + w.m0;
  }
  return w;
}

// the TMA stores of one warpgroup's staged rows: `src` (ES-byte values) -> map
template <int ES, int MODE>
__device__ __forceinline__ void store_rows(const CUtensorMap* map, uint32_t src, const Item& w,
                                           int wg, int N) {
  constexpr int COLS = 128 / ES;
#pragma unroll
  for (int b = 0; b < BN / COLS; ++b) {
    if (w.n0 + b * COLS >= N) continue;
    if (batched(MODE))
      tma_store_3d(map, src + b * 64 * 128, w.n0 + b * COLS, w.orow + wg * 64, w.b);
    else
      tma_store_2d(map, src + b * 64 * 128, w.n0 + b * COLS, w.orow + wg * 64);
  }
}

template <int EPI, int MODE>
__global__ void __launch_bounds__(THREADS, 1)
gemm_sm90_kernel(const __grid_constant__ CUtensorMap ma, const __grid_constant__ CUtensorMap mw,
                 const __grid_constant__ CUtensorMap mo, const __grid_constant__ CUtensorMap mo2,
                 const __grid_constant__ CUtensorMap mi, const GemmArgs g) {
  using Lay = Layout<EPI>;
  constexpr int STAGES = Lay::STAGES;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t bars = base + Lay::BAR_OFF;  // full[STAGES], empty[STAGES], ifull, iempty
  const uint32_t ifull = bars + 16 * STAGES, iempty = ifull + 8;
  auto full = [&](int it) { return bars + 8 * (it % STAGES); };
  auto empty = [&](int it) { return bars + 8 * (STAGES + it % STAGES); };
  auto stage = [&](int it) { return base + STAGE_BYTES * (it % STAGES); };
  const int tiles_n = (g.N + BN - 1) / BN;
  const int tiles = tiles_n * ((g.M + BM - 1) / BM);
  const int items = tiles * (MODE == GEMM_DW ? g.splits : batched(MODE) ? g.batch : 1);

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      bar_init(full(s), 1);
      bar_init(empty(s), CONSUMERS);
    }
    bar_init(ifull, 1);
    bar_init(iempty, Lay::INPLACE ? 2 : CONSUMERS);  // in place: the two leaders
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {  // the producer warp: one thread keeps the ring full
    if (threadIdx.x == CONSUMERS) {
      int it = 0;  // position in the ring over every k-step of every item
      for (int t = blockIdx.x, lt = 0; t < items; t += gridDim.x, ++lt) {
        const Item w = item_of<MODE>(g, t, tiles, tiles_n);
        const bool right = w.n0 + 64 < g.N;  // the tile's second 64 columns hold any of B
        const bool lower = w.m0 + 64 < g.M;  // its second 64 rows hold any of C
        for (int ks = 0; ks < w.ksteps; ++ks, ++it) {
          const int k = w.k0 + ks * BK;
          const uint32_t st = stage(it);
          bar_wait(empty(it), ((it / STAGES) & 1) ^ 1);  // stage released by both consumers
          if (MODE == GEMM_DW) {  // A^T: a 64 x 64 box of A's columns per warpgroup
            bar_expect_tx(full(it), (lower ? 2 : 1) * BOX64 + (right ? 2 : 1) * BOX64);
            tma_load_2d(st, &ma, full(it), w.m0, k);
            if (lower) tma_load_2d(st + BOX64, &ma, full(it), w.m0 + 64, k);
          } else if (MODE == GEMM_DTN) {  // the same from image w.b
            bar_expect_tx(full(it), (lower ? 2 : 1) * BOX64 + (right ? 2 : 1) * BOX64);
            tma_load_3d(st, &ma, full(it), w.m0, k, w.b);
            if (lower) tma_load_3d(st + BOX64, &ma, full(it), w.m0 + 64, k, w.b);
          } else {
            bar_expect_tx(full(it),
                          A_BYTES + (MODE == GEMM_DX ? A_BYTES : (right ? 2 : 1) * BOX64));
            if (MODE == GEMM_BFWD)
              tma_load_3d(st, &ma, full(it), k, w.m0, w.b);
            else
              tma_load_2d(st, &ma, full(it), k, w.m0);
          }
          if (MODE == GEMM_DX) {  // W as stored: 128 rows of it, K-major
            tma_load_2d(st + A_BYTES, &mw, full(it), k, w.n0);
          } else if (MODE == GEMM_DTN && k >= g.k_split) {  // the second B: image w.b's rows
            tma_load_3d(st + A_BYTES, &mi, full(it), w.n0, k - g.k_split, w.b);
            if (right)
              tma_load_3d(st + A_BYTES + BOX64, &mi, full(it), w.n0 + 64, k - g.k_split, w.b);
          } else if (MODE == GEMM_BFWD) {  // image w.b's (K, N) block, MN-major as GEMM_FWD's W
            tma_load_3d(st + A_BYTES, &mw, full(it), w.n0, k, w.b);
            if (right) tma_load_3d(st + A_BYTES + BOX64, &mw, full(it), w.n0 + 64, k, w.b);
          } else {
            tma_load_2d(st + A_BYTES, &mw, full(it), w.n0, k);
            if (right) tma_load_2d(st + A_BYTES + BOX64, &mw, full(it), w.n0 + 64, k);
          }
          // the input tile, once the consumers are past the last tile's epilogue
          // (they have released this tile's first stage), in time for this one's
          if (Lay::IN && ks == (w.ksteps - 1 < STAGES ? w.ksteps - 1 : STAGES)) {
            constexpr int COLS = 128 / (Lay::IN ? Lay::IN_ES : 4);
            int boxes = 0;
            for (int b = 0; b < BN / COLS; ++b) boxes += w.n0 + b * COLS < g.N;
            if (Lay::INPLACE) {  // into each warpgroup's staging tile, in the store's boxes
              constexpr int BOX = 64 * 128;
              bar_wait(iempty, lt & 1);  // both leaders saw the last stores read them
              bar_expect_tx(ifull, (lower ? 2 : 1) * boxes * BOX);
              for (int h = 0; h < (lower ? 2 : 1); ++h)
                for (int b = 0; b < boxes; ++b) {
                  const uint32_t dst = base + Lay::OUT_OFF + h * Lay::OUT_WG + b * BOX;
                  if (batched(MODE))  // image w.b's rows: its rows past M come in as zeros
                    tma_load_3d(dst, &mi, ifull, w.n0 + b * COLS, w.m0 + h * 64, w.b);
                  else
                    tma_load_2d(dst, &mi, ifull, w.n0 + b * COLS, w.m0 + h * 64);
                }
            } else {
              constexpr int BOX = BM * 128;
              bar_wait(iempty, (lt & 1) ^ 1);
              bar_expect_tx(ifull, boxes * BOX);
              for (int b = 0; b < boxes; ++b)
                tma_load_2d(base + Lay::IN_OFF + b * BOX, &mi, ifull, w.n0 + b * COLS, w.m0);
            }
          }
        }
      }
    }
    return;
  }

  const int ct = threadIdx.x;
  const int wg = ct / 128, warp = (ct % 128) / 32, lane = ct % 32, quad = lane % 4;
  const bool leader = ct % 128 == 0;  // issues its warpgroup's TMA stores
  const uint32_t stg = base + Lay::OUT_OFF + wg * Lay::OUT_WG;     // its 64 rows, staged
  const uint32_t stg2 = base + Lay::OUT2_OFF + wg * Lay::OUT2_WG;  // their h1 (EPI_GELU_H1)
  const uint32_t in = base + Lay::IN_OFF;
  const int rl = warp * 16 + lane / 4;  // its first row in the warpgroup's 64
  // A descriptor per warpgroup and the advance of both per k-step of 16
  constexpr bool AT = MODE == GEMM_DW || MODE == GEMM_DTN;  // A read MN-major
  constexpr int SA = AT ? 128 : 2, SB = MODE == GEMM_DX ? 2 : 128;
  float acc[64];  // rows rl (+ 8), columns 8 j + 2 quad (+ 1): acc[4 j + 2 i + e]
  int it = 0;
  for (int t = blockIdx.x, lt = 0; t < items; t += gridDim.x, ++lt) {
    const Item w = item_of<MODE>(g, t, tiles, tiles_n);
    if (w.ksteps == 0) {  // a dW chunk past the rows: its partial tile is zeros
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    }
    for (int ks = 0; ks < w.ksteps; ++ks, ++it) {
      bar_wait(full(it), (it / STAGES) & 1);
      const uint32_t st = stage(it);
      const uint64_t da = AT ? desc(st + wg * BOX64, 64, 64)        // this warpgroup's
                             : desc(st + wg * 64 * 128, 1, 64);  // 64 rows of C
      const uint64_t db = MODE == GEMM_DX ? desc(st + A_BYTES, 1, 64)
                                          : desc(st + A_BYTES, BOX64 / 16, 64);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_n128<AT, MODE != GEMM_DX>(acc, da + SA * kk, db + SB * kk, ks > 0 || kk > 0);
      wg_commit();
      if (ks > 0) {  // the last k-step's products are in: its stage is free
        wg_wait_one();
        bar_arrive(empty(it - 1));
      }
      // in place: let the residual into the staging tile once the last tile's
      // stores have read it, a few k-steps into this tile
      if (Lay::INPLACE && leader && ks == (w.ksteps - 1 < STAGES - 1 ? w.ksteps - 1 : STAGES - 1)) {
        bulk_wait_read();
        bar_arrive(iempty);
      }
    }
    if (w.ksteps > 0) {
      wg_wait_all();
      pin(acc);
      bar_arrive(empty(it - 1));
    }

    // epilogue: the values into the staging tile, then one TMA store per box
    if (Lay::IN) bar_wait(ifull, lt & 1);
    if (leader) bulk_wait_read();  // the last tile's stores have read the staging tile
    wg_sync(wg);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int c = 8 * j + 2 * quad, gn = w.n0 + c;
      const bool inb = gn < g.N;  // N % 8 == 0: an 8-column group is wholly in or out
      const float2 b = inb ? pair(g.bias, gn) : make_float2(0.f, 0.f);
      const float2 ls = Lay::LS && inb ? pair(g.ls, gn) : make_float2(0.f, 0.f);
      float s0 = 0.f, s1 = 0.f;  // EPI_DGELU: the pair's sums over the thread's rows
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = rl + 8 * i, rt = wg * 64 + r;  // row in the warpgroup's 64, in the tile
        const float v0 = acc[4 * j + 2 * i] + b.x, v1 = acc[4 * j + 2 * i + 1] + b.y;
        const uint32_t o4 = stg + swz<4>(64, r, c), o2 = stg + swz<2>(64, r, c);
        if (EPI == EPI_RESID_F32) {  // y32 = x + ls (acc + b)
          const float2 x = lds_bf2(in + swz<2>(BM, rt, c));
          sts_f2(o4, x.x + ls.x * v0, x.y + ls.y * v1);
        } else if (EPI == EPI_ADD_F32) {  // u = x + (acc + b)
          const float2 x = lds_bf2(in + swz<2>(BM, rt, c));
          sts_f2(o4, x.x + v0, x.y + v1);
        } else if (EPI == EPI_ADDF_F32) {  // y32 + (acc + b), in place
          const float2 y = lds_f2(o4);
          sts_f2(o4, y.x + v0, y.y + v1);
        } else if (EPI == EPI_F32 || EPI == EPI_PROJ2) {  // EPI_PROJ2: proj first
          sts_f2(o4, v0, v1);
        } else if (EPI == EPI_GELU_H1) {  // h1 in fp32, gelu(h1) rounded
          sts_f2(stg2 + swz<4>(64, r, c), v0, v1);
          sts_bf2(o2, v0 * gelu_phi(v0), v1 * gelu_phi(v1));
        } else if (EPI == EPI_GELU) {
          sts_bf2(o2, v0 * gelu_phi(v0), v1 * gelu_phi(v1));
        } else if (EPI == EPI_RESID_OUT) {  // out = y32 + ls (acc + b)
          const float2 y = lds_f2(in + swz<4>(BM, rt, c));
          sts_bf2(o2, y.x + ls.x * v0, y.y + ls.y * v1);
        } else if (EPI == EPI_DGELU) {  // acc gelu'(h1), rounded; its unrounded sums
          const float2 h = lds_f2(in + swz<4>(BM, rt, c));
          const float d0 = v0 * dgelu(h.x), d1 = v1 * dgelu(h.y);
          sts_bf2(o2, d0, d1);
          s0 += d0;
          s1 += d1;
        } else {  // EPI_BIAS
          sts_bf2(o2, v0, v1);
        }
      }
      if (EPI == EPI_DGELU) {  // over the warp's 8 row lanes; one partial per warp
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) {
          s0 += __shfl_xor_sync(0xffffffffu, s0, o);
          s1 += __shfl_xor_sync(0xffffffffu, s1, o);
        }
        if (lane < 4) sts_f2(in + swz<4>(BM, wg * 64 + warp * 16, c), s0, s1);
      }
    }
    if (EPI == EPI_DGELU) {  // the 8 warps' partials of each column, in order
      consumers_sync();
      if (ct < BN) {
        float s = 0.f;
#pragma unroll
        for (int p = 0; p < 8; ++p) {
          float v;
          asm volatile("ld.shared.f32 %0, [%1];"
                       : "=f"(v) : "r"(in + swz<4>(BM, (p / 4) * 64 + (p % 4) * 16, ct)));
          s += v;
        }
        if (w.n0 + ct < g.N) g.colpart[(size_t)(w.m0 / BM) * g.N + w.n0 + ct] = s;
      }
    }
    fence_async_smem();
    wg_sync(wg);
    const bool rows = w.m0 + wg * 64 < g.M;  // the warpgroup's rows hold any of C
    if (leader && rows) {
      if (EPI == EPI_GELU_H1) store_rows<4, MODE>(&mo2, stg2, w, wg, g.N);
      store_rows<Lay::OUT_ES, MODE>(EPI == EPI_PROJ2 ? &mo2 : &mo, stg, w, wg, g.N);
      bulk_commit();
    }
    if (EPI == EPI_PROJ2) {  // then out = x + ls proj through the same staging tile
      if (leader) bulk_wait_read();
      wg_sync(wg);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int c = 8 * j + 2 * quad, gn = w.n0 + c;
        const bool inb = gn < g.N;
        const float2 b = inb ? pair(g.bias, gn) : make_float2(0.f, 0.f);
        const float2 ls = inb ? pair(g.ls, gn) : make_float2(0.f, 0.f);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = rl + 8 * i;
          const float2 x = lds_bf2(in + swz<2>(BM, wg * 64 + r, c));
          sts_f2(stg + swz<4>(64, r, c), x.x + ls.x * (acc[4 * j + 2 * i] + b.x),
                 x.y + ls.y * (acc[4 * j + 2 * i + 1] + b.y));
        }
      }
      fence_async_smem();
      wg_sync(wg);
      if (leader && rows) {
        store_rows<4, MODE>(&mo, stg, w, wg, g.N);
        bulk_commit();
      }
    }
    if (Lay::IN && !Lay::INPLACE) bar_arrive(iempty);  // this thread is done with the input
  }
  if (leader) bulk_wait_read();  // the shared memory outlives the last stores' reads
}

// a persistent grid of one block an SM, or one a work item where they are fewer
template <int EPI, int MODE>
cudaError_t run(const CUtensorMap& ma, const CUtensorMap& mw, const CUtensorMap& mo,
                const CUtensorMap& mo2, const CUtensorMap& mi, const GemmArgs& g,
                cudaStream_t stream) {
  using Lay = Layout<EPI>;
  cudaError_t err = allow_smem(gemm_sm90_kernel<EPI, MODE>, Lay::SMEM);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  const int items = ((g.M + BM - 1) / BM) * ((g.N + BN - 1) / BN) *
                    (MODE == GEMM_DW ? g.splits : batched(MODE) ? g.batch : 1);
  gemm_sm90_kernel<EPI, MODE><<<items < sms ? items : sms, THREADS, Lay::SMEM, stream>>>(
      ma, mw, mo, mo2, mi, g);
  return cudaGetLastError();
}

template <int EPI, int MODE>
cudaError_t launch(const GemmArgs& g, cudaStream_t stream) {
  using Lay = Layout<EPI>;
  // A, B, the output, the second output (EPI_GELU_H1's h1, EPI_PROJ2's proj) and
  // the input tile's matrix; a map that is not read is a copy of another
  CUtensorMap ma, mw, mo, mo2, mi;
  bool ok;
  if (MODE == GEMM_DW)  // A (K rows, M columns) in 64 x 64 boxes; part as (splits M, N)
    ok = make_map_2d(&ma, g.a, g.K, g.M, 64) && make_map_2d(&mw, g.w, g.K, g.N, BK) &&
         make_map_2d(&mo, g.out, g.splits * g.M, g.N, 64, true);
  else
    ok = make_map_2d(&ma, g.a, g.M, g.K, BM) &&
         (MODE == GEMM_DX ? make_map_2d(&mw, g.w, g.N, g.K, BN)
                          : make_map_2d(&mw, g.w, g.K, g.N, BK)) &&
         make_map_2d(&mo, g.out, g.M, g.N, 64, Lay::OUT_ES == 4);
  mo2 = mo;
  mi = ma;
  if (ok && (EPI == EPI_GELU_H1 || EPI == EPI_PROJ2))
    ok = make_map_2d(&mo2, g.out2, g.M, g.N, 64, true);
  if (ok && Lay::IN)
    ok = make_map_2d(&mi, EPI == EPI_DGELU ? static_cast<const void*>(g.aux) : g.resid, g.M, g.N,
                     Lay::INPLACE ? 64 : BM, Lay::IN_ES == 4);
  if (!ok) return cudaErrorInvalidValue;
  return run<EPI, MODE>(ma, mw, mo, mo2, mi, g, stream);
}

}  // namespace

cudaError_t gemm_sm90(const GemmArgs& g, int epi, cudaStream_t stream, bool w_t) {
  if (g.K % 8 || g.N % 8) return cudaErrorInvalidValue;
  if (g.M == 0) return cudaSuccess;
  if (w_t) {
    switch (epi) {
      case EPI_BIAS: return launch<EPI_BIAS, GEMM_DX>(g, stream);
      case EPI_ADDF_F32: return launch<EPI_ADDF_F32, GEMM_DX>(g, stream);
      case EPI_F32: return launch<EPI_F32, GEMM_DX>(g, stream);
      case EPI_DGELU: return launch<EPI_DGELU, GEMM_DX>(g, stream);
      default: return cudaErrorInvalidValue;
    }
  }
  switch (epi) {
    case EPI_BIAS: return launch<EPI_BIAS, GEMM_FWD>(g, stream);
    case EPI_RESID_F32: return launch<EPI_RESID_F32, GEMM_FWD>(g, stream);
    case EPI_GELU: return launch<EPI_GELU, GEMM_FWD>(g, stream);
    case EPI_RESID_OUT: return launch<EPI_RESID_OUT, GEMM_FWD>(g, stream);
    case EPI_ADD_F32: return launch<EPI_ADD_F32, GEMM_FWD>(g, stream);
    case EPI_ADDF_F32: return launch<EPI_ADDF_F32, GEMM_FWD>(g, stream);
    case EPI_PROJ2: return launch<EPI_PROJ2, GEMM_FWD>(g, stream);
    case EPI_GELU_H1: return launch<EPI_GELU_H1, GEMM_FWD>(g, stream);
    case EPI_F32: return launch<EPI_F32, GEMM_FWD>(g, stream);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t gemm_sm90_wgrad(const void* a, const void* gr, float* part, int rows, int Ka, int Nb,
                            int splits, cudaStream_t stream) {
  if (splits < 1 || Ka % 64 || Nb % 8) return cudaErrorInvalidValue;
  if (rows == 0) return cudaMemsetAsync(part, 0, sizeof(float) * splits * Ka * Nb, stream);
  GemmArgs g{a, gr, nullptr, nullptr, nullptr, 0.f, nullptr, nullptr, part, Ka, Nb, rows};
  g.splits = splits;
  g.chunk_steps = ((rows + splits - 1) / splits + BK - 1) / BK;
  return launch<EPI_F32, GEMM_DW>(g, stream);
}

cudaError_t gemm_sm90_dtn(const void* ce, const void* qn, const void* dg, void* dtn, int N,
                          int Np, int B, int L, int Lp, int D, cudaStream_t stream) {
  if (D % 64 || Np % 64 || Lp % 64 || N > Np || L > Lp) return cudaErrorInvalidValue;
  if (B == 0 || L == 0) return cudaSuccess;
  GemmArgs g{ce, qn, nullptr, nullptr, nullptr, 0.f, dg, nullptr, dtn, L, D, 2 * Np};
  g.batch = B;
  g.k_split = Np;
  // A: image b's (2 Np, Lp) block of ce, read MN-major in 64 x 64 boxes; B: qn (N, D)
  // for k < Np, then dg[b] (N, D) through the input tile's map; dtn (B, L, D)
  CUtensorMap ma, mw, mo, mi;
  if (!make_map_3d(&ma, ce, B, 2 * Np, Lp, 64) || !make_map_2d(&mw, qn, N, D, BK) ||
      !make_map_3d(&mi, dg, B, N, D, BK) || !make_map_3d(&mo, dtn, B, L, D, 64))
    return cudaErrorInvalidValue;
  return run<EPI_BIAS, GEMM_DTN>(ma, mw, mo, mo, mi, g, stream);
}

cudaError_t gemm_sm90_vlc_g(const void* a, const void* tn, float* out, int N, int Ar, int B,
                            int L, int Lp, int D, bool add, cudaStream_t stream) {
  if (D % 8 || Ar % 64 || Lp % 64 || N > Ar || L > Lp) return cudaErrorInvalidValue;
  if (B == 0 || N == 0) return cudaSuccess;
  GemmArgs g{a, tn, nullptr, nullptr, nullptr, 0.f, nullptr, nullptr, out, N, D, Lp};
  g.batch = B;
  // A: the first N of image b's Ar rows of a (B, Ar, Lp), K-major; B: tn[b] (L, D),
  // MN-major, its rows past L zeros; out (B, N, D) fp32, its rows past N not written;
  // with add, out's tile comes into the staging tile first (3-D, 64-row boxes)
  CUtensorMap ma, mw, mo;
  if (!make_map_3d(&ma, a, B, Ar, Lp, BM) || !make_map_3d(&mw, tn, B, L, D, BK) ||
      !make_map_3d(&mo, out, B, N, D, 64, true))
    return cudaErrorInvalidValue;
  return add ? run<EPI_ADDF_F32, GEMM_BFWD>(ma, mw, mo, mo, mo, g, stream)
             : run<EPI_F32, GEMM_BFWD>(ma, mw, mo, mo, ma, g, stream);
}

}  // namespace rz
