// K12 vlcabs_train_bwd_dtn in bf16 for Hopper: the gradient of the
// normalised tokens in two phases, after the backward's row pass of
// vlcabs_train.cu (dg from the forward's g) and with the forward's row max.
//
// Replaces the TPU kernel radzero_tpu/ops/pallas_vlcabs.py _train_bwd's
// second pallas_call (_kernel_bwd_dtn, :403), with its contract: per image
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
constexpr size_t SMEM = BAR_OFF + 8 * 2 * STAGES + 1024;  // + room to align
static_assert(SMEM <= 232448, "over the 227 KB a block can have");
}  // namespace p1

// grid: min(work items, SMs); ce as a 3-D map (Lp, 2 Np, B) in 64 x 64 boxes
__global__ void __launch_bounds__(p1::THREADS, 1)
vlc_dtn_phase1_sm90_kernel(const __grid_constant__ CUtensorMap mq,
                           const __grid_constant__ CUtensorMap mt,
                           const __grid_constant__ CUtensorMap mg,
                           const __grid_constant__ CUtensorMap mo,
                           const float* __restrict__ rowmax, const float* __restrict__ tau, int N,
                           int Np, int B, int L, int Lp, int D) {
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
    if (wg == 0) {
      float m[2];
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
  }
  if (leader) bulk_wait_read();  // the shared memory outlives the last stores' reads
}

}  // namespace vt
}  // namespace rz

static bool vt_sm90_ok(int N, int Np, int L, int Lp, int D) {
  return D % 64 == 0 && Np % 64 == 0 && Lp % 64 == 0 && N <= Np && L <= Lp && N > 0 && L > 0;
}

// K12 phase 1 (bf16): qn (N, D), tn (B, L, D), dg (B, N, D), rowmax (B, N) fp32 and
// tau (1,) fp32 -> ce (B, 2 Np, Lp): dc rows, then e rows, zeros past N and L
extern "C" int rz_vlcabs_dtn_phase1(const void* qn, const void* tn, const void* dg,
                                    const void* rowmax, const void* tau, void* ce, int N, int Np,
                                    int B, int L, int Lp, int D, void* stream) {
  using namespace rz::vt;
  if (!vt_sm90_ok(N, Np, L, Lp, D)) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  CUtensorMap mq, mt, mg, mo;
  if (!make_map_2d(&mq, qn, N, D, p1::QT) || !make_map_3d(&mt, tn, B, L, D, p1::LT) ||
      !make_map_3d(&mg, dg, B, N, D, p1::QT) || !make_map_3d(&mo, ce, B, 2 * Np, Lp, 64))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = rz::allow_smem(vlc_dtn_phase1_sm90_kernel, p1::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return static_cast<int>(err);
  const int items = B * (Np / p1::QT) * ((L + p1::LT - 1) / p1::LT);
  vlc_dtn_phase1_sm90_kernel<<<items < sms ? items : sms, p1::THREADS, p1::SMEM,
                               static_cast<cudaStream_t>(stream)>>>(
      mq, mt, mg, mo, static_cast<const float*>(rowmax), static_cast<const float*>(tau), N, Np, B,
      L, Lp, D);
  return static_cast<int>(cudaGetLastError());
}

// K12 phase 2 (bf16): dtn (B, L, D) = ce[b]^T . [qn; dg[b]] per image, rounded once
extern "C" int rz_vlcabs_dtn_phase2(const void* ce, const void* qn, const void* dg, void* dtn,
                                    int N, int Np, int B, int L, int Lp, int D, void* stream) {
  if (!vt_sm90_ok(N, Np, L, Lp, D)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      rz::gemm_sm90_dtn(ce, qn, dg, dtn, N, Np, B, L, Lp, D, static_cast<cudaStream_t>(stream)));
}
