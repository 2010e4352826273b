// The bf16 GEMM of K1 fused_preattn and K3 fused_postattn for Hopper:
// rz_fused_preattn and rz_fused_postattn (fused_layer.cu) call it for every
// bf16 operand, after a row pass that writes each row's LayerNorm once as a
// bf16 operand (row_layernorm_kernel). fp32 stays on gemm_f32_kernel and K4
// and the backward chains K6, K8 and K9 on gemm_bf16_kernel (gemm.cuh).
//
// Replaces the products of the TPU kernels radzero_tpu/ops/fused_layer.py
// fused_preattn (_preattn_kernel, the pallas_call at :92) and fused_postattn
// (_postattn_kernel, :913), with their contract: bf16 operands, fp32
// accumulation, the epilogue in fp32 on the accumulators (bias, LayerScale,
// residual, exact-erf GELU), rounded to bf16 where the JAX code rounds (qkv,
// the GELU output, the layer output; K3's y stays fp32). Rows are masked,
// never padded.
//
// What bounds it on the H100: the tensor cores. At 8 images (M = 10 960) K1
// does 2 M 768 2304 operations and K3 2 M 768 (768 + 2 3072), 39 and 118 us at
// 989 TFLOP/s, against 3.35 TB/s for their operands and outputs. What holds
// it at 1.5-1.8x its cuBLAS products (ops/ablate_sm90.py gemm) is not the
// products, whose removal leaves the qkv and fc2 times as they were, but the
// ring, which turns a 32 KB stage round in ~0.4 us an SM at any depth, and
// fc1's exact-erf epilogue, which no product overlaps.
//
// Design (C = A . W, 128 x 128 output tiles, column tiles fastest so that the
// blocks in flight share an A row tile in L2; a persistent grid of one
// 288-thread block per SM walks the tiles with a stride of the grid):
// - A ninth warp is the producer: one thread keeps a ring of STAGES 64-deep
//   k-steps in flight by TMA, each stage with a full and an empty mbarrier,
//   running on into the next tile while the consumers finish the last. A is
//   (M, K) row-major, a K-major operand: one 128 x 64 box. W is (K, N)
//   row-major, an MN-major B operand (the descriptor's transpose bit): two
//   64 x 64 boxes side by side, the two 64-column swizzle atoms of the tile,
//   8 KB apart (the descriptor's leading byte offset). Rows past M, columns
//   past N and k past K come in as zeros, so K needs no multiple of 64; a box
//   wholly past N is not loaded. Under a 384-thread block (a producer
//   warpgroup) ptxas held the kernel to 168 registers and the GELU epilogue
//   spilled; under 288 threads it takes 163 and spills nothing.
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
//   the store drains. The residual (x for K3's o-proj, y32 for its fc2) comes
//   by TMA into shared memory too, loaded by the producer while the tile's
//   products run. Without this, scattered 4- and 8-byte stores and loads of
//   the epilogue took 40% of the kernel's time (ops/ablate_sm90.py gemm).
// Every mbarrier wait traps after ~19 s instead of hanging the card.
#include "gemm_sm90.cuh"
#include "sm90.cuh"

namespace rz {
namespace {

using namespace fa::sm90;
using bf16 = __nv_bfloat16;

// The GEMM's own Hopper helpers (2-D tensor maps, TMA stores, the product with
// an MN-major B), beside the attention kernels' in sm90.cuh.

// one (128-byte, rows) box of a 2-D (cols, rows) map at column c, row r -> dst
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c, int r) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c), "r"(r)
      : "memory");
}

// one box of shared memory at src -> a 2-D map at column c, row r (asynchronous:
// bulk_commit, then bulk_wait_read before src is written again); rows and
// columns past the map's ends are not written
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, uint32_t src, int c, int r) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c), "r"(r)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}
__device__ __forceinline__ void bulk_wait_read() {  // the stores have read their shared memory
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}
// this thread's writes to shared memory, visible to the TMA unit (the async proxy)
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

#define RZ_ACC8(d, i)                                                                       \
  "+f"(d[i + 0]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),           \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (64 x 128 fp32) (+)= A (64 x 16, smem, K-major) . B (16 x 128, smem, MN-major: the
// transpose bit). The descriptor of an MN-major B takes sbo 64 (8-row groups along K
// 1024 bytes apart) and as lbo the distance between its 64-column swizzle atoms along
// N: 512 here, two 8 KB boxes of 64 rows side by side. A k-step of 16 advances it by
// 128 (16 rows), a K-major A by 2 (32 bytes).
__device__ __forceinline__ void wgmma_ss_n128_mn(float (&d)[64], uint64_t da, uint64_t db,
                                                 int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n}\n"
      : RZ_ACC8(d, 0), RZ_ACC8(d, 8), RZ_ACC8(d, 16), RZ_ACC8(d, 24), RZ_ACC8(d, 32),
        RZ_ACC8(d, 40), RZ_ACC8(d, 48), RZ_ACC8(d, 56)
      : "l"(da), "l"(db), "r"(accumulate));
}

#undef RZ_ACC8

// a row-major (rows, cols) bf16 or fp32 matrix as a 2-D map (cols, rows) read
// or written in boxes of 128 bytes of a row (64 bf16 or 32 fp32 values) by
// box_rows rows under the 128-byte swizzle; rows and columns past the ends
// come in as zeros and are not written. cols * esize % 16 == 0 and a 16-byte
// aligned base (TMA's stride and address rules).
bool make_map_2d(CUtensorMap* map, const void* p, int rows, int cols, int box_rows,
                 bool fp32 = false) {
  const EncodeFn encode = encoder();
  if (encode == nullptr) return false;
  const cuuint64_t esize = fp32 ? 4 : 2;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * esize};
  const cuuint32_t box[2] = {(cuuint32_t)(128 / esize), (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, fp32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                const_cast<void*>(p), dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

constexpr int BM = 128, BN = 128, BK = 64;  // output tile, k-step
constexpr int THREADS = 288;                 // two consumer warpgroups + one producer warp
constexpr int A_BYTES = BM * BK * 2;         // one 128 x 64 box
constexpr int W_BOX = BK * 64 * 2;           // one 64 x 64 box: half the W tile
constexpr int STAGE_BYTES = A_BYTES + 2 * W_BOX;

// shared memory of one epilogue: the ring, the output tile staged for the TMA
// store (fp32 for K3's y32, else bf16), the residual tile (x in bf16, y32 in
// fp32) where the epilogue has one, then the barriers
template <int EPI>
struct Layout {
  static constexpr bool RESID = EPI == EPI_RESID_F32 || EPI == EPI_RESID_OUT;
  static constexpr int OUT_ES = EPI == EPI_RESID_F32 ? 4 : 2;  // bytes an output value
  static constexpr int RES_ES = EPI == EPI_RESID_OUT ? 4 : 2;  // bytes a residual value
  static constexpr int STAGES = RESID ? 4 : 5;                 // k-steps in flight
  static constexpr int OUT_OFF = STAGES * STAGE_BYTES;
  static constexpr int OUT_WG = 64 * BN * OUT_ES;              // one warpgroup's 64 rows
  static constexpr int RES_OFF = OUT_OFF + 2 * OUT_WG;
  static constexpr int BAR_OFF = RES_OFF + (RESID ? BM * BN * RES_ES : 0);
  static constexpr size_t SMEM = BAR_OFF + 8 * (2 * STAGES + 2) + 1024;  // + room to align
  static_assert(SMEM <= 232448, "over the 227 KB a block can have");
};

// byte offset of value (r, c) in a tile of ES-byte values kept as boxes of
// `rows` rows x 128 bytes under the 128-byte swizzle (as TMA reads and writes them)
template <int ES>
__device__ __forceinline__ uint32_t swz(int rows, int r, int c) {
  const int byte = c * ES, cb = byte & 127;
  return (byte >> 7) * rows * 128 + r * 128 + ((((cb >> 4) ^ (r & 7)) << 4) | (cb & 15));
}

__device__ __forceinline__ float2 pair(const void* p, int n) {
  return p == nullptr ? make_float2(0.f, 0.f)
                      : __bfloat1622float2(
                            *reinterpret_cast<const __nv_bfloat162*>(static_cast<const bf16*>(p) + n));
}

// the 128 threads of consumer warpgroup wg (named barriers 1 and 2)
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
}

template <int EPI>
__global__ void __launch_bounds__(THREADS, 1)
gemm_sm90_kernel(const __grid_constant__ CUtensorMap ma, const __grid_constant__ CUtensorMap mw,
                 const __grid_constant__ CUtensorMap mo, const __grid_constant__ CUtensorMap mr,
                 const GemmArgs g) {
  using Lay = Layout<EPI>;
  constexpr int STAGES = Lay::STAGES;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t bars = base + Lay::BAR_OFF;  // full[STAGES], empty[STAGES], rfull, rempty
  const uint32_t rfull = bars + 16 * STAGES, rempty = rfull + 8;
  auto full = [&](int it) { return bars + 8 * (it % STAGES); };
  auto empty = [&](int it) { return bars + 8 * (STAGES + it % STAGES); };
  auto stage = [&](int it) { return base + STAGE_BYTES * (it % STAGES); };
  const int tiles_n = (g.N + BN - 1) / BN;
  const int tiles = tiles_n * ((g.M + BM - 1) / BM);
  const int ksteps = (g.K + BK - 1) / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      bar_init(full(s), 1);
      bar_init(empty(s), CONSUMERS);
    }
    bar_init(rfull, 1);
    bar_init(rempty, CONSUMERS);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {  // the producer warp: one thread keeps the ring full
    if (threadIdx.x == CONSUMERS) {
      int it = 0;  // position in the ring over every k-step of every tile
      for (int t = blockIdx.x, lt = 0; t < tiles; t += gridDim.x, ++lt) {
        const int m0 = (t / tiles_n) * BM, n0 = (t % tiles_n) * BN;
        const bool right = n0 + 64 < g.N;  // the tile's second 64 columns hold any of W
        for (int ks = 0; ks < ksteps; ++ks, ++it) {
          bar_wait(empty(it), ((it / STAGES) & 1) ^ 1);  // stage released by both consumers
          bar_expect_tx(full(it), A_BYTES + (right ? 2 : 1) * W_BOX);
          tma_load_2d(stage(it), &ma, full(it), ks * BK, m0);
          tma_load_2d(stage(it) + A_BYTES, &mw, full(it), n0, ks * BK);
          if (right) tma_load_2d(stage(it) + A_BYTES + W_BOX, &mw, full(it), n0 + 64, ks * BK);
          // the residual tile, once the consumers are past the last tile's epilogue
          // (they have released this tile's first stage), in time for this one's
          if (Lay::RESID && ks == (ksteps - 1 < STAGES ? ksteps - 1 : STAGES)) {
            constexpr int COLS = 128 / Lay::RES_ES, BOX = BM * 128;
            int boxes = 0;
            for (int b = 0; b < BN / COLS; ++b) boxes += n0 + b * COLS < g.N;
            bar_wait(rempty, (lt & 1) ^ 1);
            bar_expect_tx(rfull, boxes * BOX);
            for (int b = 0; b < boxes; ++b)
              tma_load_2d(base + Lay::RES_OFF + b * BOX, &mr, rfull, n0 + b * COLS, m0);
          }
        }
      }
    }
    return;
  }

  const int ct = threadIdx.x;
  const int wg = ct / 128, warp = (ct % 128) / 32, lane = ct % 32, quad = lane % 4;
  const bool leader = ct % 128 == 0;  // issues its warpgroup's TMA stores
  const uint32_t stg = base + Lay::OUT_OFF + wg * Lay::OUT_WG;  // its 64 rows, staged
  const int rl = warp * 16 + lane / 4;  // its first row in the warpgroup's 64
  float acc[64];  // rows rl (+ 8), columns 8 j + 2 quad (+ 1): acc[4 j + 2 i + e]
  int it = 0;
  for (int t = blockIdx.x, lt = 0; t < tiles; t += gridDim.x, ++lt) {
    const int m0 = (t / tiles_n) * BM, n0 = (t % tiles_n) * BN;
    for (int ks = 0; ks < ksteps; ++ks, ++it) {
      bar_wait(full(it), (it / STAGES) & 1);
      const uint64_t da = desc(stage(it) + wg * 64 * 128, 1, 64);  // this warpgroup's 64 rows
      const uint64_t dw = desc(stage(it) + A_BYTES, W_BOX / 16, 64);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_ss_n128_mn(acc, da + 2 * kk, dw + 128 * kk, ks > 0 || kk > 0);
      wg_commit();
      if (ks > 0) {  // the last k-step's products are in: its stage is free
        wg_wait_one();
        bar_arrive(empty(it - 1));
      }
    }
    wg_wait_all();
    pin(acc);
    bar_arrive(empty(it - 1));

    // epilogue: the values into the staging tile, then one TMA store per box
    if (Lay::RESID) bar_wait(rfull, lt & 1);
    if (leader) bulk_wait_read();  // the last tile's stores have read the staging tile
    wg_sync(wg);
    const uint32_t res = base + Lay::RES_OFF;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int c = 8 * j + 2 * quad, gn = n0 + c;
      const bool in = gn < g.N;  // N % 8 == 0: an 8-column group is wholly in or out
      const float2 b = in ? pair(g.bias, gn) : make_float2(0.f, 0.f);
      const float2 ls = Lay::RESID && in ? pair(g.ls, gn) : make_float2(0.f, 0.f);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = rl + 8 * i;
        const float v0 = acc[4 * j + 2 * i] + b.x, v1 = acc[4 * j + 2 * i + 1] + b.y;
        if (EPI == EPI_RESID_F32) {  // y32 = x + ls (acc + b)
          uint32_t xb;
          asm volatile("ld.shared.b32 %0, [%1];" : "=r"(xb) : "r"(res + swz<2>(BM, wg * 64 + r, c)));
          const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xb));
          asm volatile("st.shared.v2.f32 [%0], {%1, %2};" ::"r"(stg + swz<4>(64, r, c)),
                       "f"(x.x + ls.x * v0), "f"(x.y + ls.y * v1));
        } else {
          float o0 = v0, o1 = v1;
          if (EPI == EPI_GELU) {
            o0 = v0 * gelu_phi(v0);
            o1 = v1 * gelu_phi(v1);
          } else if (EPI == EPI_RESID_OUT) {  // out = y32 + ls (acc + b)
            float y0, y1;
            asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];"
                         : "=f"(y0), "=f"(y1) : "r"(res + swz<4>(BM, wg * 64 + r, c)));
            o0 = y0 + ls.x * v0;
            o1 = y1 + ls.y * v1;
          }
          asm volatile("st.shared.b32 [%0], %1;" ::"r"(stg + swz<2>(64, r, c)),
                       "r"(pack_bf16(o0, o1)));
        }
      }
    }
    if (Lay::RESID) bar_arrive(rempty);  // this thread has read its share of the residual
    fence_async_smem();
    wg_sync(wg);
    if (leader && m0 + wg * 64 < g.M) {
      constexpr int COLS = 128 / Lay::OUT_ES;
#pragma unroll
      for (int b = 0; b < BN / COLS; ++b)
        if (n0 + b * COLS < g.N) tma_store_2d(&mo, stg + b * 64 * 128, n0 + b * COLS, m0 + wg * 64);
      bulk_commit();
    }
  }
  if (leader) bulk_wait_read();  // the shared memory outlives the last stores' reads
}

template <int EPI>
cudaError_t launch(const GemmArgs& g, cudaStream_t stream) {
  using Lay = Layout<EPI>;
  CUtensorMap ma, mw, mo, mr;  // A, W, the output, the residual (A's map where there is none)
  if (!make_map_2d(&ma, g.a, g.M, g.K, BM) || !make_map_2d(&mw, g.w, g.K, g.N, BK) ||
      !make_map_2d(&mo, g.out, g.M, g.N, 64, Lay::OUT_ES == 4))
    return cudaErrorInvalidValue;
  mr = ma;
  if (Lay::RESID && !make_map_2d(&mr, g.resid, g.M, g.N, BM, Lay::RES_ES == 4))
    return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(gemm_sm90_kernel<EPI>, Lay::SMEM);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  const int tiles = ((g.M + BM - 1) / BM) * ((g.N + BN - 1) / BN);
  gemm_sm90_kernel<EPI><<<tiles < sms ? tiles : sms, THREADS, Lay::SMEM, stream>>>(ma, mw, mo, mr,
                                                                                   g);
  return cudaGetLastError();
}

}  // namespace

cudaError_t gemm_sm90(const GemmArgs& g, int epi, cudaStream_t stream) {
  if (g.K % 8 || g.N % 8) return cudaErrorInvalidValue;
  if (g.M == 0) return cudaSuccess;
  switch (epi) {
    case EPI_BIAS: return launch<EPI_BIAS>(g, stream);
    case EPI_RESID_F32: return launch<EPI_RESID_F32>(g, stream);
    case EPI_GELU: return launch<EPI_GELU>(g, stream);
    case EPI_RESID_OUT: return launch<EPI_RESID_OUT>(g, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace rz
