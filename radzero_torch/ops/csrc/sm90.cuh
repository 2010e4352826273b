// Hopper building blocks of the sm_90a attention kernels (flash_fwd_sm90.cu,
// flash_bwd_sm90.cu): mbarriers whose waits trap instead of hanging, TMA
// loads through 4-D tensor maps, wgmma shared-memory descriptors and the
// products the kernels issue, exp2, bf16 packing, and the named barriers by
// which two consumer warpgroups take turns.
//
// Every operand tile is BOX rows of one 64-wide bf16 head (128 bytes a row)
// under the 128-byte swizzle, 1024-byte aligned in shared memory.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums only: the encoder comes through the runtime

#include "common.cuh"

namespace rz {
namespace fa {
namespace sm90 {

constexpr int HD = 64;                  // head dim: one 128-byte bf16 row, the swizzle's width
constexpr int BOX = 128;                // rows of every TMA box
constexpr int TILE = BOX * HD * 2;      // bytes of one box
constexpr int CONSUMERS = 256;          // threads of the two consumer warpgroups
constexpr long long kWatchdogCycles = 1ll << 35;  // ~19 s at 1.8 GHz: a lost barrier phase traps

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// wait for the completion of the barrier's phase of this parity; a phase that
// never completes (a broken ring) traps instead of hanging the card
__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  long long t0 = -1;
  while (true) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    const long long now = clock64();
    if (t0 < 0) t0 = now;
    else if (now - t0 > kWatchdogCycles) __trap();
  }
}

// one (64, 1, BOX, 1) box of a 4-D (64, H, L, B) map at (0, h, row, b) -> dst
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int h, int row, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(0), "r"(h), "r"(row), "r"(b)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle; offsets in 16-byte units:
// a K-major tile (rows along M or N, the head dim contiguous) takes lbo 1
// (unused) and sbo 64 (1024 bytes between 8-row groups); an MN-major tile
// (rows along K) takes 64 for both (one swizzle atom spans the 64 columns,
// 8-row groups 1024 bytes apart). A k-step of 16 advances a K-major
// descriptor by 2 (32 bytes) and an MN-major one by 128 (16 rows).
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr >> 4) & 0x3FFF) | ((uint64_t)lbo << 16) | ((uint64_t)sbo << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
__device__ __forceinline__ void wg_wait_one() {  // all but the newest group are in
  asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
}

// keep the compiler from touching accumulator registers across the
// asynchronous wgmma: reads stay after the wait, writes before the fence
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// keep register A operands alive until the wgmma that reads them is in
template <int N>
__device__ __forceinline__ void hold(const uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" ::"r"(r[i]) : "memory");
}

#define RZ_ACC8(d, i)                                                                       \
  "+f"(d[i + 0]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),           \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (64 x 128 fp32) (+)= A (64 x 16, smem, K-major) . B (16 x 128, smem, K-major)
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : RZ_ACC8(d, 0), RZ_ACC8(d, 8), RZ_ACC8(d, 16), RZ_ACC8(d, 24), RZ_ACC8(d, 32),
        RZ_ACC8(d, 40), RZ_ACC8(d, 48), RZ_ACC8(d, 56)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64 fp32) (+)= A (64 x 16, smem, K-major) . B (16 x 64, smem, K-major)
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : RZ_ACC8(d, 0), RZ_ACC8(d, 8), RZ_ACC8(d, 16), RZ_ACC8(d, 24)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64 fp32) += A (64 x 16 bf16, registers) . B (16 x 64, smem, MN-major)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : RZ_ACC8(d, 0), RZ_ACC8(d, 8), RZ_ACC8(d, 16), RZ_ACC8(d, 24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef RZ_ACC8

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // round to nearest even
  return *reinterpret_cast<const uint32_t*>(&v);
}

// named barriers 1 and 2 order the two consumer warpgroups' issue of products
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "n"(CONSUMERS) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "n"(CONSUMERS) : "memory");
}

using EncodeFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                              const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                              const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up once through the runtime's entry-point query (no -lcuda)
inline EncodeFn encoder() {
  static const EncodeFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeFn>(p)
               : nullptr;
  }();
  return fn;
}

// a (B, L, H, 64) bf16 operand with batch / row strides bs, rs (elements) as a
// 4-D map (64, H, L, B) read in (64, 1, BOX, 1) boxes under the 128-byte
// swizzle; rows past L come in as zeros
inline bool make_map(CUtensorMap* map, const void* p, long long bs, long long rs, int B, int L,
                     int H) {
  const EncodeFn encode = encoder();
  if (encode == nullptr) return false;
  if (L == 1) rs = (long long)H * HD;  // a stride of a dimension of one is never stepped
  if (B == 1) bs = rs * L;
  const cuuint64_t dims[4] = {(cuuint64_t)HD, (cuuint64_t)H, (cuuint64_t)L, (cuuint64_t)B};
  const cuuint64_t strides[3] = {HD * 2, (cuuint64_t)rs * 2, (cuuint64_t)bs * 2};
  const cuuint32_t box[4] = {HD, 1, BOX, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(p), dims, strides, box,
                unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace sm90
}  // namespace fa
}  // namespace rz
