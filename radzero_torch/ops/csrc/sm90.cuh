// Hopper building blocks of the sm_90a kernels: mbarriers whose waits trap
// instead of hanging, TMA loads through 4-D tensor maps, wgmma shared-memory
// descriptors and the products the kernels issue, exp2, bf16 packing, and
// the named barriers by which two consumer warpgroups take turns (the
// attention kernels, flash_fwd_sm90.cu and flash_bwd_sm90.cu: every operand
// tile is BOX rows of one 64-wide bf16 head, 128 bytes a row, under the
// 128-byte swizzle, 1024-byte aligned in shared memory); then the GEMM's
// (gemm_sm90.cu, vlcabs_sm90.cu): 2-D and 3-D maps, TMA stores, products
// with either operand MN-major, the staging of an epilogue.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums only: the encoder comes through the runtime
#include <string.h>

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

// cuTensorMapEncodeTiled as every map here takes it (unit element strides, no
// interleave, the 128-byte swizzle, 256-byte L2 promotion, zeros out of bounds),
// with this thread's last encodings kept: a map is a function of its arguments
// alone, and the wrappers hand the same weights and, through PyTorch's caching
// allocator, mostly the same activation buffers from call to call, so a map is
// encoded once and then copied (1024 slots a thread, the slot by a hash of the
// arguments; a slot that another map takes is encoded again when it returns)
inline bool encode_tiled(CUtensorMap* map, CUtensorMapDataType dtype, int rank, const void* p,
                         const cuuint64_t* dims, const cuuint64_t* strides,
                         const cuuint32_t* box) {
  constexpr int KEY = 2 + 4 + 3 + 4, SLOTS = 1024;
  struct Slot {
    uint64_t key[KEY];
    CUtensorMap map;
  };
  thread_local Slot slots[SLOTS] = {};
  uint64_t key[KEY] = {reinterpret_cast<uint64_t>(p), (uint64_t)dtype << 8 | (uint64_t)rank};
  for (int r = 0; r < rank; ++r) {
    key[2 + r] = dims[r];
    key[9 + r] = box[r];
    if (r + 1 < rank) key[6 + r] = strides[r];
  }
  uint64_t h = 1469598103934665603ull;  // FNV-1a, a word at a time
  for (int i = 0; i < KEY; ++i) h = (h ^ key[i]) * 1099511628211ull;
  Slot& slot = slots[(h >> 40) % SLOTS];
  if (key[0] != 0 && memcmp(slot.key, key, sizeof key) == 0) {
    *map = slot.map;
    return true;
  }
  const EncodeFn encode = encoder();
  if (encode == nullptr) return false;
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  if (encode(map, dtype, rank, const_cast<void*>(p), dims, strides, box, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return false;
  memcpy(slot.key, key, sizeof key);
  slot.map = *map;
  return true;
}

// a (B, L, H, 64) bf16 operand with batch / row strides bs, rs (elements) as a
// 4-D map (64, H, L, B) read in (64, 1, BOX, 1) boxes under the 128-byte
// swizzle; rows past L come in as zeros
inline bool make_map(CUtensorMap* map, const void* p, long long bs, long long rs, int B, int L,
                     int H) {
  if (L == 1) rs = (long long)H * HD;  // a stride of a dimension of one is never stepped
  if (B == 1) bs = rs * L;
  const cuuint64_t dims[4] = {(cuuint64_t)HD, (cuuint64_t)H, (cuuint64_t)L, (cuuint64_t)B};
  const cuuint64_t strides[3] = {HD * 2, (cuuint64_t)rs * 2, (cuuint64_t)bs * 2};
  const cuuint32_t box[4] = {HD, 1, BOX, 1};
  return encode_tiled(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, p, dims, strides, box);
}

// ---------------------------------------------------------------------------
// The GEMM's helpers (gemm_sm90.cu; vlcabs_sm90.cu takes them too): 2-D and
// 3-D tensor maps, TMA stores, the product with either operand MN-major, the
// swizzled staging of an epilogue and the consumer warpgroups' barriers.
// ---------------------------------------------------------------------------

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
// the same with an image coordinate b: a 3-D (cols, rows, images) map
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c, int r, int b) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c), "r"(r), "r"(b)
      : "memory");
}
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, uint32_t src, int c, int r,
                                             int b) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c), "r"(r), "r"(b)
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

// d (64 x 128 fp32) (+)= A (64 x 16, smem) . B (16 x 128, smem); TA / TB are the
// transpose bits, 1 for an MN-major operand. A K-major tile takes the descriptor's
// lbo 1 (unused) and sbo 64 (8-row groups 1024 bytes apart) and advances by 2 (32
// bytes) a k-step of 16. An MN-major tile takes sbo 64 (8-row groups along K 1024
// bytes apart) and as lbo the distance between its 64-column swizzle atoms (512 for
// a B of two 8 KB boxes side by side; a 64-row A is one atom) and advances by 128
// (16 rows).
template <int TA, int TB>
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da, uint64_t db,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n}\n"
      : RZ_ACC8(d, 0), RZ_ACC8(d, 8), RZ_ACC8(d, 16), RZ_ACC8(d, 24), RZ_ACC8(d, 32),
        RZ_ACC8(d, 40), RZ_ACC8(d, 48), RZ_ACC8(d, 56)
      : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB));
}

#undef RZ_ACC8

// a row-major (rows, cols) bf16 or fp32 matrix as a 2-D map (cols, rows) read
// or written in boxes of 128 bytes of a row (64 bf16 or 32 fp32 values) by
// box_rows rows under the 128-byte swizzle; rows and columns past the ends
// come in as zeros and are not written. cols * esize % 16 == 0 and a 16-byte
// aligned base (TMA's stride and address rules).
inline bool make_map_2d(CUtensorMap* map, const void* p, int rows, int cols, int box_rows,
                        bool fp32 = false) {
  const cuuint64_t esize = fp32 ? 4 : 2;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * esize};
  const cuuint32_t box[2] = {(cuuint32_t)(128 / esize), (cuuint32_t)box_rows};
  const CUtensorMapDataType dtype =
      fp32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  return encode_tiled(map, dtype, 2, p, dims, strides, box);
}

// `images` row-major (rows, cols) bf16 or fp32 matrices, one after another, as a
// 3-D map (cols, rows, images) read or written in boxes of 128 bytes of a row (64
// bf16 or 32 fp32 values) by box_rows rows of one image under the 128-byte
// swizzle: rows past an image's end come in as zeros and are not written,
// whatever follows them in memory
inline bool make_map_3d(CUtensorMap* map, const void* p, int images, int rows, int cols,
                        int box_rows, bool fp32 = false) {
  const cuuint64_t esize = fp32 ? 4 : 2;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows, (cuuint64_t)images};
  const cuuint64_t strides[2] = {(cuuint64_t)cols * esize, (cuuint64_t)rows * cols * esize};
  const cuuint32_t box[3] = {(cuuint32_t)(128 / esize), (cuuint32_t)box_rows, 1};
  const CUtensorMapDataType dtype =
      fp32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  return encode_tiled(map, dtype, 3, p, dims, strides, box);
}

// byte offset of value (r, c) in a tile of ES-byte values kept as boxes of
// `rows` rows x 128 bytes under the 128-byte swizzle (as TMA reads and writes them)
template <int ES>
__device__ __forceinline__ uint32_t swz(int rows, int r, int c) {
  const int byte = c * ES, cb = byte & 127;
  return (byte >> 7) * rows * 128 + r * 128 + ((((cb >> 4) ^ (r & 7)) << 4) | (cb & 15));
}

__device__ __forceinline__ float2 lds_f2(uint32_t a) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];" : "=f"(v.x), "=f"(v.y) : "r"(a));
  return v;
}
__device__ __forceinline__ float2 lds_bf2(uint32_t a) {
  uint32_t u;
  asm volatile("ld.shared.b32 %0, [%1];" : "=r"(u) : "r"(a));
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}
__device__ __forceinline__ void sts_f2(uint32_t a, float x, float y) {
  asm volatile("st.shared.v2.f32 [%0], {%1, %2};" ::"r"(a), "f"(x), "f"(y));
}
__device__ __forceinline__ void sts_bf2(uint32_t a, float x, float y) {
  asm volatile("st.shared.b32 [%0], %1;" ::"r"(a), "r"(pack_bf16(x, y)));
}

// the 128 threads of consumer warpgroup wg (named barriers 1 and 2)
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
}
// both consumer warpgroups (named barrier 3)
__device__ __forceinline__ void consumers_sync() { asm volatile("bar.sync 3, 256;" ::: "memory"); }

}  // namespace sm90
}  // namespace fa
}  // namespace rz
