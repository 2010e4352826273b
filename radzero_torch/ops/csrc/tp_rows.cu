// The row kernel of K3 and K4 over a model axis: tp_rows_kernel, after the
// all-reduce of a row-parallel product (ops/fused_layer.py fused_postattn_tp
// and fused_mpnet_post_tp compose it with the products of gemm_sm90.cu /
// gemm.cuh and the all-reduce of parallel/collectives.py).
//
// It replaces no TPU kernel of its own. Under the JAX package's tensor-
// parallel rules (radzero_tpu/parallel/sharding_rules.py) the o-proj and fc2
// of K3 (fused_postattn, radzero_tpu/ops/fused_layer.py:913) and of K4
// (_mpnet_post_call, :760) split on their input dimension: each rank's
// product is an fp32 partial sum that only an all-reduce completes. The bias,
// LayerScale, residual and LayerNorm that the unsplit chains run in those
// products' epilogues (gemm.cuh EPI_RESID_F32, EPI_RESID_OUT, EPI_ADD_F32,
// EPI_ADDF_F32) and in the row passes after them cannot run before the sum,
// so they run here, once the sum is whole. The bias is added once, after the
// sum. One kernel serves the four places of the forward:
//   K3 begin  u = x + ls1 (acc + bo)   out_u = u (fp32, y32), out_t = LN2(u)
//   K3 end    u = y32 + ls2 (acc + b2) out_t = u
//   K4 begin  u = x + (acc + bo)       out_t = LN(u) and out_f = LN(u) (fp32), from
//                                      one fp32 value, as K4's and K9's chains write y
//   K4 end    u = y32 + (acc + b2)     out_t = LN(u)
// and the backward chains split at their all-reduces (fused_postattn_bwd_tp,
// fused_mpnet_post_bwd_tp: K8 and K9 of radzero_tpu/ops/fused_layer.py:568
// and :820 over a model axis), which keep the forward's sums and rerun these
// rows on them in place of the forward's products:
//   K3 begin again, out_v = acc + bo (fp32 proj, K8's d ls1 reads it)
//   K3 end with out_v = acc + b2 alone (fp32 m, K8's d ls2 reads it; no out_t)
//   K4 end with out_u = u alone (fp32 v, the output LN's input)
//   K9's dyln = dv + acc: base dv (fp32), no bias, out_u alone
// out_t is in the operand type (rounded once in bf16). u is computed with
// rounded adds and multiplies in that order (no contraction into an FMA), as
// the plain twin's elementwise ops compute it; the LayerNorm is fp32, two
// passes over the registers (biased variance, eps inside the rsqrt).
//
// What bounds it on the H100: bytes. A row reads its residual (2 or 4 bytes a
// column) and the fp32 sum (4) and writes 2-8 bytes a column, with a few
// operations a byte. So it streams as ln_rows_kernel of fused_layer_bwd.cu
// does, on the same building blocks (rows.cuh): a warp a row, a lane 16-byte
// vectors of 8 columns, neighbouring lanes on neighbouring vectors, the whole
// row (D <= 1024) in registers, so every byte is read once and written once,
// and the LayerNorm statistics from the same row_stats.
#include "common.cuh"
#include "rows.cuh"

namespace rz {
namespace tp {

constexpr int RT = 256;  // threads a block: 8 rows
using rows::chunk_col, rows::load8, rows::MAX_D, rows::row_stats, rows::store8, rows::VEC;

struct TpRowsArgs {
  const void* base;  // (M, D) the residual: operand type, or fp32 (y32)
  const float* acc;  // (M, D) fp32: the all-reduced partial products
  const void* bias;  // (D,) operand type, added once, or null for none
  const void* ls;    // (D,) operand type LayerScale, or null for none
  const void* ln_s;  // (D,) LayerNorm scale and bias, operand type, or null for none
  const void* ln_b;
  void* out_t;       // (M, D) operand type: LN(u), or u without a LayerNorm; or null
  float* out_u;      // (M, D) fp32 u, or null
  float* out_f;      // (M, D) fp32 LN(u), or null
  float* out_v;      // (M, D) fp32 v = acc + bias, or null
  int M, D;
  float eps;
};

template <typename T, typename TB, int NC, bool LN>
__global__ void __launch_bounds__(RT) tp_rows_kernel(TpRowsArgs p) {
  const int lane = threadIdx.x % 32, m = blockIdx.x * (RT / 32) + threadIdx.x / 32;
  if (m >= p.M) return;
  const size_t row = (size_t)m * p.D;
  const TB* base = static_cast<const TB*>(p.base);
  const T* bias = static_cast<const T*>(p.bias);
  const T* ls = static_cast<const T*>(p.ls);
  T* out_t = static_cast<T*>(p.out_t);
  float u[NC][VEC];
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    const int c = chunk_col(j, lane);
    if (c >= p.D) continue;
    float x[VEC], a[VEC], b[VEC], s[VEC], v[VEC];
    load8(base + row + c, x);
    load8(p.acc + row + c, a);
    if (bias != nullptr) load8(bias + c, b);
    if (ls != nullptr) load8(ls + c, s);
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      v[k] = bias != nullptr ? __fadd_rn(a[k], b[k]) : a[k];
      u[j][k] = __fadd_rn(x[k], ls != nullptr ? __fmul_rn(s[k], v[k]) : v[k]);
    }
    if (p.out_v != nullptr) store8(p.out_v + row + c, v);
    if (p.out_u != nullptr) store8(p.out_u + row + c, u[j]);
    if (!LN && out_t != nullptr) store8(out_t + row + c, u[j]);
  }
  if (!LN) return;
  float mean, rstd;
  row_stats<NC>(u, p.D, p.eps, lane, mean, rstd);
  const T* lns = static_cast<const T*>(p.ln_s);
  const T* lnb = static_cast<const T*>(p.ln_b);
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    const int c = chunk_col(j, lane);
    if (c >= p.D) continue;
    float sc[VEC], b[VEC], y[VEC];
    load8(lns + c, sc);
    load8(lnb + c, b);
#pragma unroll
    for (int k = 0; k < VEC; ++k) y[k] = (u[j][k] - mean) * rstd * sc[k] + b[k];
    if (out_t != nullptr) store8(out_t + row + c, y);
    if (p.out_f != nullptr) store8(p.out_f + row + c, y);
  }
}

template <typename T, typename TB, int NC>
void launch(const TpRowsArgs& p, cudaStream_t s) {
  const int blocks = (p.M + RT / 32 - 1) / (RT / 32);
  if (p.ln_s != nullptr)
    tp_rows_kernel<T, TB, NC, true><<<blocks, RT, 0, s>>>(p);
  else
    tp_rows_kernel<T, TB, NC, false><<<blocks, RT, 0, s>>>(p);
}

template <typename T, typename TB>
cudaError_t tp_rows(const TpRowsArgs& p, cudaStream_t s) {
  switch ((p.D + 32 * VEC - 1) / (32 * VEC)) {
    case 1: launch<T, TB, 1>(p, s); break;
    case 2: launch<T, TB, 2>(p, s); break;
    case 3: launch<T, TB, 3>(p, s); break;
    case 4: launch<T, TB, 4>(p, s); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace tp
}  // namespace rz

using bf16 = __nv_bfloat16;

// The row kernel, see the head of this file: v = acc + bias (bias null: acc), u =
// base + ls v (ls null: base + v) per row -> out_v (fp32 v, or null), out_u (fp32 u, or
// null), out_t (operand type: LN(u) with ln_s / ln_b, else u; or null) and out_f (fp32
// LN(u), or null). base is fp32 when base_f32. D % 8 == 0, 8 <= D <= 1024, 16-byte
// aligned rows; M >= 0.
extern "C" int rz_tp_rows(const void* base, int base_f32, const void* acc, const void* bias,
                          const void* ls, const void* ln_s, const void* ln_b, void* out_t,
                          void* out_u, void* out_f, void* out_v, int M, int D, float eps,
                          int dtype, void* stream) {
  if (D < rz::tp::VEC || D % rz::tp::VEC || D > rz::tp::MAX_D || M < 0 ||
      (ln_s == nullptr) != (ln_b == nullptr) || (out_f != nullptr && ln_s == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0) return static_cast<int>(cudaSuccess);
  rz::tp::TpRowsArgs p{base, static_cast<const float*>(acc), bias, ls, ln_s, ln_b, out_t,
                       static_cast<float*>(out_u), static_cast<float*>(out_f),
                       static_cast<float*>(out_v), M, D, eps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype != RZ_DTYPE_BF16)
    err = rz::tp::tp_rows<float, float>(p, s);
  else if (base_f32)
    err = rz::tp::tp_rows<bf16, float>(p, s);
  else
    err = rz::tp::tp_rows<bf16, bf16>(p, s);
  return static_cast<int>(err);
}
