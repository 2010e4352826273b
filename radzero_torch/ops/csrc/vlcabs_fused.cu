// K5 vlcabs_fused for Hopper: zero-shot logits and pre-softmax maps.
//
// Replaces the TPU kernel radzero_tpu/ops/pallas_vlcabs.py:vlcabs_fused
// (_kernel). Per image b and query n, with q pre-normalised:
//   tn    = t * rsqrt(sum(t^2) + 1e-24)       fp32, rounded to the operand type
//   s     = (q . tn) / tau                    fp32 accumulation, written raw
//   e     = exp(s - rowmax(s))                rounded to the operand type
//   agg   = e . tn                            fp32 accumulation
//   logit = (q . agg) / max(|agg|, 1e-12)
//
// What bounds it on the H100, and what the design does about it: the
// TPU kernel holds one image's whole normalised token set (1408 x 768)
// in VMEM, four times an SM's shared memory in fp32. Here one block per
// (image, block of 16 queries) walks the tokens in 32-row tiles,
// normalises each tile into shared memory, and keeps a running row max;
// when the max grows the fp32 aggregate is rescaled. The logit does not
// change when agg is scaled, so the rescale is exact up to rounding. At
// the serving shapes (14 prompts, 8 images) the work is tiny next to the
// towers and there are only B blocks: it is bound by one block's latency
// walking 1370 tokens, and the products run on CUDA cores in fp32. A
// split over L with a combine pass is later work.
#include "common.cuh"

namespace rz {

constexpr int VQ = 16;        // queries per block
constexpr int VL = 32;        // tokens per tile
constexpr int VT = 256;       // threads per block
constexpr int VMAXC = 4;      // D <= VT * VMAXC columns per thread

template <typename T>
__host__ __device__ constexpr int vl_pitch(int d) {
  return d + (sizeof(T) == 4 ? 1 : 2);  // odd word stride: no bank conflicts
}

template <typename T>
size_t vlcabs_smem(int d) {
  const int p = vl_pitch<T>(d);
  return align_up((size_t)VQ * p * sizeof(T), 16) + align_up((size_t)VL * p * sizeof(T), 16) +
         (VQ * VL + 2 * VQ + 2 * (VT / 32) * VQ) * sizeof(float);
}

// grid (ceil(N / 16), B), 256 threads
template <typename T>
__global__ void __launch_bounds__(VT)
vlcabs_kernel(const T* __restrict__ qn, const T* __restrict__ t, const float* __restrict__ tau,
              float* __restrict__ scores, float* __restrict__ logits, int N, int B, int L,
              int D) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int P = vl_pitch<T>(D);
  T* Qs = reinterpret_cast<T*>(smem);
  T* Ts = reinterpret_cast<T*>(smem + align_up((size_t)VQ * P * sizeof(T), 16));
  float* Es = reinterpret_cast<float*>(smem + align_up((size_t)VQ * P * sizeof(T), 16) +
                                       align_up((size_t)VL * P * sizeof(T), 16));
  float* row_m = Es + VQ * VL;     // running max per query
  float* row_a = row_m + VQ;       // rescale factor of the current tile
  float* red = row_a + VQ;         // (8 warps, VQ, 2) partial sums

  const int n0 = blockIdx.x * VQ, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const T* tb = t + (size_t)b * L * D;
  const float inv_tau = 1.0f / tau[0];

  for (int i = tid; i < VQ * D; i += VT) {
    const int r = i / D, c = i % D;
    Qs[r * P + c] = n0 + r < N ? qn[(size_t)(n0 + r) * D + c] : from_f32<T>(0.f);
  }
  if (tid < VQ) row_m[tid] = -INFINITY;

  float agg[VMAXC][VQ];
#pragma unroll
  for (int i = 0; i < VMAXC; ++i)
#pragma unroll
    for (int r = 0; r < VQ; ++r) agg[i][r] = 0.f;

  for (int l0 = 0; l0 < L; l0 += VL) {
    // (a) stage and row-normalise the token tile: 4 rows per warp
    for (int rr = warp * 4; rr < warp * 4 + 4; ++rr) {
      const int tok = l0 + rr;
      float ss = 0.f;
      for (int c = lane; c < D; c += 32) {
        const float x = tok < L ? to_f32(tb[(size_t)tok * D + c]) : 0.f;
        ss += x * x;
        Ts[rr * P + c] = from_f32<T>(x);
      }
      for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
      const float inv = rsqrtf(ss + 1e-24f);
      for (int c = lane; c < D; c += 32)
        Ts[rr * P + c] = from_f32<T>(to_f32(Ts[rr * P + c]) * inv);
    }
    __syncthreads();

    // (b) scores: 2 (query, token) dots per thread
    for (int k = tid; k < VQ * VL; k += VT) {
      const int r = k / VL, j = k % VL, tok = l0 + j;
      float s = 0.f;
      for (int c = 0; c < D; ++c) s = fmaf(to_f32(Qs[r * P + c]), to_f32(Ts[j * P + c]), s);
      s *= inv_tau;
      if (tok < L && n0 + r < N) scores[((size_t)b * N + n0 + r) * L + tok] = s;
      Es[r * VL + j] = tok < L ? s : -INFINITY;
    }
    __syncthreads();

    // (c) running max, rescale factor and e, 2 queries per warp
    for (int r = warp * 2; r < warp * 2 + 2; ++r) {
      const float v = Es[r * VL + lane];
      float tmax = v;
      for (int o = 16; o > 0; o >>= 1) tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, o));
      const float m_old = row_m[r];
      const float m_new = fmaxf(m_old, tmax);
      Es[r * VL + lane] = round_to<T>(exp2f((v - m_new) * kLog2e));
      __syncwarp();
      if (lane == 0) {
        row_a[r] = exp2f((m_old - m_new) * kLog2e);  // 0 on the first tile
        row_m[r] = m_new;
      }
    }
    __syncthreads();

    // (d) agg = agg * a + e . tn, thread-owned columns c = tid + VT * i
#pragma unroll
    for (int i = 0; i < VMAXC; ++i) {
      const int c = tid + VT * i;
      if (c < D) {
#pragma unroll
        for (int r = 0; r < VQ; ++r) agg[i][r] *= row_a[r];
        for (int j = 0; j < VL; ++j) {
          const float tv = to_f32(Ts[j * P + c]);
#pragma unroll
          for (int r = 0; r < VQ; ++r) agg[i][r] = fmaf(Es[r * VL + j], tv, agg[i][r]);
        }
      }
    }
    __syncthreads();
  }

  // logit = (q . agg) / max(|agg|, 1e-12): block reduction per query
#pragma unroll
  for (int r = 0; r < VQ; ++r) {
    float num = 0.f, sq = 0.f;
#pragma unroll
    for (int i = 0; i < VMAXC; ++i) {
      const int c = tid + VT * i;
      if (c < D) {
        num = fmaf(to_f32(Qs[r * P + c]), agg[i][r], num);
        sq = fmaf(agg[i][r], agg[i][r], sq);
      }
    }
    for (int o = 16; o > 0; o >>= 1) {
      num += __shfl_xor_sync(0xffffffffu, num, o);
      sq += __shfl_xor_sync(0xffffffffu, sq, o);
    }
    if (lane == 0) {
      red[(warp * VQ + r) * 2] = num;
      red[(warp * VQ + r) * 2 + 1] = sq;
    }
  }
  __syncthreads();
  if (tid < VQ && n0 + tid < N) {
    float num = 0.f, sq = 0.f;
    for (int w = 0; w < VT / 32; ++w) {
      num += red[(w * VQ + tid) * 2];
      sq += red[(w * VQ + tid) * 2 + 1];
    }
    logits[(size_t)(n0 + tid) * B + b] = num / fmaxf(sqrtf(sq), 1e-12f);
  }
}

template <typename T>
cudaError_t launch_vlcabs(const void* qn, const void* t, const void* tau, void* scores,
                          void* logits, int N, int B, int L, int D, cudaStream_t stream) {
  const size_t smem = vlcabs_smem<T>(D);
  cudaError_t err = allow_smem(vlcabs_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((N + VQ - 1) / VQ, B);
  vlcabs_kernel<T><<<grid, VT, smem, stream>>>(
      static_cast<const T*>(qn), static_cast<const T*>(t), static_cast<const float*>(tau),
      static_cast<float*>(scores), static_cast<float*>(logits), N, B, L, D);
  return cudaGetLastError();
}

}  // namespace rz

// K5: qn (N, D), t (B, L, D), tau (1,) fp32 on the device ->
//     scores (B, N, L) fp32, logits (N, B) fp32
extern "C" int rz_vlcabs_fused(const void* qn, const void* t, const void* tau, void* scores,
                               void* logits, int N, int B, int L, int D, int dtype,
                               void* stream) {
  if (D > rz::VT * rz::VMAXC) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      dtype == RZ_DTYPE_BF16
          ? rz::launch_vlcabs<__nv_bfloat16>(qn, t, tau, scores, logits, N, B, L, D, s)
          : rz::launch_vlcabs<float>(qn, t, tau, scores, logits, N, B, L, D, s);
  return static_cast<int>(err);
}
