// MoE router gating: per token row, softmax over the E expert logits,
// k rounds of argmax-and-mask (a tie goes to the lower expert index),
// then the k chosen probabilities renormalized by max(sum, 1e-9).
//
// Replaces: src/repro/kernels/topk_gating.py, topk_gating (a Pallas grid
// over blocks of block_t token rows with E in the lanes, so each round's
// max is one lane reduction; T had to be a multiple of block_t).
//
// Bound on the H100: memory.  The call reads T * E logits and writes
// T * k weights and ids; at the main path's [4096, 64] float32, k = 8,
// that is 1.3 MB, about 0.4 us at 3.35 TB/s, below a launch, so in
// practice the call is bound by launch latency.
//
// Design: one warp per token row, 8 rows per block of 256 threads, any
// T.  Lane l holds the logits of experts l, l + 32, ... (E <= 256, so at
// most 8 a lane, in registers).  The softmax takes a warp max and a warp
// sum by shuffles.  Each round, every lane proposes its best (value,
// index) and a butterfly of shuffles leaves the winner in every lane,
// comparing values first and taking the lower index on a tie, as
// jnp.argmax does; the owning lane masks the winner with -2e38 (every
// probability is >= 0).  The chosen weights and ids are kept in the
// warp's slice of shared memory and written after the renormalization.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int MAX_E = 256;
constexpr int PER_LANE = MAX_E / 32;
constexpr float NEG_INF = -2.0e38f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__global__ void __launch_bounds__(WARPS * 32)
topk_gating_kernel(const T* __restrict__ logits, float* __restrict__ w_out,
                   int32_t* __restrict__ id_out, int64_t rows, int E, int k) {
  __shared__ float s_w[WARPS][MAX_E];
  __shared__ int32_t s_id[WARPS][MAX_E];
  const int wid = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * WARPS + wid;
  if (row >= rows) return;      // whole warps leave together
  const T* x = logits + row * E;

  float pr[PER_LANE];
  float mx = -CUDART_INF_F;
#pragma unroll
  for (int j = 0; j < PER_LANE; ++j) {
    const int e = lane + 32 * j;
    pr[j] = e < E ? to_f(x[e]) : -CUDART_INF_F;
    mx = fmaxf(mx, pr[j]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < PER_LANE; ++j) {
    pr[j] = lane + 32 * j < E ? expf(pr[j] - mx) : 0.f;
    sum += pr[j];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
#pragma unroll
  for (int j = 0; j < PER_LANE; ++j)
    pr[j] = lane + 32 * j < E ? pr[j] / sum : NEG_INF;

  float wsum = 0.f;
  for (int r = 0; r < k; ++r) {
    float bv = -CUDART_INF_F;
    int bi = MAX_E;
#pragma unroll
    for (int j = 0; j < PER_LANE; ++j) {
      if (pr[j] > bv) {           // ascending j: the lower index on a tie
        bv = pr[j];
        bi = lane + 32 * j;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
      if (ov > bv || (ov == bv && oi < bi)) {
        bv = ov;
        bi = oi;
      }
    }
#pragma unroll
    for (int j = 0; j < PER_LANE; ++j)
      if (lane + 32 * j == bi) pr[j] = NEG_INF;
    wsum += bv;
    if (lane == 0) {
      s_w[wid][r] = bv;
      s_id[wid][r] = bi;
    }
  }
  __syncwarp();
  const float denom = fmaxf(wsum, 1e-9f);
  for (int r = lane; r < k; r += 32) {
    w_out[row * k + r] = s_w[wid][r] / denom;
    id_out[row * k + r] = s_id[wid][r];
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  logits [rows, E] contiguous, 1 <= k <=
// E <= 256; w_out [rows, k] float32, id_out [rows, k] int32.
extern "C" int topk_gating_launch(const void* logits, float* w_out,
                                  int32_t* id_out, int64_t rows, int E,
                                  int k, int dtype, void* stream_ptr) {
  if (rows <= 0) return 0;
  if (E < 1 || E > MAX_E || k < 1 || k > E)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = (rows + WARPS - 1) / WARPS;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const unsigned grid = static_cast<unsigned>(blocks);
  if (dtype == 0)
    topk_gating_kernel<float><<<grid, WARPS * 32, 0, stream>>>(
        static_cast<const float*>(logits), w_out, id_out, rows, E, k);
  else if (dtype == 1)
    topk_gating_kernel<__nv_bfloat16><<<grid, WARPS * 32, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(logits), w_out, id_out, rows, E,
        k);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
