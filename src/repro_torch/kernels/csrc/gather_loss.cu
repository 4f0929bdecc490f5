// Fused resample gather + linear-head cross-entropy, one loss per row:
// out[i] = xent(src[idx[i]] @ w (+ b), labels[idx[i]]).
//
// Replaces: src/repro/kernels/gather_loss.py, gather_loss_microbatch (a
// Pallas scalar-prefetch grid that streamed source row idx[i] straight
// into the head matmul and log-softmax, so the gathered minibatch never
// reached device memory).
//
// Bound on the H100: memory for the call as a whole (M rows of D values,
// the D x K head and M labels, against 2 * M * D * K operations), and at
// the main path's shapes (M = 16, D = 2048, K = 10) launch latency.
//
// Design: one block per output row.  The block reads its own index and
// label (the TPU prefetched both into scalar memory), streams its source
// row from device memory once, and forms the K logits as dot products in
// the kernel body: each thread accumulates a tile of up to 16 logits over
// its strided share of the row, reading the matching rows of w (which
// stays in L2 across blocks), then the block reduces the tile through
// warp shuffles and shared memory.  The log-sum-exp is the stable form
// (max subtracted), as in the JAX kernel.  An index outside [0, T) or a
// label outside [0, K) gives NaN for that row.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 16;
constexpr int kThreads = 256;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename S, typename W, typename L>
__global__ void gather_loss_kernel(const S* __restrict__ src,
                                   const L* __restrict__ labels,
                                   const int32_t* __restrict__ idx,
                                   const W* __restrict__ w,
                                   const float* __restrict__ b,
                                   float* __restrict__ out, int64_t T,
                                   int64_t D, int K) {
  extern __shared__ float smem[];
  float* logits = smem;      // [K]
  float* red = smem + K;     // [warps][kTile]
  const int64_t i = blockIdx.x;
  const int32_t r = idx[i];
  if (r < 0 || r >= T) {     // uniform over the block: no barrier is skipped
    if (threadIdx.x == 0) out[i] = NAN;
    return;
  }
  const S* f = src + static_cast<int64_t>(r) * D;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  for (int k0 = 0; k0 < K; k0 += kTile) {
    const int kn = min(kTile, K - k0);
    float acc[kTile];
#pragma unroll
    for (int kk = 0; kk < kTile; ++kk) acc[kk] = 0.f;
    for (int64_t d = threadIdx.x; d < D; d += blockDim.x) {
      const float fd = to_f(f[d]);
      const W* wr = w + d * K + k0;
#pragma unroll
      for (int kk = 0; kk < kTile; ++kk)
        if (kk < kn) acc[kk] += fd * to_f(wr[kk]);
    }
#pragma unroll
    for (int kk = 0; kk < kTile; ++kk) {
      float a = acc[kk];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        a += __shfl_xor_sync(0xffffffffu, a, off);
      if (lane == 0) red[warp * kTile + kk] = a;
    }
    __syncthreads();
    if (threadIdx.x < kn) {
      float s = 0.f;
      for (int wi = 0; wi < warps; ++wi) s += red[wi * kTile + threadIdx.x];
      if (b != nullptr) s += b[k0 + threadIdx.x];
      logits[k0 + threadIdx.x] = s;
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    float mx = -INFINITY;
    for (int k = 0; k < K; ++k) mx = fmaxf(mx, logits[k]);
    float se = 0.f;
    for (int k = 0; k < K; ++k) se += expf(logits[k] - mx);
    const int64_t y = static_cast<int64_t>(labels[r]);
    out[i] = (y < 0 || y >= K) ? NAN : -((logits[y] - mx) - logf(se));
  }
}

template <typename S, typename W, typename L>
int launch(const void* src, const void* labels, const int32_t* idx,
           const void* w, const float* b, float* out, int64_t T, int64_t M,
           int64_t D, int K, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (K + (kThreads / 32) * kTile);
  gather_loss_kernel<S, W, L><<<static_cast<unsigned>(M), kThreads, smem, stream>>>(
      static_cast<const S*>(src), static_cast<const L*>(labels), idx,
      static_cast<const W*>(w), b, out, T, D, K);
  return static_cast<int>(cudaGetLastError());
}

template <typename S, typename W>
int by_label(int label_bytes, const void* src, const void* labels,
             const int32_t* idx, const void* w, const float* b, float* out,
             int64_t T, int64_t M, int64_t D, int K, cudaStream_t stream) {
  if (label_bytes == 4)
    return launch<S, W, int32_t>(src, labels, idx, w, b, out, T, M, D, K, stream);
  if (label_bytes == 8)
    return launch<S, W, int64_t>(src, labels, idx, w, b, out, T, M, D, K, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// src_dtype, w_dtype: 0 = float32, 1 = bfloat16.  label_bytes: 4 or 8.
// b may be null (no bias); it is float32 when given.
extern "C" int gather_loss_launch(const void* src, const void* labels,
                                  const int32_t* idx, const void* w,
                                  const float* b, float* out, int64_t T,
                                  int64_t M, int64_t D, int K, int src_dtype,
                                  int w_dtype, int label_bytes,
                                  void* stream_ptr) {
  if (M <= 0) return 0;
  if (M > 2147483647LL || K <= 0 || K > 8192 || D <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream_ptr);
  if (src_dtype == 0 && w_dtype == 0)
    return by_label<float, float>(label_bytes, src, labels, idx, w, b, out, T, M, D, K, s);
  if (src_dtype == 0 && w_dtype == 1)
    return by_label<float, __nv_bfloat16>(label_bytes, src, labels, idx, w, b, out, T, M, D, K, s);
  if (src_dtype == 1 && w_dtype == 0)
    return by_label<__nv_bfloat16, float>(label_bytes, src, labels, idx, w, b, out, T, M, D, K, s);
  if (src_dtype == 1 && w_dtype == 1)
    return by_label<__nv_bfloat16, __nv_bfloat16>(label_bytes, src, labels, idx, w, b, out, T, M, D, K, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
