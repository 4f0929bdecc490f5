// One Adam step in one elementwise pass: moments, bias correction at
// t = step + 1, update and optional weight decay.
//
// Replaces: src/repro/kernels/fused_adam.py, fused_adam (a Pallas kernel
// that streamed each flat leaf through VMEM once per step).
//
// Bound on the H100: memory.  Each float32 element reads p, g, m and v
// and writes p, m and v: 28 bytes and about 20 float operations, far
// below the card's 20 operations per byte balance point.  The server's
// dense leaf (3136 x 2048) moves 179.8 MB, about 54 us at 3.35 TB/s.
//
// Design: a grid-stride loop over the flat leaf with coalesced loads and
// stores, every operand touched exactly once.  The step counter stays on
// the device and is read by the kernel, so the caller never syncs the
// host to learn it.  A stacked client leaf [C, ...] holds C entities of
// n_per_entity elements each; element i is corrected with the count
// step[i / n_per_entity], which mirrors the JAX package's vmap over
// entities.  The bias correction is recomputed only when a thread
// crosses into another entity.  The outputs are separate buffers: the
// caller keeps the old state for masked no-op steps.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float load_f(const float* p, int64_t i) { return p[i]; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p, int64_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store_f(float* p, int64_t i, float x) { p[i] = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, int64_t i, float x) {
  p[i] = __float2bfloat16(x);
}

template <typename P>
__global__ void fused_adam_kernel(const P* __restrict__ p, const P* __restrict__ g,
                                  const float* __restrict__ m,
                                  const float* __restrict__ v,
                                  const int32_t* __restrict__ step,
                                  P* __restrict__ p_out, float* __restrict__ m_out,
                                  float* __restrict__ v_out, int64_t n,
                                  int64_t n_per_entity, float lr, float b1,
                                  float b2, float one_minus_b1,
                                  float one_minus_b2, float eps, float wd) {
  int64_t entity = -1;
  float bc1 = 1.f, bc2 = 1.f;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const int64_t e = i / n_per_entity;
    if (e != entity) {
      entity = e;
      const float t = static_cast<float>(step[e]) + 1.f;
      bc1 = 1.f - powf(b1, t);
      bc2 = 1.f - powf(b2, t);
    }
    const float pf = load_f(p, i);
    const float gf = load_f(g, i);
    const float m2 = b1 * m[i] + one_minus_b1 * gf;
    const float v2 = b2 * v[i] + one_minus_b2 * gf * gf;
    const float mh = m2 / bc1;
    const float vh = v2 / bc2;
    float upd = -lr * mh / (sqrtf(vh) + eps);
    if (wd != 0.f) upd = upd - lr * wd * pf;
    store_f(p_out, i, pf + upd);
    m_out[i] = m2;
    v_out[i] = v2;
  }
}

template <typename P>
int launch(const void* p, const void* g, const float* m, const float* v,
           const int32_t* step, void* p_out, float* m_out, float* v_out,
           int64_t n, int64_t n_per_entity, float lr, float b1, float b2,
           float eps, float wd, cudaStream_t stream) {
  const int threads = 256;
  int64_t blocks = (n + threads - 1) / threads;
  if (blocks > 132 * 16) blocks = 132 * 16;  // 16 resident blocks per SM
  fused_adam_kernel<P><<<static_cast<unsigned>(blocks), threads, 0, stream>>>(
      static_cast<const P*>(p), static_cast<const P*>(g), m, v, step,
      static_cast<P*>(p_out), m_out, v_out, n, n_per_entity, lr, b1, b2,
      static_cast<float>(1.0 - static_cast<double>(b1)),
      static_cast<float>(1.0 - static_cast<double>(b2)), eps, wd);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32 params and grads, 1 = bfloat16 params and grads.
extern "C" int fused_adam_launch(const void* p, const void* g, const float* m,
                                 const float* v, const int32_t* step,
                                 void* p_out, float* m_out, float* v_out,
                                 int64_t n, int64_t n_per_entity, int dtype,
                                 double lr, double b1, double b2, double eps,
                                 double wd, void* stream_ptr) {
  if (n <= 0) return 0;
  if (n_per_entity <= 0 || n % n_per_entity != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (dtype == 0)
    return launch<float>(p, g, m, v, step, p_out, m_out, v_out, n,
                         n_per_entity, static_cast<float>(lr),
                         static_cast<float>(b1), static_cast<float>(b2),
                         static_cast<float>(eps), static_cast<float>(wd),
                         stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(p, g, m, v, step, p_out, m_out, v_out, n,
                                 n_per_entity, static_cast<float>(lr),
                                 static_cast<float>(b1), static_cast<float>(b2),
                                 static_cast<float>(eps),
                                 static_cast<float>(wd), stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
