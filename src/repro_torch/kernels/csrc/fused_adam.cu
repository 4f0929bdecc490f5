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
// crosses into another entity.  Two entries: ``fused_adam_launch``
// writes separate output buffers (the caller keeps the old state), and
// ``fused_adam_inplace`` writes p, m and v where they lie, skipping the
// entities whose ``keep`` flag is 0 (a masked no-op step, done in the
// kernel instead of by a select against a kept copy).  Both read and
// write the same bytes of a live entity and share one element function.
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

struct Hyper {
  float lr, b1, b2, one_minus_b1, one_minus_b2, eps, wd;
};

// The bias corrections of an entity whose step count is ``count``.
__device__ __forceinline__ void corrections(int32_t count, const Hyper& h,
                                            float& bc1, float& bc2) {
  const float t = static_cast<float>(count) + 1.f;
  bc1 = 1.f - powf(h.b1, t);
  bc2 = 1.f - powf(h.b2, t);
}

// One element's step, shared by both entries so that they give the same
// bits: reads p, g, m, v and returns p', m', v'.
__device__ __forceinline__ void adam_element(float pf, float gf, float mf,
                                             float vf, float bc1, float bc2,
                                             const Hyper& h, float& p2,
                                             float& m2, float& v2) {
  m2 = h.b1 * mf + h.one_minus_b1 * gf;
  v2 = h.b2 * vf + h.one_minus_b2 * gf * gf;
  const float mh = m2 / bc1;
  const float vh = v2 / bc2;
  float upd = -h.lr * mh / (sqrtf(vh) + h.eps);
  if (h.wd != 0.f) upd = upd - h.lr * h.wd * pf;
  p2 = pf + upd;
}

template <typename P>
__global__ void fused_adam_kernel(const P* __restrict__ p, const P* __restrict__ g,
                                  const float* __restrict__ m,
                                  const float* __restrict__ v,
                                  const int32_t* __restrict__ step,
                                  P* __restrict__ p_out, float* __restrict__ m_out,
                                  float* __restrict__ v_out, int64_t n,
                                  int64_t n_per_entity, Hyper h) {
  int64_t entity = -1;
  float bc1 = 1.f, bc2 = 1.f;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const int64_t e = i / n_per_entity;
    if (e != entity) {
      entity = e;
      corrections(step[e], h, bc1, bc2);
    }
    float p2, m2, v2;
    adam_element(load_f(p, i), load_f(g, i), m[i], v[i], bc1, bc2, h, p2, m2,
                 v2);
    store_f(p_out, i, p2);
    m_out[i] = m2;
    v_out[i] = v2;
  }
}

// The in-place entry: p, m and v are read and written through one
// pointer each, so no two arguments alias and __restrict__ still holds.
// ``keep`` (null, or one int32 an entity, as ``step``) leaves an
// entity's elements untouched where it is 0: the masked no-op step,
// without a second copy of the state to select from.
template <typename P>
__global__ void fused_adam_inplace_kernel(P* __restrict__ p,
                                          const P* __restrict__ g,
                                          float* __restrict__ m,
                                          float* __restrict__ v,
                                          const int32_t* __restrict__ step,
                                          const int32_t* __restrict__ keep,
                                          int64_t n, int64_t n_per_entity,
                                          Hyper h) {
  int64_t entity = -1;
  bool live = true;
  float bc1 = 1.f, bc2 = 1.f;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const int64_t e = i / n_per_entity;
    if (e != entity) {
      entity = e;
      live = keep == nullptr || keep[e] != 0;
      corrections(step[e], h, bc1, bc2);
    }
    if (!live) continue;
    float p2, m2, v2;
    adam_element(load_f(p, i), load_f(g, i), m[i], v[i], bc1, bc2, h, p2, m2,
                 v2);
    store_f(p, i, p2);
    m[i] = m2;
    v[i] = v2;
  }
}

Hyper hyper(double lr, double b1, double b2, double eps, double wd) {
  const float f1 = static_cast<float>(b1), f2 = static_cast<float>(b2);
  return Hyper{static_cast<float>(lr), f1, f2,
               static_cast<float>(1.0 - static_cast<double>(f1)),
               static_cast<float>(1.0 - static_cast<double>(f2)),
               static_cast<float>(eps), static_cast<float>(wd)};
}

unsigned blocks_for(int64_t n, int threads) {
  int64_t blocks = (n + threads - 1) / threads;
  if (blocks > 132 * 16) blocks = 132 * 16;  // 16 resident blocks per SM
  return static_cast<unsigned>(blocks);
}

template <typename P>
int launch(const void* p, const void* g, const float* m, const float* v,
           const int32_t* step, void* p_out, float* m_out, float* v_out,
           int64_t n, int64_t n_per_entity, Hyper h, cudaStream_t stream) {
  fused_adam_kernel<P><<<blocks_for(n, 256), 256, 0, stream>>>(
      static_cast<const P*>(p), static_cast<const P*>(g), m, v, step,
      static_cast<P*>(p_out), m_out, v_out, n, n_per_entity, h);
  return static_cast<int>(cudaGetLastError());
}

template <typename P>
int launch_inplace(void* p, const void* g, float* m, float* v,
                   const int32_t* step, const int32_t* keep, int64_t n,
                   int64_t n_per_entity, Hyper h, cudaStream_t stream) {
  fused_adam_inplace_kernel<P><<<blocks_for(n, 256), 256, 0, stream>>>(
      static_cast<P*>(p), static_cast<const P*>(g), m, v, step, keep, n,
      n_per_entity, h);
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
  const Hyper h = hyper(lr, b1, b2, eps, wd);
  if (dtype == 0)
    return launch<float>(p, g, m, v, step, p_out, m_out, v_out, n,
                         n_per_entity, h, stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(p, g, m, v, step, p_out, m_out, v_out, n,
                                 n_per_entity, h, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The in-place step: p, m and v are updated where they lie; ``keep`` is
// null or holds one int32 flag an entity (as ``step`` holds its count).
extern "C" int fused_adam_inplace(void* p, const void* g, float* m, float* v,
                                  const int32_t* step, const int32_t* keep,
                                  int64_t n, int64_t n_per_entity, int dtype,
                                  double lr, double b1, double b2, double eps,
                                  double wd, void* stream_ptr) {
  if (n <= 0) return 0;
  if (n_per_entity <= 0 || n % n_per_entity != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const Hyper h = hyper(lr, b1, b2, eps, wd);
  if (dtype == 0)
    return launch_inplace<float>(p, g, m, v, step, keep, n, n_per_entity, h,
                                 stream);
  if (dtype == 1)
    return launch_inplace<__nv_bfloat16>(p, g, m, v, step, keep, n,
                                         n_per_entity, h, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
