// One Adam step in one elementwise pass: moments, bias correction at
// t = step + 1, update and optional weight decay.
//
// Replaces: src/repro/kernels/fused_adam.py, fused_adam (a Pallas kernel
// that streamed each flat leaf through VMEM once per step).
//
// Bound on the H100: device memory.  Each element reads p, g, m and v and
// writes p, m and v once: 28 bytes a float32 element and 22 a bfloat16
// one, for about 14 float operations, 14-20x below the card's operations
// per byte balance point.  The server's dense leaf (3136 x 2048 f32)
// moves 179.8 MB, 53.7 us at 3.35 TB/s.  Nothing is multiplied and no
// tile is reused, so the design's one aim is to keep enough bytes in
// flight: by Little's law at 3.35 TB/s and ~0.7 us, 2-3 MB over the card,
// 15-20 KB an SM.
//
// Design:
// - One body for both entries, templated on whether it writes in place.
//   ``fused_adam_launch`` writes separate outputs (the caller keeps the
//   old state); ``fused_adam_inplace`` passes p, m and v again as the
//   outputs and skips the entities whose ``keep`` flag is 0 (a masked
//   no-op step).  Both step each element through ``adam_element``, so
//   they give the same bits and differ only in addresses.
// - The entity is known per block: the grid is (tiles of an entity's
//   row) x (entities).  A stacked leaf [C, ...] holds C entities of
//   n_per_entity elements, each corrected with its own step count, as the
//   JAX package's vmap over entities.  A block reads its entity's keep
//   flag first and returns before any other load when it is 0, then
//   issues its tile's loads and reads the step count behind them, and
//   computes the bias corrections once.  No integer division is left in
//   the element loop.
// - 16-byte accesses: a thread moves 4 float32 or 8 bfloat16 elements of
//   p and g a vector, the same elements of m and v in one or two float4,
//   and issues its loads of every operand before it uses the first: 64
//   bytes a thread in flight for float32, 96 for bfloat16.  A block takes
//   a tile of 256 vectors of one row, and registers let 3-4 blocks share
//   an SM: 48-72 KB in flight, 3-4x what Little's law asks.  More vectors
//   a thread (``kUnroll`` 2 or 4) measured slower on the H100 at every
//   shape of the path: they take more registers, so fewer threads fit an
//   SM; capping the registers spills.  ``chip_smoke.py --adam-phase``
//   prints each kernel's registers.
// - Alignment: the caller's plan (``kernels/fused_adam.py``, ``plan``)
//   names ``phase``, the first element, counted from the leaf's start, at
//   which every operand lies on 16 bytes.  A row's elements before its
//   first such element (the head) and after its last whole vector (the
//   tail) are stepped one at a time by the row's first block.  Where no
//   such element exists (operands misaligned against each other), phase
//   is -1 and the whole leaf takes the scalar path: still this kernel,
//   one element at a time over the same tiles.
// - g is never written, so it is read through the read-only path; p, m
//   and v are plain loads in both entries, since the in-place entry
//   writes them (the read-only path for them measured no faster in the
//   out-of-place entry).
// - The two instantiations differ in the keep test and in name, so a
//   profile tells the entries apart.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// kVec elements of P fill 16 bytes; a thread issues kUnroll vectors of
// every operand before it steps the first (1: see the note above).
template <typename P>
struct Width;
template <>
struct Width<float> {
  static constexpr int kVec = 4, kUnroll = 1;
};
template <>
struct Width<__nv_bfloat16> {
  static constexpr int kVec = 8, kUnroll = 1;
};

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

// One element's step, shared by both entries and both paths so that they
// give the same bits: reads p, g, m, v and returns p', m', v'.
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

// The operands.  The in-place entry passes p, m and v again as p_out,
// m_out and v_out, so no pointer here is __restrict__.
template <typename P>
struct Operands {
  const P* p;
  const P* g;
  const float* m;
  const float* v;
  P* p_out;
  float* m_out;
  float* v_out;
  const int32_t* step;
  const int32_t* keep;  // null, or one flag an entity (in place only)
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// kVec elements of P in one 16-byte word, as floats and back, each
// rounded as ``put`` rounds one.
__device__ __forceinline__ void unpack(const uint4& w, float (&f)[4]) {
  f[0] = __uint_as_float(w.x);
  f[1] = __uint_as_float(w.y);
  f[2] = __uint_as_float(w.z);
  f[3] = __uint_as_float(w.w);
}
__device__ __forceinline__ void unpack(const uint4& w, float (&f)[8]) {
  const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(&w);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    f[2 * j] = __low2float(b[j]);
    f[2 * j + 1] = __high2float(b[j]);
  }
}
__device__ __forceinline__ uint4 pack(const float (&f)[4]) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                    __float_as_uint(f[2]), __float_as_uint(f[3]));
}
__device__ __forceinline__ uint4 pack(const float (&f)[8]) {
  uint4 w;
  __nv_bfloat162* b = reinterpret_cast<__nv_bfloat162*>(&w);
#pragma unroll
  for (int j = 0; j < 4; ++j)
    b[j] = __halves2bfloat162(__float2bfloat16(f[2 * j]),
                              __float2bfloat16(f[2 * j + 1]));
  return w;
}

// Element i of the leaf, alone: the scalar path, a row's head and tail.
template <typename P>
__device__ __forceinline__ void step_one(const Operands<P>& a, int64_t i,
                                         float bc1, float bc2,
                                         const Hyper& h) {
  float p2, m2, v2;
  adam_element(to_float(a.p[i]), to_float(__ldg(a.g + i)), a.m[i], a.v[i],
               bc1, bc2, h, p2, m2, v2);
  put(a.p_out + i, p2);
  a.m_out[i] = m2;
  a.v_out[i] = v2;
}

// A thread's share of a block's tile of whole vectors of one row:
// vectors first + u * kThreads + threadIdx.x (u < kUnroll) of the nvec
// that start at element ``start`` (16-byte aligned in every operand).
// ``load`` issues every load; ``step`` steps the elements and stores
// them, once the entity's bias corrections are known.
template <typename P>
struct Vectors {
  static constexpr int V = Width<P>::kVec, U = Width<P>::kUnroll, MV = V / 4;
  uint4 rp[U], rg[U];
  float4 rm[U][MV], rv[U][MV];

  __device__ __forceinline__ void load(const Operands<P>& a, int64_t start,
                                       int64_t nvec, int64_t first) {
    const uint4* p4 = reinterpret_cast<const uint4*>(a.p + start);
    const uint4* g4 = reinterpret_cast<const uint4*>(a.g + start);
    const float4* m4 = reinterpret_cast<const float4*>(a.m + start);
    const float4* v4 = reinterpret_cast<const float4*>(a.v + start);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int64_t k = first + u * kThreads + threadIdx.x;
      if (k < nvec) {
        rp[u] = p4[k];
        rg[u] = __ldg(g4 + k);
#pragma unroll
        for (int j = 0; j < MV; ++j) {
          rm[u][j] = m4[k * MV + j];
          rv[u][j] = v4[k * MV + j];
        }
      }
    }
  }

  __device__ __forceinline__ void step(const Operands<P>& a, int64_t start,
                                       int64_t nvec, int64_t first,
                                       float bc1, float bc2,
                                       const Hyper& h) const {
    uint4* po4 = reinterpret_cast<uint4*>(a.p_out + start);
    float4* mo4 = reinterpret_cast<float4*>(a.m_out + start);
    float4* vo4 = reinterpret_cast<float4*>(a.v_out + start);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int64_t k = first + u * kThreads + threadIdx.x;
      if (k < nvec) {
        float pf[V], gf[V], p2[V];
        float4 m2[MV], v2[MV];
        unpack(rp[u], pf);
        unpack(rg[u], gf);
        const float* mf = reinterpret_cast<const float*>(rm[u]);
        const float* vf = reinterpret_cast<const float*>(rv[u]);
        float* m2f = reinterpret_cast<float*>(m2);
        float* v2f = reinterpret_cast<float*>(v2);
#pragma unroll
        for (int j = 0; j < V; ++j)
          adam_element(pf[j], gf[j], mf[j], vf[j], bc1, bc2, h, p2[j],
                       m2f[j], v2f[j]);
        po4[k] = pack(p2);
#pragma unroll
        for (int j = 0; j < MV; ++j) {
          mo4[k * MV + j] = m2[j];
          vo4[k * MV + j] = v2[j];
        }
      }
    }
  }
};

// Grid: x the tiles of a row (kThreads * kUnroll * kVec elements each),
// y the entities, walked in strides of gridDim.y.  A block issues its
// tile's loads before it reads the entity's step count, so that the two
// reads overlap.
template <typename P, bool kInPlace>
__global__ void __launch_bounds__(kThreads)
    fused_adam_kernel(Operands<P> a, int64_t rows, int64_t n_per_entity,
                      int phase, Hyper h) {
  constexpr int V = Width<P>::kVec, U = Width<P>::kUnroll;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kThreads * U;
  for (int64_t e = blockIdx.y; e < rows; e += gridDim.y) {
    if (kInPlace && a.keep != nullptr && a.keep[e] == 0) continue;
    const int64_t base = e * n_per_entity;
    float bc1, bc2;
    if (phase < 0) {
      // the scalar path: the tile's elements, kThreads apart
      corrections(a.step[e], h, bc1, bc2);
#pragma unroll 4
      for (int j = 0; j < U * V; ++j) {
        const int64_t i = first * V + j * kThreads + threadIdx.x;
        if (i < n_per_entity)
          step_one(a, base + i, bc1, bc2, h);
      }
      continue;
    }
    const int64_t head = min((phase - base) & (V - 1), n_per_entity);
    const int64_t nvec = (n_per_entity - head) / V;
    Vectors<P> vecs;
    vecs.load(a, base + head, nvec, first);
    corrections(a.step[e], h, bc1, bc2);
    if (blockIdx.x == 0) {
      // threads [0, V) the head, [V, 2V) the tail; each is under V long
      const int64_t tail = head + nvec * V;
      const int t = threadIdx.x;
      if (t < head)
        step_one(a, base + t, bc1, bc2, h);
      else if (t >= V && t < 2 * V && tail + (t - V) < n_per_entity)
        step_one(a, base + tail + (t - V), bc1, bc2, h);
    }
    vecs.step(a, base + head, nvec, first, bc1, bc2, h);
  }
}

Hyper hyper(double lr, double b1, double b2, double eps, double wd) {
  const float f1 = static_cast<float>(b1), f2 = static_cast<float>(b2);
  return Hyper{static_cast<float>(lr), f1, f2,
               static_cast<float>(1.0 - static_cast<double>(f1)),
               static_cast<float>(1.0 - static_cast<double>(f2)),
               static_cast<float>(eps), static_cast<float>(wd)};
}

bool on_16(const void* ptr, int phase, int size) {
  return (reinterpret_cast<uintptr_t>(ptr) + static_cast<uintptr_t>(phase) *
                                                 size) % 16 == 0;
}

// Checks the caller's plan against the operands and launches once:
// ``phase`` must put every operand on 16 bytes (or be -1), and ``tiles``
// must be the tiles of one row.
template <typename P, bool kInPlace>
int launch(const Operands<P>& a, int64_t n, int64_t n_per_entity, int phase,
           int64_t tiles, Hyper h, cudaStream_t stream) {
  constexpr int V = Width<P>::kVec, U = Width<P>::kUnroll;
  constexpr int64_t tile = static_cast<int64_t>(kThreads) * U * V;
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (n_per_entity <= 0 || n % n_per_entity != 0) return bad;
  if (phase < -1 || phase >= V) return bad;
  if (phase >= 0) {
    const int sp = static_cast<int>(sizeof(P));
    if (!(on_16(a.p, phase, sp) && on_16(a.g, phase, sp) &&
          on_16(a.m, phase, 4) && on_16(a.v, phase, 4) &&
          on_16(a.p_out, phase, sp) && on_16(a.m_out, phase, 4) &&
          on_16(a.v_out, phase, 4)))
      return bad;
  }
  if (tiles != (n_per_entity + tile - 1) / tile || tiles > 0x7fffffff)
    return bad;
  const int64_t rows = n / n_per_entity;
  const dim3 grid(static_cast<unsigned>(tiles),
                  static_cast<unsigned>(rows < 65535 ? rows : 65535));
  fused_adam_kernel<P, kInPlace><<<grid, kThreads, 0, stream>>>(
      a, rows, n_per_entity, phase, h);
  return static_cast<int>(cudaGetLastError());
}

template <typename P>
Operands<P> operands(const void* p, const void* g, const float* m,
                     const float* v, void* p_out, float* m_out, float* v_out,
                     const int32_t* step, const int32_t* keep) {
  return Operands<P>{static_cast<const P*>(p), static_cast<const P*>(g), m,
                     v, static_cast<P*>(p_out), m_out, v_out, step, keep};
}

}  // namespace

// dtype: 0 = float32 params and grads, 1 = bfloat16 params and grads.
// ``phase`` and ``tiles`` are the plan of ``kernels/fused_adam.py``.
extern "C" int fused_adam_launch(const void* p, const void* g, const float* m,
                                 const float* v, const int32_t* step,
                                 void* p_out, float* m_out, float* v_out,
                                 int64_t n, int64_t n_per_entity, int dtype,
                                 int phase, int64_t tiles, double lr,
                                 double b1, double b2, double eps, double wd,
                                 void* stream_ptr) {
  if (n <= 0) return 0;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const Hyper h = hyper(lr, b1, b2, eps, wd);
  if (dtype == 0)
    return launch<float, false>(
        operands<float>(p, g, m, v, p_out, m_out, v_out, step, nullptr), n,
        n_per_entity, phase, tiles, h, stream);
  if (dtype == 1)
    return launch<__nv_bfloat16, false>(
        operands<__nv_bfloat16>(p, g, m, v, p_out, m_out, v_out, step,
                                nullptr),
        n, n_per_entity, phase, tiles, h, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The in-place step: p, m and v are updated where they lie; ``keep`` is
// null or holds one int32 flag an entity (as ``step`` holds its count).
extern "C" int fused_adam_inplace(void* p, const void* g, float* m, float* v,
                                  const int32_t* step, const int32_t* keep,
                                  int64_t n, int64_t n_per_entity, int dtype,
                                  int phase, int64_t tiles, double lr,
                                  double b1, double b2, double eps, double wd,
                                  void* stream_ptr) {
  if (n <= 0) return 0;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const Hyper h = hyper(lr, b1, b2, eps, wd);
  if (dtype == 0)
    return launch<float, true>(
        operands<float>(p, g, m, v, p, m, v, step, keep), n, n_per_entity,
        phase, tiles, h, stream);
  if (dtype == 1)
    return launch<__nv_bfloat16, true>(
        operands<__nv_bfloat16>(p, g, m, v, p, m, v, step, keep), n,
        n_per_entity, phase, tiles, h, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
