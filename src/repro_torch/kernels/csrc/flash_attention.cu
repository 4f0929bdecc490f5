// Full-sequence attention with an online softmax (flash attention,
// forward): out[b, i, h] = softmax_j(s_ij) v[b, j, h / (H / Hkv)] with
// s_ij = softcap(q_i . k_j / sqrt(D)), masked to -2e38 where key j is
// out of range (j >= Sk), in the future (causal, j > i, top-left
// aligned) or out of the window (i - j >= window).
//
// Replaces: src/repro/kernels/flash_attention.py, flash_attention (a
// Pallas grid (B, H, q blocks, kv blocks) whose innermost kv axis runs
// in order and carries (acc, m, l) in VMEM scratch from one kv block to
// the next; the wrapper swapped [B, S, H, D] to [B, H, S, D] around it).
//
// Bound on the H100: operations.  At the main path's [2, 2048, 16, 128]
// causal the call does about 34 GFLOP against 34 MB of q, k, v and out,
// so the 989 TFLOP/s bf16 tensor-core rate sets the least time (about
// 35 us), far above the memory's.  This first kernel computes on the
// CUDA cores in float32 (no mma/wgmma), so it is bound by shared-memory
// bandwidth feeding the FMAs and runs well above that bound; the
// tensor-core redesign is later work.
//
// Design: on Hopper blocks run in parallel and in no order, so nothing
// carries between blocks.  One block of 256 threads owns one (query tile
// of 64 rows, head, batch) and loops over the 64-row key tiles itself,
// keeping the online-softmax state (m, l, acc) in float32 registers:
// thread (rg, cg) = (tid / 16, tid % 16) owns query rows 4rg..4rg+3, the
// score columns cg + 16j and the output dims cg + 16j, and the 16
// threads of a row group (half a warp) reduce the row max and sum with
// shuffles.  Q (scaled, float32), the K and V tiles (input type) and the
// probabilities are staged in shared memory with one extra word per row,
// so the strided reads of one warp fall in distinct banks.  Key tiles
// that causality or the window mask out for every row of the block are
// skipped, which gives the same result: a masked logit adds exactly 0
// once a row has seen a valid key, and a row whose first tiles were all
// masked is reset by the rescale exp(-2e38 - m) = 0 at its first valid
// key.  The ragged tail is masked with kpos < Sk.  q, k and v are read
// through their [B, S, H, D] strides (unit stride in D); out is written
// contiguous [B, Sq, H, D].  head_dim 64, 128 and 256 are template
// instances; 256 in float32 needs 214,016 bytes of dynamic shared
// memory, above the 48 KB default, hence cudaFuncSetAttribute.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

namespace {

constexpr int BQ = 64;          // query rows per block
constexpr int BK = 64;          // key rows per tile
constexpr int THREADS = 256;
constexpr float NEG_INF = -2.0e38f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  int Sq, Sk, H, Hkv;
  int64_t qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh;
  int causal;
  int window;       // <= 0: none
  float softcap;    // <= 0: none
  float sqrt_d;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T, int D>
struct Smem {
  static constexpr int QS = D + 1;                              // floats
  static constexpr int PS = BK + 1;                             // floats
  static constexpr int KS = D + 4 / static_cast<int>(sizeof(T));  // T's
  static constexpr size_t bytes =
      sizeof(float) * (BQ * QS + BQ * PS) + sizeof(T) * 2 * BK * KS;
};

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const Params p) {
  using S = Smem<T, D>;
  constexpr int DJ = D / 16;    // output dims per thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sQ = reinterpret_cast<float*>(smem_raw);
  float* sP = sQ + BQ * S::QS;
  T* sK = reinterpret_cast<T*>(sP + BQ * S::PS);
  T* sV = sK + BK * S::KS;

  const int tid = threadIdx.x;
  const int rg = tid >> 4, cg = tid & 15;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.H / p.Hkv);
  const T* qg = static_cast<const T*>(p.q) + b * p.qsb + h * p.qsh;
  const T* kg = static_cast<const T*>(p.k) + b * p.ksb + hk * p.ksh;
  const T* vg = static_cast<const T*>(p.v) + b * p.vsb + hk * p.vsh;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, d = i % D;
    const int qpos = q0 + r;
    sQ[r * S::QS + d] =
        qpos < p.Sq ? to_f(qg[qpos * p.qss + d]) / p.sqrt_d : 0.f;
  }

  float acc[4][DJ];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  // key tiles that hold a valid key for some row of this block
  const int q_last = min(q0 + BQ, p.Sq) - 1;
  int k_end = p.Sk;
  if (p.causal) k_end = min(k_end, q_last + 1);
  int k_begin = 0;
  if (p.window > 0) k_begin = max(0, q0 - p.window + 1);
  const int t_begin = k_begin / BK;
  const int t_end = (k_end + BK - 1) / BK;

  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * BK;
    __syncthreads();            // the previous tile's reads are done
    for (int i = tid; i < BK * D; i += THREADS) {
      const int r = i / D, d = i % D;
      const int kpos = k0 + r;
      T kx = from_f<T>(0.f), vx = from_f<T>(0.f);
      if (kpos < p.Sk) {
        kx = kg[kpos * p.kss + d];
        vx = vg[kpos * p.vss + d];
      }
      sK[r * S::KS + d] = kx;
      sV[r * S::KS + d] = vx;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = sQ[(rg * 4 + i) * S::QS + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = to_f(sK[(cg + 16 * j) * S::KS + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + rg * 4 + i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + cg + 16 * j;
        float x = s[i][j];
        if (p.softcap > 0.f) x = p.softcap * tanhf(x / p.softcap);
        const bool ok = kpos < p.Sk && (!p.causal || qpos >= kpos) &&
                        (p.window <= 0 || qpos - kpos < p.window);
        s[i][j] = ok ? x : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        rs += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = corr * l[i] + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= corr;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        sP[(rg * 4 + i) * S::PS + cg + 16 * j] = s[i][j];
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = sP[(rg * 4 + i) * S::PS + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const float vv = to_f(sV[c * S::KS + cg + 16 * j]);
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
  }

  T* out = static_cast<T*>(p.out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + rg * 4 + i;
    if (qpos >= p.Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* o = out + ((static_cast<int64_t>(b) * p.Sq + qpos) * p.H + h) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) o[cg + 16 * j] = from_f<T>(acc[i][j] / denom);
  }
}

template <typename T, int D>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  const size_t smem = Smem<T, D>::bytes;
  // once per instance, at its first launch (before any graph capture)
  static cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (attr != cudaSuccess) return attr;
  const dim3 grid((p.Sq + BQ - 1) / BQ, p.H, B);
  flash_fwd_kernel<T, D><<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const Params& p, int B, int D, cudaStream_t stream) {
  switch (D) {
    case 64: return launch<T, 64>(p, B, stream);
    case 128: return launch<T, 128>(p, B, stream);
    case 256: return launch<T, 256>(p, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  Strides are in elements; D has unit
// stride.  window <= 0 and softcap <= 0 mean none.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* out, int B, int Sq,
    int Sk, int H, int Hkv, int D, int64_t qsb, int64_t qss, int64_t qsh,
    int64_t ksb, int64_t kss, int64_t ksh, int64_t vsb, int64_t vss,
    int64_t vsh, int causal, int window, double softcap, int dtype,
    void* stream_ptr) {
  if (B <= 0 || Sq <= 0) return 0;
  if (Sk <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 || B > 65535 ||
      H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{q,   k,   v,   out, Sq,  Sk,     H,      Hkv,
           qsb, qss, qsh, ksb, kss, ksh,    vsb,    vss,
           vsh, causal, window, static_cast<float>(softcap),
           std::sqrt(static_cast<float>(D))};
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  cudaError_t err;
  if (dtype == 0)
    err = dispatch_d<float>(p, B, D, stream);
  else if (dtype == 1)
    err = dispatch_d<__nv_bfloat16>(p, B, D, stream);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
