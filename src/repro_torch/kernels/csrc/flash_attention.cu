// Full-sequence attention with an online softmax (flash attention,
// forward): out[b, i, h] = softmax_j(s_ij) v[b, j, h / (H / Hkv)] with
// s_ij = softcap(q_i . k_j / sqrt(D)), masked where key j is out of
// range (j >= Sk), in the future (causal, j > i, top-left aligned) or
// out of the window (i - j >= window).
//
// Replaces: src/repro/kernels/flash_attention.py, flash_attention (a
// Pallas grid (B, H, q blocks, kv blocks) whose innermost kv axis runs
// in order and carries (acc, m, l) in VMEM scratch from one kv block to
// the next; the wrapper swapped [B, S, H, D] to [B, H, S, D] around it).
//
// Bound on the H100: operations.  At the olmoe round's [2, 2048, 16,
// 128] bf16 causal the call does about 34 GFLOP against 34 MB of q, k,
// v and out, so the 989 TFLOP/s bf16 tensor-core rate sets the least
// time (about 35 us), far above the memory's.
//
// On Hopper blocks run in parallel and in no order, so nothing carries
// between blocks: a block owns one (query tile, head, batch), loops over
// the key tiles that hold a valid key for one of its rows, and keeps the
// online-softmax state (m, l, acc) in float32 registers.  Key tiles that
// causality or the window mask out for every row are skipped, which
// gives the same result: a masked logit adds exactly 0 once a row has
// seen a valid key, and a row whose first tiles were all masked is
// reset by the rescale exp(-2e38 - m) = 0 at its first valid key.  q, k
// and v are read through their [B, S, H, D] strides (unit stride in D);
// out is written contiguous [B, Sq, H, D].  Two designs, chosen by the
// caller (kernels/flash_attention.py, `design`):
//
// wgmma (bf16, head_dim 64 and 128): the products on the tensor cores.
// A block of three warpgroups owns 128 query rows and walks 128-row key
// tiles, heaviest query tiles first (the last causal rows walk the most
// tiles, so they start in the first wave).  The producer warpgroup gives
// up registers (setmaxnreg 40) and one of its threads brings Q once and
// K/V into a 2-stage ring by TMA (cp.async.bulk.tensor over the [B, S,
// H, D] strides; rows past S read as zeros), each stage with full
// (K and V apart) and empty mbarriers.  The two consumer warpgroups
// (setmaxnreg 232) own 64 query rows each.  Q and the tiles sit in
// shared memory in the 128-byte swizzled layout that TMA writes and
// wgmma reads (column blocks of 64, hopper.cuh).  S = Q K^T is a chain
// of m64n128k16 products over D (both operands K-major), scaled by
// 1/sqrt(D) in float32 after the product as the JAX kernel scales it,
// with log2 e folded in for exp2.  The online softmax runs on the
// accumulator fragment (a row lies in one quad of threads: two shuffles
// reduce it; a row with no valid key yet gives its masked scores p = 0
// rather than the uniform weights of the CUDA-core kernel, which the
// same rescale discards); the masks run only on tiles that cross the
// diagonal, the window edge or the ragged tail (a zero K row scores 0,
// not -inf, so j < Sk stays a mask), and a warpgroup skips a tile none
// of its rows may see.  P is rounded to bf16 in registers and is the A
// operand of O += P V (m64nDk16, V MN-major from its natural [key, d]
// layout); l sums the float32 probabilities before the rounding.
// Shared memory: Q 128 D + 2 stages x 2 x 128 D bf16 (160 KB at D =
// 128).  Registers (ptxas -v, CUDA 12.9): 168 a thread at entry for
// both D, no spills, then 232 a consumer thread and 40 a producer
// thread.  The two consumers do not take turns (ping-pong) and a
// warpgroup does not overlap its softmax with its next product: that is
// the next step.
//
// simt (float32, and bf16 at head_dim 32, 96 and 256): the products on
// the CUDA cores in float32, at head_dim 32 (whisper's smoke config),
// 64, 96, 128 and 256.  One block of
// 256 threads owns 64 query rows and walks 64-row key tiles: thread
// (rg, cg) = (tid / 16, tid % 16) owns rows 4rg..4rg+3, score columns
// cg + 16j and output dims cg + 16j; the 16 threads of a row group
// reduce the row max and sum with shuffles.  Q (scaled, float32), the
// K and V tiles (input type) and the probabilities are staged in shared
// memory with one extra word per row, so the strided reads of one warp
// fall in distinct banks.  256 in float32 needs 214,016 bytes of shared
// memory.  It keeps float32 products exact (the port keeps TF32 off).
// bf16 at D = 256 stays here because 128-row K and V tiles of 256
// columns do not fit two stages, and at D = 96 because the tensor-core
// kernel's swizzle works in 64-column blocks.
#include <cuda.h>          // CUtensorMap and its enums (no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

#include "hopper.cuh"

namespace {

constexpr float NEG_INF = -2.0e38f;   // finite: a fully masked row stays finite

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
  float scale;      // 1 / sqrt_d
};

// The key tiles [t_begin, t_end) of `bk` rows that hold a valid key for
// one of the query rows [q0, q_last].
__device__ __forceinline__ void tile_range(const Params& p, int q0,
                                           int q_last, int bk, int& t_begin,
                                           int& t_end) {
  int k_end = p.Sk;
  if (p.causal) k_end = min(k_end, q_last + 1);
  int k_begin = 0;
  if (p.window > 0) k_begin = max(0, q0 - p.window + 1);
  t_begin = k_begin / bk;
  t_end = (k_end + bk - 1) / bk;
}

__device__ __forceinline__ bool keep(const Params& p, int qpos, int kpos) {
  return kpos < p.Sk && (!p.causal || qpos >= kpos) &&
         (p.window <= 0 || qpos - kpos < p.window);
}

// ------------------------------------------------------------ simt
namespace simt {

constexpr int BQ = 64;          // query rows per block
constexpr int BK = 64;          // key rows per tile
constexpr int THREADS = 256;

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

  int t_begin, t_end;
  tile_range(p, q0, min(q0 + BQ, p.Sq) - 1, BK, t_begin, t_end);

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
        s[i][j] = keep(p, qpos, kpos) ? x : NEG_INF;
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
cudaError_t dispatch(const Params& p, int B, int D, cudaStream_t stream) {
  switch (D) {
    case 32: return launch<T, 32>(p, B, stream);
    case 64: return launch<T, 64>(p, B, stream);
    case 96: return launch<T, 96>(p, B, stream);
    case 128: return launch<T, 128>(p, B, stream);
    case 256: return launch<T, 256>(p, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace simt

// ----------------------------------------------------------- wgmma
namespace wg {

using namespace hopper;
using bf16 = __nv_bfloat16;

constexpr int BK = 128;         // key rows per tile
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// One 128-row key tile for one consumer warpgroup: S = Q K^T, the online
// softmax, O += P V.  sq: its 64 Q rows (column blocks `q_block` bytes
// apart), sk / sv: the K and V tiles; row: this thread's first query
// row (its second is row + 8); masked: whether any of the warpgroup's
// (query, key) pairs in the tile is masked.  wait_v() returns once V has
// landed.
template <int D, typename WaitV>
__device__ __forceinline__ void tile_step(float (&o)[D / 2], float (&m)[2],
                                          float (&l)[2], uint32_t sq,
                                          uint32_t q_block, uint32_t sk,
                                          uint32_t sv, int k0, int row,
                                          const Params& p, bool masked,
                                          WaitV wait_v) {
  float s[BK / 2];
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss<BK>(s,
                 sw128_desc(sq + (kk >> 2) * q_block + (kk & 3) * 32, 16,
                            1024),
                 sw128_desc(sk + (kk >> 2) * (BK * 128) + (kk & 3) * 32, 16,
                            1024),
                 kk > 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(s);

  // s[4j + 2i + c]: query row + 8i, key k0 + 8j + 2 (t % 4) + c.  The
  // softmax runs on x = s (no softcap) or x = softcap(s / sqrt(D)), m
  // is the running max of x, and p = 2^(f x - f m) with f the rest of
  // the scale and log2 e, one FMA a score.
  float f = p.scale * LOG2E;
  if (p.softcap > 0.f) {
#pragma unroll
    for (int e = 0; e < BK / 2; ++e)
      s[e] = p.softcap * tanhf(s[e] * p.scale / p.softcap);
    f = LOG2E;
  }
  if (masked) {
    const int col = k0 + 2 * (threadIdx.x & 3);
#pragma unroll
    for (int e = 0; e < BK / 2; ++e)
      if (!keep(p, row + 8 * ((e >> 1) & 1), col + 8 * (e >> 2) + (e & 1)))
        s[e] = NEG_INF;
  }
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int e = 0; e < BK / 2; ++e)
    mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], s[e]);
  float corr[2], rs[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    corr[i] = ex2((m[i] - mx[i]) * f);
    m[i] = mx[i];
  }
  // a row whose keys so far are all masked (m = -2e38) takes p = 0: the
  // FMA would leave the product's rounding, ~1e30, in place of 0
  const float fm[2] = {m[0] == NEG_INF ? 0.f : f * m[0],
                       m[1] == NEG_INF ? 0.f : f * m[1]};
#pragma unroll
  for (int e = 0; e < BK / 2; ++e) {
    s[e] = ex2(fmaf(s[e], f, -fm[(e >> 1) & 1]));
    rs[(e >> 1) & 1] += s[e];
  }
  // l sums this thread's float32 probabilities; the quad's partial sums
  // are added at the end (corr is the same across the quad)
#pragma unroll
  for (int i = 0; i < 2; ++i) l[i] = l[i] * corr[i] + rs[i];
#pragma unroll
  for (int e = 0; e < D / 2; ++e) o[e] *= corr[(e >> 1) & 1];
  uint32_t a[BK / 16][4];
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
    for (int x = 0; x < 4; ++x)
      a[kk][x] = pack_bf16(s[8 * kk + 2 * x], s[8 * kk + 2 * x + 1]);

  wait_v();
  fence_regs(o);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    wgmma_rs<D>(o, a[kk], sw128_desc(sv + kk * 16 * 128, BK * 128, 1024), 1);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(o);
}

// O / l for this thread's two rows, stored as bf16 pairs into
// contiguous [B, Sq, H, D], rows past Sq skipped.
template <int D>
__device__ __forceinline__ void store_rows(const Params& p, float (&o)[D / 2],
                                           float (&l)[2], int row, int b,
                                           int h) {
  bf16* out = static_cast<bf16*>(p.out);
  const int c0 = 2 * (threadIdx.x & 3);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float li = l[i];
    li += __shfl_xor_sync(0xffffffffu, li, 1);
    li += __shfl_xor_sync(0xffffffffu, li, 2);
    const float inv = 1.f / fmaxf(li, 1e-30f);
    const int qpos = row + 8 * i;
    if (qpos >= p.Sq) continue;
    bf16* dst = out + ((static_cast<int64_t>(b) * p.Sq + qpos) * p.H + h) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(dst + 8 * j + c0) =
          pack_bf16(o[4 * j + 2 * i] * inv, o[4 * j + 2 * i + 1] * inv);
  }
}

// The kernel: a producer warpgroup brings Q and the K/V tiles by TMA,
// two consumer warpgroups each run tile_step over 64 query rows.
constexpr int CONSUMERS = 2;               // warpgroups of 64 query rows
constexpr int BQ = 64 * CONSUMERS;
// + the producer warpgroup: setmaxnreg moves registers between whole
// warpgroups, so the producer's 128 x (168 - 40) registers are what
// lets the consumers grow from 168 to 232
constexpr int THREADS = 128 * (CONSUMERS + 1);
constexpr int STAGES = 2;

template <int D>
struct Smem {
  static constexpr uint32_t Q = BQ * D * 2;
  static constexpr uint32_t TILE = BK * D * 2;
  // 64 bytes of mbarriers, then the 1024-aligned tiles
  static constexpr size_t bytes = 64 + 1024 + Q + STAGES * 2 * TILE;
};

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_wgmma_kernel(const Params p, const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv) {
  using S = Smem<D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem_raw);
  uint64_t* k_full = q_full + 1;            // [STAGES]
  uint64_t* v_full = k_full + STAGES;       // [STAGES]
  uint64_t* empty = v_full + STAGES;        // [STAGES]
  unsigned char* sQ = smem_raw + 64;
  sQ += (1024 - (smem_u32(sQ) & 1023)) & 1023;
  unsigned char* sK = sQ + S::Q;            // stage s: K at 2s TILE, V after

  const int nq = gridDim.x;
  const int q0 = (nq - 1 - blockIdx.x) * BQ;   // heaviest tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.H / p.Hkv);
  const int q_last = min(q0 + BQ, p.Sq) - 1;
  int t_begin, t_end;
  tile_range(p, q0, q_last, BK, t_begin, t_end);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full + s, 1);
      mbar_init(v_full + s, 1);
      mbar_init(empty + s, 128 * CONSUMERS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= 4 * CONSUMERS) {              // the producer warpgroup
    regs_dealloc<40>();
    if (warp == 4 * CONSUMERS && lane == 0) {
      mbar_expect_tx(q_full, S::Q);
      for (int c = 0; c < D / 64; ++c)
        tma_load_4d(sQ + c * BQ * 128, &tq, q_full, 64 * c, h, q0, b);
      for (int t = t_begin; t < t_end; ++t) {
        const int st = (t - t_begin) % STAGES, n = (t - t_begin) / STAGES;
        unsigned char* k = sK + st * 2 * S::TILE;
        mbar_wait(empty + st, (n & 1) ^ 1);   // fill n waits release n - 1
        mbar_expect_tx(k_full + st, S::TILE);
        for (int c = 0; c < D / 64; ++c)
          tma_load_4d(k + c * BK * 128, &tk, k_full + st, 64 * c, hk,
                      t * BK, b);
        mbar_expect_tx(v_full + st, S::TILE);
        for (int c = 0; c < D / 64; ++c)
          tma_load_4d(k + S::TILE + c * BK * 128, &tv, v_full + st, 64 * c,
                      hk, t * BK, b);
      }
    }
  } else {                                  // a consumer warpgroup
    regs_alloc<232>();
    const int wg = warp >> 2;
    const int w0 = q0 + 64 * wg, w_last = min(w0 + 63, p.Sq - 1);
    const int row = w0 + 16 * (warp & 3) + (lane >> 2);
    float o[D / 2], m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
#pragma unroll
    for (int e = 0; e < D / 2; ++e) o[e] = 0.f;
    mbar_wait(q_full, 0);
    const uint32_t sq = smem_u32(sQ) + wg * 64 * 128;
    for (int t = t_begin; t < t_end; ++t) {
      const int st = (t - t_begin) % STAGES, n = (t - t_begin) / STAGES;
      const uint32_t k = smem_u32(sK) + st * 2 * S::TILE;
      const int k0 = t * BK;
      mbar_wait(k_full + st, n & 1);
      // whether any of this warpgroup's pairs in the tile is valid, and
      // whether any is masked
      const bool live = w0 <= w_last && (!p.causal || k0 <= w_last) &&
                        (p.window <= 0 || k0 + BK - 1 > w0 - p.window);
      const bool masked = k0 + BK > p.Sk ||
                          (p.causal && k0 + BK - 1 > w0) ||
                          (p.window > 0 && w_last - k0 >= p.window);
      if (live)
        tile_step<D>(o, m, l, sq, BQ * 128, k, k + S::TILE, k0, row, p,
                     masked, [&] { mbar_wait(v_full + st, n & 1); });
      mbar_arrive(empty + st);
    }
    store_rows<D>(p, o, l, row, b, h);
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// libcuda's tensor-map encoder, looked up through the runtime once, so
// the library needs no -lcuda.
EncodeTiled encoder() {
  static EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
      f = nullptr;
    return reinterpret_cast<EncodeTiled>(f);
  }();
  return fn;
}

// A map over a [B, S, heads, D] bf16 tensor with the given element
// strides, whose box is 64 columns (128 bytes, the swizzle's width) of
// `rows` sequence positions of one head; rows past S read as zeros.
bool encode(CUtensorMap* map, const void* base, int B, int S, int heads,
            int D, int64_t sb, int64_t ss, int64_t sh, int rows) {
  EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(ss) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  if (!encode(&tq, p.q, B, p.Sq, p.H, D, p.qsb, p.qss, p.qsh, BQ) ||
      !encode(&tk, p.k, B, p.Sk, p.Hkv, D, p.ksb, p.kss, p.ksh, BK) ||
      !encode(&tv, p.v, B, p.Sk, p.Hkv, D, p.vsb, p.vss, p.vsh, BK))
    return cudaErrorInvalidValue;
  const size_t smem = Smem<D>::bytes;
  // once per instance, at its first launch (before any graph capture)
  static cudaError_t attr = cudaFuncSetAttribute(
      flash_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (attr != cudaSuccess) return attr;
  const dim3 grid((p.Sq + BQ - 1) / BQ, p.H, B);
  flash_wgmma_kernel<D><<<grid, THREADS, smem, stream>>>(p, tq, tk, tv);
  return cudaGetLastError();
}

cudaError_t dispatch(const Params& p, int B, int D, cudaStream_t stream) {
  switch (D) {
    case 64: return launch<64>(p, B, stream);
    case 128: return launch<128>(p, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace wg

}  // namespace

// dtype: 0 float32, 1 bfloat16; design: 0 simt, 1 wgmma (bf16 with
// head_dim 64 or 128 only; q, k, v 16-byte aligned with [B, S, H]
// strides of whole 16 bytes, which the wrapper checks and TMA needs).
// Strides are in elements; D has unit stride.  window <= 0 and softcap
// <= 0 mean none.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* out, int B, int Sq,
    int Sk, int H, int Hkv, int D, int64_t qsb, int64_t qss, int64_t qsh,
    int64_t ksb, int64_t kss, int64_t ksh, int64_t vsb, int64_t vss,
    int64_t vsh, int causal, int window, double softcap, int dtype,
    int design, void* stream_ptr) {
  if (B <= 0 || Sq <= 0) return 0;
  if (Sk <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 || B > 65535 ||
      H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const float sqrt_d = std::sqrt(static_cast<float>(D));
  Params p{q,   k,   v,   out, Sq,  Sk,     H,      Hkv,
           qsb, qss, qsh, ksb, kss, ksh,    vsb,    vss,
           vsh, causal, window, static_cast<float>(softcap), sqrt_d,
           1.f / sqrt_d};
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  cudaError_t err;
  if (design == 1 && dtype == 1)
    err = wg::dispatch(p, B, D, stream);
  else if (design == 0 && dtype == 0)
    err = simt::dispatch<float>(p, B, D, stream);
  else if (design == 0 && dtype == 1)
    err = simt::dispatch<__nv_bfloat16>(p, B, D, stream);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
