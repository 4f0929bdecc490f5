// MoE router gating: per token row, softmax over the E expert logits,
// k rounds of argmax-and-mask (a tie goes to the lower expert index),
// then the k chosen probabilities renormalized by max(sum, 1e-9).
//
// Replaces: src/repro/kernels/topk_gating.py, topk_gating (a Pallas grid
// over blocks of block_t token rows with E in the lanes, so each round's
// max is one lane reduction; T had to be a multiple of block_t).
//
// Bound on the H100: memory.  The call reads T * E logits and writes
// T * k weights and ids; at olmoe-1b-7b's router group ([4096, 64]
// float32, k = 8, the MoE round's shape; femnist, the main path, has no
// router) that is 1.3 MB, about 0.4 us at 3.35 TB/s, below a launch, so
// what a call costs is its launch and the latency of one dependent chain
// per row: load, softmax, k rounds, store.
//
// Design: a row gets L = bucket(E) / 8 lanes (E = 64: 8 lanes, 4 rows a
// warp; E <= 8: one lane a row), instantiated per L, so each lane owns 8
// consecutive experts, loaded as 16-byte vectors when the row allows it.
// The softmax reduces over the row's lanes only: log2(L) shuffle levels.
// Each probability p >= +0 becomes one 64-bit key, (bits(p) << 32) |
// ~index: non-negative floats order like their bits, so the largest key
// is the largest probability with the lowest index on a tie, as the
// plain version's argmax picks, and 0 (a dead slot, a taken expert) lies
// below every live key, an underflowed p = +0 included.  A lane sorts its
// 8 keys once (a 19-exchange network); a round then reduces the lanes'
// heads in log2(L) levels, and the winning lane pops its head.  The k
// winners stay in registers (k <= 8; later rounds of a larger k are
// written as they come and rescaled at the end), are renormalized there,
// and one lane writes the row's weights and ids as vectors.  No shared
// memory.  Any T: rows past T in the last warp compute on zeros and
// store nothing.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;          // warps a block
constexpr int PER_LANE = 8;       // experts a lane owns
constexpr int MAX_E = 256;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// 4 consecutive logits as float32 (16 bytes of float32, 8 of bf16)
__device__ __forceinline__ void load4(const float* p, float* v) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* v) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&q.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&q.y);
  v[0] = __low2float(a); v[1] = __high2float(a);
  v[2] = __low2float(b); v[3] = __high2float(b);
}

__device__ __forceinline__ void cas(uint64_t& a, uint64_t& b) {
  const uint64_t hi = a > b ? a : b, lo = a > b ? b : a;
  a = hi;
  b = lo;
}

// descending sort of 8 keys: Batcher's odd-even merge network
__device__ __forceinline__ void sort8(uint64_t (&k)[PER_LANE]) {
  cas(k[0], k[1]); cas(k[2], k[3]); cas(k[4], k[5]); cas(k[6], k[7]);
  cas(k[0], k[2]); cas(k[1], k[3]); cas(k[4], k[6]); cas(k[5], k[7]);
  cas(k[1], k[2]); cas(k[5], k[6]); cas(k[0], k[4]); cas(k[3], k[7]);
  cas(k[1], k[5]); cas(k[2], k[6]);
  cas(k[1], k[4]); cas(k[3], k[6]);
  cas(k[2], k[4]); cas(k[3], k[5]);
  cas(k[3], k[4]);
}

template <int L>
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int off = L / 2; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
template <int L>
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int off = L / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// one round: the row's largest live key, in every lane of the row, and
// the lane that holds it pops its head
template <int L>
__device__ __forceinline__ uint64_t take(uint64_t (&key)[PER_LANE]) {
  uint64_t best = key[0];
#pragma unroll
  for (int off = L / 2; off > 0; off >>= 1) {
    const uint64_t o = __shfl_xor_sync(0xffffffffu, best, off);
    best = o > best ? o : best;
  }
  if (key[0] == best) {
#pragma unroll
    for (int j = 0; j < PER_LANE - 1; ++j) key[j] = key[j + 1];
    key[PER_LANE - 1] = 0;
  }
  return best;
}

__device__ __forceinline__ float key_w(uint64_t key) {
  return __uint_as_float(static_cast<uint32_t>(key >> 32));
}
__device__ __forceinline__ int32_t key_id(uint64_t key) {
  return static_cast<int32_t>(~static_cast<uint32_t>(key));
}

template <typename T, int L>
__global__ void __launch_bounds__(WARPS * 32)
topk_gating_kernel(const T* __restrict__ logits, float* __restrict__ w_out,
                   int32_t* __restrict__ id_out, int64_t rows, int E, int k,
                   bool vec) {
  constexpr int ROWS_PER_WARP = 32 / L;
  const int lane = threadIdx.x & 31;
  const int64_t warp_row0 =
      (static_cast<int64_t>(blockIdx.x) * WARPS + (threadIdx.x >> 5)) *
      ROWS_PER_WARP;
  if (warp_row0 >= rows) return;             // whole warps leave together
  const int gl = lane % L;                   // lane within the row
  const int64_t row = warp_row0 + lane / L;
  const bool live = row < rows;
  const int e0 = gl * PER_LANE;              // this lane's first expert

  float p[PER_LANE];
  if (live && vec) {
    const T* x = logits + row * E + e0;
#pragma unroll
    for (int c = 0; c < PER_LANE; c += 4) {
      if (e0 + c < E) {
        load4(x + c, p + c);
      } else {
        p[c] = p[c + 1] = p[c + 2] = p[c + 3] = -INFINITY;
      }
    }
  } else {
    const T* x = logits + (live ? row : 0) * E + e0;
#pragma unroll
    for (int j = 0; j < PER_LANE; ++j)
      p[j] = live && e0 + j < E ? to_f(x[j]) : (e0 + j < E ? 0.f : -INFINITY);
  }

  float mx = p[0];
#pragma unroll
  for (int j = 1; j < PER_LANE; ++j) mx = fmaxf(mx, p[j]);
  mx = row_max<L>(mx);
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < PER_LANE; ++j) {
    p[j] = e0 + j < E ? expf(p[j] - mx) : 0.f;
    sum += p[j];
  }
  sum = row_sum<L>(sum);

  uint64_t key[PER_LANE];
#pragma unroll
  for (int j = 0; j < PER_LANE; ++j) {
    const float q = p[j] / sum;              // >= +0, as torch.softmax's
    key[j] = e0 + j < E
                 ? (static_cast<uint64_t>(__float_as_uint(q)) << 32) |
                       static_cast<uint32_t>(~(e0 + j))
                 : 0ull;
  }
  sort8(key);

  uint64_t win[PER_LANE];
  float wsum = 0.f;
#pragma unroll
  for (int r = 0; r < PER_LANE; ++r) {
    win[r] = 0;
    if (r < k) {
      win[r] = take<L>(key);
      wsum += key_w(win[r]);
    }
  }
  float* wr = w_out + row * k;
  int32_t* ir = id_out + row * k;
  for (int r = PER_LANE; r < k; ++r) {       // k > 8: raw now, rescaled below
    const uint64_t b = take<L>(key);
    wsum += key_w(b);
    if (live && gl == 0) {
      wr[r] = key_w(b);
      ir[r] = key_id(b);
    }
  }
  if (!live || gl != 0) return;
  const float denom = fmaxf(wsum, 1e-9f);
  float w[PER_LANE];
  int32_t id[PER_LANE];
#pragma unroll
  for (int r = 0; r < PER_LANE; ++r) {
    w[r] = key_w(win[r]) / denom;
    id[r] = key_id(win[r]);
  }
  if (k % 4 == 0) {                          // 16-byte aligned rows
#pragma unroll
    for (int r = 0; r < PER_LANE; r += 4) {
      if (r < k) {
        *reinterpret_cast<float4*>(wr + r) =
            make_float4(w[r], w[r + 1], w[r + 2], w[r + 3]);
        *reinterpret_cast<int4*>(ir + r) =
            make_int4(id[r], id[r + 1], id[r + 2], id[r + 3]);
      }
    }
  } else if (k % 2 == 0) {                   // 8-byte aligned rows
#pragma unroll
    for (int r = 0; r < PER_LANE; r += 2) {
      if (r < k) {
        *reinterpret_cast<float2*>(wr + r) = make_float2(w[r], w[r + 1]);
        *reinterpret_cast<int2*>(ir + r) = make_int2(id[r], id[r + 1]);
      }
    }
  } else {
#pragma unroll
    for (int r = 0; r < PER_LANE; ++r) {
      if (r < k) {
        wr[r] = w[r];
        ir[r] = id[r];
      }
    }
  }
  for (int r = PER_LANE; r < k; ++r) wr[r] = wr[r] / denom;
}

template <typename T, int L>
int launch(const void* logits, float* w_out, int32_t* id_out, int64_t rows,
           int E, int k, bool vec, cudaStream_t stream) {
  constexpr int64_t ROWS_PER_BLOCK = WARPS * (32 / L);
  const int64_t blocks = (rows + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  topk_gating_kernel<T, L><<<static_cast<unsigned>(blocks), WARPS * 32, 0,
                             stream>>>(static_cast<const T*>(logits), w_out,
                                       id_out, rows, E, k, vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int by_lanes(int lanes, const void* logits, float* w_out, int32_t* id_out,
             int64_t rows, int E, int k, bool vec, cudaStream_t s) {
  switch (lanes) {
    case 1: return launch<T, 1>(logits, w_out, id_out, rows, E, k, vec, s);
    case 2: return launch<T, 2>(logits, w_out, id_out, rows, E, k, vec, s);
    case 4: return launch<T, 4>(logits, w_out, id_out, rows, E, k, vec, s);
    case 8: return launch<T, 8>(logits, w_out, id_out, rows, E, k, vec, s);
    case 16: return launch<T, 16>(logits, w_out, id_out, rows, E, k, vec, s);
    case 32: return launch<T, 32>(logits, w_out, id_out, rows, E, k, vec, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  logits [rows, E] contiguous, 1 <= k <=
// E <= 256; w_out [rows, k] float32, id_out [rows, k] int32.  lanes: the
// lanes a row takes, the wrapper's choice for E (E <= 8 * lanes <= 256).
// vec: E % 4 == 0 and a 16-byte aligned base, so each lane's experts
// load as 4-element vectors.
extern "C" int topk_gating_launch(const void* logits, float* w_out,
                                  int32_t* id_out, int64_t rows, int E,
                                  int k, int dtype, int lanes, int vec,
                                  void* stream_ptr) {
  if (rows <= 0) return 0;
  if (E < 1 || E > MAX_E || k < 1 || k > E || E > PER_LANE * lanes)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (dtype == 0)
    return by_lanes<float>(lanes, logits, w_out, id_out, rows, E, k,
                           vec != 0, stream);
  if (dtype == 1)
    return by_lanes<__nv_bfloat16>(lanes, logits, w_out, id_out, rows, E, k,
                                   vec != 0, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
