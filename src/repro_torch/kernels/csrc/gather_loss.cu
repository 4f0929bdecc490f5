// Fused resample gather + linear-head cross-entropy, one loss per row:
// out[i] = xent(src[idx[i]] @ w (+ b), labels[idx[i]]).
//
// Replaces: src/repro/kernels/gather_loss.py, gather_loss_microbatch (a
// Pallas scalar-prefetch grid that streamed source row idx[i] straight
// into the head matmul and log-softmax, so the gathered minibatch never
// reached device memory).
//
// Bound on the H100: the larger of the bytes (the M gathered rows of D
// values, the D x K head, the labels) over 3.35 TB/s and the 2 M D K
// float32 operations over 67 TFLOP/s (TF32 stays off, as everywhere in
// the port).  At femnist cut 3 (M = 16, D = 2048, K = 10) both are far
// below a launch, so the chain of dependent latencies sets the time
// (the index, then its row, then a cluster barrier); at a large server
// batch (M = 2048, D = 2048, K = 62) the operations bound it at ~7.8 us.
//
// Design.  A block of 8 warps owns a tile of BM = 32 gathered rows and
// walks the classes in tiles of KT = 16, 32 or 64 (the smallest that
// holds K, at most 64; columns past K are masked to -inf in the
// epilogue).  It streams D in chunks of BD = 128 through a ring of 3
// stages in shared memory filled by cp.async: each row's chunk comes from
// its own src[idx[r]], so the gather is the copy (16-byte copies, or 8,
// 4 and plain 2-byte ones for rows too short or misaligned), and w's
// chunk comes with it, as one contiguous range of BD x K values when one
// class tile holds K (16-byte copies whatever K; w's first chunks are
// requested under the latency of the indices), else row by row.
//
// The product is a register-tiled float32 FMA micro-GEMM on the CUDA
// cores: a thread owns 8 rows x KT / 8 columns, so at KT = 64 each 4-byte
// value brought from shared memory feeds one FMA (shared memory delivers
// 128 bytes a cycle to an SM's registers, its FMA units 128 FMAs).  Each
// warp owns the tile's 32 rows and four 4-wide steps of every chunk's D,
// taken two at a time so the second's loads run under the first's FMAs;
// the block sums the 8 warps' partials in warp order.  Lanes whose rows
// all lie past M skip the product.
//
// Where the row tiles alone cannot fill the card (femnist's M = 16 is
// one tile; M = 2048 gives 64), the wrapper splits D across a thread
// block cluster of up to 8 blocks, as many as keep the launch to one wave
// of one block an SM.  Each block stores the partial logits of its D
// slice straight into the shared memory of the rank that owns the row
// (rank r owns BM / cs rows; two buffers by class tile parity), and after
// one cluster barrier the owner sums the slices in rank order from its
// own shared memory: no remote loads, no atomics, no second launch.  The
// epilogue is one warp per row: max, sum of exponentials and the label's
// logit by shuffles, carried across class tiles as a running max and
// rescaled sum (flash attention's trick) when K > 64.  An index outside
// [0, T) or a label outside [0, K) gives NaN for that row.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int BM = 32;          // gathered rows a block
constexpr int BD = 128;         // D a stage
constexpr int STAGES = 3;
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int RM = 8;           // rows a thread: 4 x 8 threads of a warp
constexpr int STEPS = BD / (4 * WARPS);   // 4-wide D steps a warp, a chunk
static_assert(STEPS % 2 == 0, "a warp takes its steps two at a time");
constexpr int MAX_CLUSTER = 8;

template <typename S>
__host__ __device__ constexpr int a_stride() {
  return BD + 16 / static_cast<int>(sizeof(S));
}

// shared memory: the ring, or (after the D loop) each warp's partial
// logits [BM, KT + 4]; then the receive buffers, two [BM, KT + 4], which
// the other ranks write while this block may still be in its D loop
template <typename S, typename W, int KT>
__host__ __device__ constexpr int ring_bytes() {
  const int ring = STAGES * (BM * a_stride<S>() * static_cast<int>(sizeof(S)) +
                             BD * KT * static_cast<int>(sizeof(W)));
  const int part = WARPS * BM * (KT + 4) * 4;
  return ring > part ? ring : part;
}
template <typename S, typename W, int KT>
__host__ __device__ constexpr int smem_bytes() {
  return ring_bytes<S, W, KT>() + 2 * BM * (KT + 4) * 4;
}

// 4 consecutive values from shared memory as float32
__device__ __forceinline__ void lds4(const float* p, float* v) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void lds4(const __nv_bfloat16* p, float* v) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&q.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&q.y);
  v[0] = __low2float(a); v[1] = __high2float(a);
  v[2] = __low2float(b); v[3] = __high2float(b);
}

// One copy of `bytes` (16, 8, 4: cp.async; 2: a plain load and store)
// from global to shared memory, zero-filled when `valid` is false.  A copy
// is whole or absent: the wrapper picks `bytes` so no copy straddles the
// end of a row.
template <typename T>
__device__ __forceinline__ void copy(T* dst, const T* src, bool valid,
                                     int bytes) {
  const uint32_t d = hopper::smem_u32(dst);
  if (bytes == 16) {
    hopper::cp_async16(d, src, valid);
  } else if (bytes == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d),
                 "l"(src), "r"(valid ? 8 : 0)
                 : "memory");
  } else if (bytes == 4) {
    hopper::cp_async4(d, src, valid);
  } else {
    *reinterpret_cast<uint16_t*>(dst) =
        valid ? *reinterpret_cast<const uint16_t*>(src) : uint16_t{0};
  }
}

// a 16-byte cp.async of which the first `bytes` (0 to 16) are read and
// the rest zero-filled
__device__ __forceinline__ void cp_async16_n(void* dst, const void* src,
                                             int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   hopper::smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

struct Args {
  const void* src;        // [T, D] S
  const void* labels;     // [T] int32 or int64
  const int32_t* idx;     // [M]
  const void* w;          // [D, K] W
  const float* b;         // [K] or null
  float* out;             // [M]
  int64_t T, M, D;
  int K, label_bytes, cs, a_bytes, w_bytes, w_base16;
};

template <typename S, typename W, int KT>
__global__ void __launch_bounds__(THREADS, 1)
gather_loss_kernel(const Args p) {
  constexpr int AS = a_stride<S>();
  constexpr int A_STAGE = BM * AS;                 // elements of S
  constexpr int W_STAGE = BD * KT;                 // elements of W
  constexpr int CN = KT / 8;                       // columns a thread
  constexpr int PS = KT + 4;                       // partial-tile row stride
  constexpr int UC = (KT + 31) / 32;               // columns a lane, epilogue
  extern __shared__ __align__(16) unsigned char smem[];
  S* a_ring = reinterpret_cast<S*>(smem);
  W* w_ring = reinterpret_cast<W*>(smem + STAGES * A_STAGE * sizeof(S));
  float* part = reinterpret_cast<float*>(smem);    // [WARPS][BM][PS]
  // [2][cs][rpr][PS]: what each rank sends this rank, by class tile parity
  float* recv = reinterpret_cast<float*>(smem + ring_bytes<S, W, KT>());
  __shared__ int64_t s_row[BM];                    // src row, -1: invalid
  __shared__ int64_t s_y[BM];                      // label, -1: invalid
  __shared__ float s_m[BM], s_s[BM], s_yl[BM];     // running log-sum-exp

  const S* src = static_cast<const S*>(p.src);
  const W* w = static_cast<const W*>(p.w);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ty = lane >> 3, tx = lane & 7;
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = p.cs;
  const int rank = cs > 1 ? static_cast<int>(cluster.block_rank()) : 0;
  const int64_t m0 = static_cast<int64_t>(blockIdx.x / cs) * BM;
  const int mrows = static_cast<int>(p.M - m0 < BM ? p.M - m0 : BM);
  // no block writes a peer's shared memory before every peer has started:
  // arrive now, wait before the first remote store
  if (cs > 1)
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  // this block's chunks of D.  With K <= KT a chunk of w is one
  // contiguous range of BD x K values, copied and kept so (row stride K);
  // else its [BD, KT] class tile, row by row (row stride KT)
  const int64_t nch = (p.D + BD - 1) / BD;
  const int64_t c_lo = rank * nch / cs, n = (rank + 1) * nch / cs - c_lo;
  const bool flat = p.K <= KT;
  const int wst = flat ? p.K : KT;
  const int a_el = p.a_bytes / sizeof(S), w_el = p.w_bytes / sizeof(W);
  const int a_sh = __ffs(BD / a_el) - 1, w_per_row = wst / w_el;

  auto load_w = [&](int64_t c, int slot, int k0) {
    const int64_t d0 = c * BD;
    W* ws = w_ring + slot * W_STAGE;
    if (flat && p.w_base16) {
      const int64_t rows = p.D - d0 < BD ? p.D - d0 : BD;
      const int bytes = static_cast<int>(rows * p.K * sizeof(W));
      const unsigned char* g =
          reinterpret_cast<const unsigned char*>(w + d0 * p.K);
      for (int q = tid; q < BD * p.K * static_cast<int>(sizeof(W)) / 16;
           q += THREADS) {
        const int left = min(max(bytes - 16 * q, 0), 16);
        cp_async16_n(reinterpret_cast<unsigned char*>(ws) + 16 * q,
                     g + (left > 0 ? 16 * q : 0), left);
      }
      return;
    }
    for (int q = tid; q < BD * w_per_row; q += THREADS) {
      const int r = q / w_per_row, e = (q % w_per_row) * w_el;
      const bool ok = d0 + r < p.D && k0 + e < p.K;
      copy(ws + r * wst + e, w + (ok ? (d0 + r) * p.K + k0 + e : 0), ok,
           p.w_bytes);
    }
  };
  auto load_a = [&](int64_t c, int slot) {
    const int64_t d0 = c * BD;
    S* as = a_ring + slot * A_STAGE;
    for (int q = tid; q < (mrows << a_sh); q += THREADS) {
      const int r = q >> a_sh, e = (q & ((1 << a_sh) - 1)) * a_el;
      const int64_t row = s_row[r];
      const bool ok = row >= 0 && d0 + e < p.D;
      copy(as + r * AS + e, src + (ok ? row * p.D + d0 + e : 0), ok,
           p.a_bytes);
    }
  };

  // the tile's source rows are requested first, then w's first chunks,
  // which need no index, under their latency; the labels are stored only
  // after the D loop, so their latency hides under it
  const int32_t i = tid < mrows ? p.idx[m0 + tid] : -1;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s)
    if (s < n) load_w(c_lo + s, s, 0);
  int64_t my_y = -1;
  if (tid < BM) {
    int64_t row = -1;
    if (tid < mrows) {
      if (i >= 0 && i < p.T) {
        row = i;
        my_y = p.label_bytes == 8 ? static_cast<const int64_t*>(p.labels)[i]
                                  : static_cast<const int32_t*>(p.labels)[i];
      }
    }
    s_row[tid] = row;
    s_m[tid] = -INFINITY;
    s_s[tid] = 0.f;
    s_yl[tid] = 0.f;
  }
  __syncthreads();
  const int rpr = BM / cs;                          // rows this rank reduces
  const bool live = ty * RM < mrows;                // this thread's rows

  for (int k0 = 0, tile = 0; k0 < p.K; k0 += KT, ++tile) {
    if (k0 > 0) {
#pragma unroll
      for (int s = 0; s < STAGES - 1; ++s)
        if (s < n) load_w(c_lo + s, s, k0);
    }
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < n) load_a(c_lo + s, s);
      hopper::cp_async_commit();
    }

    // rows ty * 8 + i, columns tx * 4 + 32 h + j (KT = 64) or tx * CN + j,
    // D steps 4 * (warp + 8 h) of each chunk; a row past M holds whatever
    // the ring held and is never read, a column past K is masked
    float acc[RM][CN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) acc[i][j] = 0.f;

    for (int64_t c = 0; c < n; ++c) {
      hopper::cp_async_wait<STAGES - 2>();
      __syncthreads();
      const int64_t nc = c + STAGES - 1;
      if (nc < n) {
        const int slot = static_cast<int>(nc % STAGES);
        load_w(c_lo + nc, slot, k0);
        load_a(c_lo + nc, slot);
      }
      hopper::cp_async_commit();
      const int slot = static_cast<int>(c % STAGES);
      if (live) {
        // two steps at a time, both steps' operands first, so the second's
        // loads run under the first's FMAs
#pragma unroll
        for (int h0 = 0; h0 < STEPS; h0 += 2) {
        float a[2][RM][4], wv[2][4][CN];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int dq = 4 * (warp + WARPS * (h0 + h));
          const S* as = a_ring + slot * A_STAGE + ty * RM * AS + dq;
          const W* ws = w_ring + slot * W_STAGE + dq * wst;
#pragma unroll
          for (int i = 0; i < RM; ++i) lds4(as + i * AS, a[h][i]);
#pragma unroll
          for (int q = 0; q < 4; ++q)
#pragma unroll
            for (int j = 0; j < CN; ++j) {
              const int col = CN == 8 ? 4 * tx + (j & 3) + 32 * (j >> 2)
                                      : CN * tx + j;
              wv[h][q][j] = to_f(ws[q * wst + col]);
            }
        }
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int q = 0; q < 4; ++q)
#pragma unroll
            for (int i = 0; i < RM; ++i)
#pragma unroll
              for (int j = 0; j < CN; ++j)
                acc[i][j] = fmaf(a[h][i][q], wv[h][q][j], acc[i][j]);
        }
      }
    }
    hopper::cp_async_wait<0>();
    __syncthreads();                                // the ring is free

    // each warp's partial logits, then the block's: the D steps summed in
    // warp order
    float* pw = part + warp * BM * PS;
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      float* pr = pw + (ty * RM + i) * PS;
      if constexpr (CN == 8) {
        *reinterpret_cast<float4*>(pr + 4 * tx) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
        *reinterpret_cast<float4*>(pr + 32 + 4 * tx) =
            make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
      } else if constexpr (CN == 4) {
        *reinterpret_cast<float4*>(pr + 4 * tx) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      } else {
        *reinterpret_cast<float2*>(pr + 2 * tx) =
            make_float2(acc[i][0], acc[i][1]);
      }
    }
    __syncthreads();
    // the block's partial of each row (the warps' D steps summed in warp
    // order) goes to the row's owner, rank r / rpr, as slot `rank` of
    // its receive buffer for this tile's parity: remote stores, no loads
    float* rbuf = recv + (tile & 1) * BM * PS;
    if (cs > 1 && tile == 0)
      asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
    for (int q = tid; q < mrows * KT; q += THREADS) {
      const int r = q / KT, col = q % KT;
      float v = part[r * PS + col];
#pragma unroll
      for (int k = 1; k < WARPS; ++k) v += part[(k * BM + r) * PS + col];
      const int owner = r / rpr;
      float* dst = rbuf + (rank * rpr + r % rpr) * PS + col;
      if (cs > 1) *cluster.map_shared_rank(dst, owner) = v;
      else *dst = v;
    }
    if (tid < BM) s_y[tid] = my_y;
    if (cs > 1) cluster.sync(); else __syncthreads();

    // this rank's rows [rank * rpr, (rank + 1) * rpr): the ranks' slices
    // summed in rank order, folded into the running log-sum-exp, one warp
    // a row
    for (int r = rank * rpr + warp; r < (rank + 1) * rpr && r < mrows;
         r += WARPS) {
      const int64_t y = s_y[r];
      float v[UC], tmax = -INFINITY, pick = 0.f;
#pragma unroll
      for (int u = 0; u < UC; ++u) {
        const int col = lane + 32 * u;
        const float* rr = rbuf + (r - rank * rpr) * PS + col;
        v[u] = 0.f;
        if (col < KT)
          for (int q = 0; q < cs; ++q) v[u] += rr[q * rpr * PS];
        const int kg = k0 + col;
        if (col < KT && kg < p.K) {
          if (p.b != nullptr) v[u] += p.b[kg];
          if (kg == y) pick = v[u];
        } else {
          v[u] = -INFINITY;
        }
        tmax = fmaxf(tmax, v[u]);
      }
      tmax = warp_max(tmax);
      const float m_old = s_m[r], m_new = fmaxf(m_old, tmax);
      float se = 0.f;
#pragma unroll
      for (int u = 0; u < UC; ++u) se += expf(v[u] - m_new);
      se = warp_sum(se);
      pick = warp_sum(pick);                        // the label's lane alone
      __syncwarp();
      if (lane == 0) {
        s_s[r] = s_s[r] * expf(m_old - m_new) + se;
        s_m[r] = m_new;
        if (y >= k0 && y < k0 + KT) s_yl[r] = pick;
      }
    }
    // the ring is refilled by the next tile only after every warp is done
    // with this one's rows; the other ranks write the other parity
    __syncthreads();
  }
  __syncthreads();

  for (int r = rank * rpr + tid; r < (rank + 1) * rpr && r < mrows;
       r += THREADS) {
    const int64_t y = s_y[r];
    p.out[m0 + r] = (s_row[r] < 0 || y < 0 || y >= p.K)
                        ? NAN
                        : -((s_yl[r] - s_m[r]) - logf(s_s[r]));
  }
}

template <typename S, typename W, int KT>
int launch(const Args& a, cudaStream_t stream) {
  constexpr int smem = smem_bytes<S, W, KT>();
  auto kernel = gather_loss_kernel<S, W, KT>;
  static cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int64_t tiles = (a.M + BM - 1) / BM;
  if (tiles * a.cs > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(tiles * a.cs));
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute cluster_dim[1];
  cluster_dim[0].id = cudaLaunchAttributeClusterDimension;
  cluster_dim[0].val.clusterDim.x = a.cs;
  cluster_dim[0].val.clusterDim.y = 1;
  cluster_dim[0].val.clusterDim.z = 1;
  cfg.attrs = cluster_dim;
  cfg.numAttrs = a.cs > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// how many clusters of `cluster` blocks the card holds at once (-1: the
// query failed)
template <typename S, typename W, int KT>
int clusters_of(int cluster) {
  constexpr int smem = smem_bytes<S, W, KT>();
  auto kernel = gather_loss_kernel<S, W, KT>;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem) != cudaSuccess)
    return -1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute cluster_dim[1];
  cluster_dim[0].id = cudaLaunchAttributeClusterDimension;
  cluster_dim[0].val.clusterDim.x = cluster;
  cluster_dim[0].val.clusterDim.y = 1;
  cluster_dim[0].val.clusterDim.z = 1;
  cfg.attrs = cluster_dim;
  cfg.numAttrs = 1;
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, kernel, &cfg) != cudaSuccess)
    return -1;
  return n;
}

template <typename S, typename W>
int by_tile(int k_tile, const Args& a, cudaStream_t s) {
  switch (k_tile) {
    case 16: return launch<S, W, 16>(a, s);
    case 32: return launch<S, W, 32>(a, s);
    case 64: return launch<S, W, 64>(a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename S, typename W>
int max_clusters(int k_tile, int cluster) {
  switch (k_tile) {
    case 16: return clusters_of<S, W, 16>(cluster);
    case 32: return clusters_of<S, W, 32>(cluster);
    case 64: return clusters_of<S, W, 64>(cluster);
    default: return -1;
  }
}

bool copy_ok(int bytes, int elem) {
  return bytes == 16 || bytes == 8 || bytes == 4 || (bytes == 2 && elem == 2);
}

}  // namespace

// src_dtype, w_dtype: 0 = float32, 1 = bfloat16.  label_bytes: 4 or 8.
// b may be null (no bias); it is float32 when given.  The launch shape is
// the wrapper's (gather_loss.launch_shape): k_tile 16, 32 or 64, cluster
// 1, 2, 4 or 8 blocks splitting D, and the bytes of one copy of a src
// row and of a w row (16, 8 or 4; 2 for bf16 rows of odd length), which
// every row's length and the base must allow.
extern "C" int gather_loss_launch(const void* src, const void* labels,
                                  const int32_t* idx, const void* w,
                                  const float* b, float* out, int64_t T,
                                  int64_t M, int64_t D, int K, int src_dtype,
                                  int w_dtype, int label_bytes, int k_tile,
                                  int cluster, int src_copy, int w_copy,
                                  int w_base16, void* stream_ptr) {
  if (M <= 0) return 0;
  const int s_el = src_dtype == 1 ? 2 : 4, w_el = w_dtype == 1 ? 2 : 4;
  if (M > 2147483647LL || K <= 0 || K > 8192 || D <= 0 || cluster < 1 ||
      cluster > MAX_CLUSTER || BM % cluster != 0 ||
      (label_bytes != 4 && label_bytes != 8) || !copy_ok(src_copy, s_el) ||
      !copy_ok(w_copy, w_el) || (k_tile < 64 && K > k_tile))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{src, labels, idx, w, b, out, T, M, D, K, label_bytes,
               cluster, src_copy, w_copy, w_base16 != 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream_ptr);
  if (src_dtype == 0 && w_dtype == 0)
    return by_tile<float, float>(k_tile, a, s);
  if (src_dtype == 0 && w_dtype == 1)
    return by_tile<float, __nv_bfloat16>(k_tile, a, s);
  if (src_dtype == 1 && w_dtype == 0)
    return by_tile<__nv_bfloat16, float>(k_tile, a, s);
  if (src_dtype == 1 && w_dtype == 1)
    return by_tile<__nv_bfloat16, __nv_bfloat16>(k_tile, a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// How many clusters of `cluster` blocks (1 to 8) of the kernel for these
// dtypes and k_tile the current card runs at once, so the wrapper can
// keep a launch to one wave; -1 when the query fails.
extern "C" int gather_loss_max_clusters(int src_dtype, int w_dtype,
                                        int k_tile, int cluster) {
  if (cluster < 1 || cluster > MAX_CLUSTER) return -1;
  if (src_dtype == 0 && w_dtype == 0)
    return max_clusters<float, float>(k_tile, cluster);
  if (src_dtype == 0 && w_dtype == 1)
    return max_clusters<float, __nv_bfloat16>(k_tile, cluster);
  if (src_dtype == 1 && w_dtype == 0)
    return max_clusters<__nv_bfloat16, float>(k_tile, cluster);
  if (src_dtype == 1 && w_dtype == 1)
    return max_clusters<__nv_bfloat16, __nv_bfloat16>(k_tile, cluster);
  return -1;
}
