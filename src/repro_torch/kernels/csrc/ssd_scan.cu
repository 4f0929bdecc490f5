// Mamba-2 SSD scan (state-space duality, forward): for each (batch,
// head) the recurrence h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t^T,
// y_t = C_t h_t, with h [N, P] starting at zero, computed in the chunked
// dual form: within a tile of rows
//   y_i = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
//         + exp(cum_i) C_i h,          cum_i = sum_{k <= i} dt_k A,
// and the state leaves the tile as
//   h' = exp(cum_last) h + sum_j B_j (dt_j exp(cum_last - cum_j)) x_j^T.
// Layouts of the JAX package's mamba2.py: x [B, L, H, P], dt [B, L, H]
// float32, A [H] float32 (negative), B and C [B, L, G, N] with head h
// reading group h / (H / G), y [B, L, H, P] in x's type, and the final
// state h [B, H, N, P] float32.
//
// Replaces: src/repro/kernels/ssd_scan.py, ssd_scan (a Pallas grid (B,
// H, chunks) whose innermost chunk axis runs in order and carries the
// [N, P] state in VMEM scratch from one chunk to the next; B and C per
// head, [B, L, H, N]).
//
// Bound on the H100: bytes.  At zamba2-1.2b's [2, 2048, 64, 64] bf16
// with N 64 the call reads x, dt, B and C and writes y and the state,
// about 71 MB (21 us at 3.35 TB/s); its least work, the recurrence's
// 5 N P operations a row and head, is about 5.4 GFLOP whatever the
// chunk (5 us on the bf16 tensor cores; 80 us in float32 on the CUDA
// cores, which bounds the float32 call).
//
// On Hopper nothing carries between blocks, so a block walks the
// sequence itself in tiles of 64 rows and keeps the state.  The
// caller's chunk does not change the function, only where rounding
// happens.  Every exponent is non-positive (cum_i - cum_j only for j <=
// i, cum_i, cum_last - cum_j), so nothing reaches inf and the masked
// half is never exponentiated; the diagonal j = i is in.  x, B and C
// are read through their [B, L, *, *] strides (unit stride in the last
// dim), so the model's column slices of one conv output need no copy,
// and a block reads its head's group of B and C, never a repeated
// copy.  Rows past L in the last tile are zero (dt 0, so cum stays
// flat) and are not written.  Two designs, chosen by the caller
// (kernels/ssd_scan.py, `design`):
//
// wgmma (bf16, N 64 or 128, P 64): the four products on the tensor
// cores.  One warpgroup (128 threads) owns one (head, batch, segment of
// the sequence).  C, B, x and dt tiles arrive by cp.async copies into
// the 128-byte swizzled layout of hopper.cuh.  A tile: S = C B^T
// (m64n64k16, both K-major over N); W = S exp(cum_i - cum_j) dt_j in
// S's fragment; Z = C h (h MN-major); y = exp(cum_i) Z + W x (W from
// registers, x MN-major), scaled after the product so that no scaled
// operand is rounded; y leaves through shared memory as whole 128-byte
// rows while the tensor cores take h = exp(cum_last) h + (B o u)^T x,
// with h in float32 accumulators (one m64n64 per 64 rows of N) and
// (B o u) [j, n] as an MN-major A in B's layout.  C, B and x are bf16
// already, so their products are exact in float32; W, B o u and h are
// float32, and a bf16 operand would move y by ~2^-9 of itself, more
// than the one-ulp check allows, so each is split into hi = bf16(v) and
// lo = bf16(v - hi) and takes two products into one accumulator
// (~2^-17).  Three barriers a tile: the tile landed, (B o u) written,
// the tile free.  A block has one warpgroup, so its own latencies are
// hidden only by the other blocks on its SM: the sequence runs in as
// many segments as let all (head, batch, segment) blocks run at once
// (ssd_scan_segments: 3 at zamba2's shape, 60,672 bytes of shared
// memory and 3 blocks an SM; 1 at mamba2-2.7b's, whose 160 blocks of
// 109,824 bytes already fill 132 SMs two deep).  A states-only pass of
// the same kernel (no C, no y) first leaves each segment's end state
// from zero (own_r) and its sum of dt A (ld_r); a segment's scan starts
// from h = exp(ld_r) h + own_r taken over the segments r before it.
// Registers (ptxas -v, CUDA 12.8), no spills: the scan 155 at N = 64
// and 229 at N = 128, the states pass 92 and 127.
//
// simt (float32, and bf16 at other shapes): the products on the CUDA
// cores in float32, which the float32 checks (SSD_F32_REL) and the
// card-against-CPU phases need.  One block of 256 threads owns one
// (P-tile of 32 columns, head, batch), keeps its [N, 32] slice of the
// state in float32 shared memory and recomputes cum and C.B^T for each
// tile.  Shared memory at N = 128 is 108,800 bytes, above the 48 KB
// default, hence cudaFuncSetAttribute.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

struct Params {
  const void* x;
  const float* dt;
  const float* A;
  const void* B;
  const void* C;
  void* y;
  float* h_out;
  int L, H, G, P, N;
  int64_t xsb, xsl, xsh, dsb, dsl, dsh, bsb, bsl, bsg, csb, csl, csg;
};

// ------------------------------------------------------------ simt
namespace simt {

constexpr int QT = 64;          // rows per tile
constexpr int PT = 32;          // head-dim columns per block
constexpr int MAX_N = 128;      // state size the shared memory is sized for
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

// float32 words of shared memory: B and C tiles [QT][N + 1], x tile
// [QT][PT + 1], scores [QT][QT + 1], state [N][PT + 1], dt, cum and the
// state weights u [QT] each (one extra word per row keeps the strided
// reads of a warp in distinct banks)
inline size_t smem_bytes(int N) {
  return sizeof(float) * (2 * QT * (N + 1) + QT * (PT + 1) +
                          QT * (QT + 1) + N * (PT + 1) + 3 * QT);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_scan_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  const int N = p.N, NS = N + 1;
  constexpr int XS = PT + 1, WS = QT + 1;
  float* sB = smem;
  float* sC = sB + QT * NS;
  float* sX = sC + QT * NS;
  float* sW = sX + QT * XS;
  float* sH = sW + QT * WS;
  float* sDt = sH + N * XS;
  float* sCum = sDt + QT;
  float* sU = sCum + QT;

  const int tid = threadIdx.x;
  const int p0 = blockIdx.x * PT;
  const int h = blockIdx.y, b = blockIdx.z;
  const int g = h / (p.H / p.G);
  const float A = p.A[h];
  const T* xg = static_cast<const T*>(p.x) + b * p.xsb + h * p.xsh + p0;
  const float* dg = p.dt + b * p.dsb + h * p.dsh;
  const T* bg = static_cast<const T*>(p.B) + b * p.bsb + g * p.bsg;
  const T* cg = static_cast<const T*>(p.C) + b * p.csb + g * p.csg;
  T* yg = static_cast<T*>(p.y) +
          (static_cast<int64_t>(b) * p.L * p.H + h) * p.P + p0;
  const int64_t y_row = static_cast<int64_t>(p.H) * p.P;
  const int pn = min(PT, p.P - p0);     // valid columns of this block

  for (int i = tid; i < N * XS; i += THREADS) sH[i] = 0.f;

  // score tile: rows 4 ry + a, columns cx + 16 c; y tile: rows 2 oy + a,
  // columns ox + 8 c; state tile: rows oy + 32 r, columns ox + 8 c
  const int ry = tid >> 4, cx = tid & 15;
  const int oy = tid >> 3, ox = tid & 7;

  for (int l0 = 0; l0 < p.L; l0 += QT) {
    const int rows = min(QT, p.L - l0);
    __syncthreads();            // the previous tile's reads are done
    for (int i = tid; i < QT * N; i += THREADS) {
      const int r = i / N, n = i - r * N;
      float bv = 0.f, cv = 0.f;
      if (r < rows) {
        const int64_t l = l0 + r;
        bv = to_f(bg[l * p.bsl + n]);
        cv = to_f(cg[l * p.csl + n]);
      }
      sB[r * NS + n] = bv;
      sC[r * NS + n] = cv;
    }
    for (int i = tid; i < QT * PT; i += THREADS) {
      const int r = i / PT, c = i % PT;
      float xv = 0.f;
      if (r < rows && c < pn)
        xv = to_f(xg[static_cast<int64_t>(l0 + r) * p.xsl + c]);
      sX[r * XS + c] = xv;
    }
    if (tid < QT)
      sDt[tid] = tid < rows ? dg[static_cast<int64_t>(l0 + tid) * p.dsl]
                            : 0.f;
    __syncthreads();

    // inclusive prefix sum of dt * A over the tile in warp 0: lane k
    // holds rows 2k and 2k + 1
    if (tid < 32) {
      const float a0 = sDt[2 * tid] * A;
      const float a1 = a0 + sDt[2 * tid + 1] * A;
      float s = a1;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, s, off);
        if (tid >= off) s += o;
      }
      float excl = __shfl_up_sync(0xffffffffu, s, 1);
      if (tid == 0) excl = 0.f;
      sCum[2 * tid] = excl + a0;
      sCum[2 * tid + 1] = excl + a1;
    }
    __syncthreads();
    const float cum_last = sCum[QT - 1];
    if (tid < QT) sU[tid] = sDt[tid] * expf(cum_last - sCum[tid]);

    // scores w_ij = (C_i . B_j) exp(cum_i - cum_j) dt_j for j <= i, else 0
    {
      float s[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[a][c] = 0.f;
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        float cv[4], bv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) cv[a] = sC[(4 * ry + a) * NS + n];
#pragma unroll
        for (int c = 0; c < 4; ++c) bv[c] = sB[(cx + 16 * c) * NS + n];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < 4; ++c) s[a][c] = fmaf(cv[a], bv[c], s[a][c]);
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = 4 * ry + a;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int j = cx + 16 * c;
          sW[i * WS + j] =
              j <= i ? s[a][c] * expf(sCum[i] - sCum[j]) * sDt[j] : 0.f;
        }
      }
    }
    __syncthreads();

    // y_i = sum_{j <= i} w_ij x_j + exp(cum_i) C_i h
    {
      float acc[2][4], hc[2][4];
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[a][c] = hc[a][c] = 0.f;
      const int j_end = 2 * oy + 2;    // w is zero past each row's diagonal
      for (int j = 0; j < j_end; ++j) {
        float xv[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) xv[c] = sX[j * XS + ox + 8 * c];
#pragma unroll
        for (int a = 0; a < 2; ++a) {
          const float w = sW[(2 * oy + a) * WS + j];
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[a][c] = fmaf(w, xv[c], acc[a][c]);
        }
      }
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        float hv[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) hv[c] = sH[n * XS + ox + 8 * c];
#pragma unroll
        for (int a = 0; a < 2; ++a) {
          const float cv = sC[(2 * oy + a) * NS + n];
#pragma unroll
          for (int c = 0; c < 4; ++c) hc[a][c] = fmaf(cv, hv[c], hc[a][c]);
        }
      }
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        const int i = 2 * oy + a;
        if (i >= rows) continue;
        const float e = expf(sCum[i]);
        T* yr = yg + static_cast<int64_t>(l0 + i) * y_row;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int col = ox + 8 * c;
          if (col < pn) yr[col] = from_f<T>(acc[a][c] + e * hc[a][c]);
        }
      }
    }
    __syncthreads();            // y has read the old state

    // h_np = exp(cum_last) h_np + sum_j B_jn u_j x_jp
    {
      const float decay = expf(cum_last);
      for (int r = 0; r < MAX_N / 32; ++r) {
        const int n = oy + 32 * r;
        if (n >= N) break;
        float acc[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[c] = decay * sH[n * XS + ox + 8 * c];
        for (int j = 0; j < rows; ++j) {
          const float bu = sB[j * NS + n] * sU[j];
#pragma unroll
          for (int c = 0; c < 4; ++c)
            acc[c] = fmaf(bu, sX[j * XS + ox + 8 * c], acc[c]);
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) sH[n * XS + ox + 8 * c] = acc[c];
      }
    }
  }
  __syncthreads();

  if (p.h_out != nullptr) {
    float* ho = p.h_out + (static_cast<int64_t>(b) * p.H + h) * N * p.P + p0;
    for (int i = tid; i < N * PT; i += THREADS) {
      const int n = i / PT, c = i % PT;
      if (c < pn) ho[static_cast<int64_t>(n) * p.P + c] = sH[n * XS + c];
    }
  }
}

template <typename T>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  // once per instance, at its first launch (before any graph capture)
  static cudaError_t attr = cudaFuncSetAttribute(
      ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_bytes(MAX_N)));
  if (attr != cudaSuccess) return attr;
  const dim3 grid((p.P + PT - 1) / PT, p.H, B);
  ssd_scan_kernel<T><<<grid, THREADS, smem_bytes(p.N), stream>>>(p);
  return cudaGetLastError();
}

}  // namespace simt

// ----------------------------------------------------------- wgmma
namespace wg {

using namespace hopper;
using bf16 = __nv_bfloat16;

constexpr int QT = 64;          // rows per tile
constexpr int P = 64;           // head dim
constexpr int THREADS = 128;    // one warpgroup
constexpr uint32_t BLOCK = QT * 128;   // a [64, 64] bf16 column block
constexpr int MAX_SEGMENTS = 8;

// Shared memory, from a 1024-byte aligned base: the tile (C, B [QT, N],
// x [QT, P]), the (B o u) pair [QT, N], the h pair [N, P], all bf16 in
// 128-byte swizzled column blocks of 64; then the tile's dt [QT] and
// each warp's own cum and u [QT], float32.  One stage: the blocks that
// share an SM hide each other's loads.
template <int N>
struct Smem {
  static constexpr uint32_t CB = QT * N * 2;
  static constexpr uint32_t OFF_B = CB;
  static constexpr uint32_t OFF_X = 2 * CB;
  static constexpr uint32_t OFF_BU = OFF_X + QT * P * 2;
  static constexpr uint32_t BU = QT * N * 2;
  static constexpr uint32_t OFF_H = OFF_BU + 2 * BU;
  static constexpr uint32_t H = N * P * 2;
  static constexpr uint32_t OFF_DT = OFF_H + 2 * H;
  static constexpr uint32_t OFF_CU = OFF_DT + QT * sizeof(float);
  static constexpr size_t bytes =
      1024 + OFF_CU + THREADS / 32 * 2 * QT * sizeof(float);
};

// The sequence in `count` segments of `tiles` 64-row tiles.  For each
// segment but the last, `ws` holds its end state from zero, [count - 1,
// B, H, N, P] float32, then its sum of dt A, [count - 1, B, H].
struct Segments {
  int tiles, count;
  float* ws;
};

// The byte offset of 16-byte chunk k of row r in a tile of 64-column
// blocks of QT rows (the layout hopper.cuh describes).
__device__ __forceinline__ uint32_t swz(int r, int k) {
  return (k >> 3) * BLOCK + r * 128 + (((k & 7) ^ (r & 7)) << 4);
}

// Splits an f32 accumulator fragment [64, 64] into the hi and lo bf16
// A fragments of its four k16 steps (hopper.cuh: a[x] = pack(d[8s +
// 2x], d[8s + 2x + 1])).
__device__ __forceinline__ void split_frag(const float (&d)[32],
                                           uint32_t (&hi)[4][4],
                                           uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int s = 0; s < 4; ++s)
#pragma unroll
    for (int x = 0; x < 4; ++x)
      split_bf16(d[8 * s + 2 * x], d[8 * s + 2 * x + 1], hi[s][x], lo[s][x]);
}

// Keeps A fragments live up to here: a wgmma reads them asynchronously
// until its wait, so their registers must not be reused before it.
__device__ __forceinline__ void keep_frag(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int s = 0; s < 4; ++s)
#pragma unroll
    for (int x = 0; x < 4; ++x) asm volatile("" : "+r"(a[s][x])::"memory");
}

// One (head, batch, segment).  STATES: the states pass, which leaves
// the segment's end state from zero and its decay in the workspace;
// otherwise the scan of the segment from the state carried into it,
// which writes y (and, in the last segment, the final state).
template <int N, bool STATES>
__global__ void __launch_bounds__(THREADS)
ssd_wgmma_kernel(const Params p, const Segments sg) {
  using S = Smem<N>;
  constexpr int MT = N / 64;            // 64-row tiles of the state
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t s0 = smem_u32(base);
  const uint32_t sBu = s0 + S::OFF_BU;   // hi, then lo S::BU after
  const uint32_t sH = s0 + S::OFF_H;     // hi, then lo S::H after
  float* sCum = reinterpret_cast<float*>(base + S::OFF_CU) +
               (threadIdx.x >> 5) * 2 * QT;    // this warp's own
  float* sU = sCum + QT;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int h = blockIdx.x, b = blockIdx.y, seg = blockIdx.z;
  const int g = h / (p.H / p.G);
  const float A = p.A[h];
  const bf16* xg = static_cast<const bf16*>(p.x) + b * p.xsb + h * p.xsh;
  const float* dg = p.dt + b * p.dsb + h * p.dsh;
  const bf16* bg = static_cast<const bf16*>(p.B) + b * p.bsb + g * p.bsg;
  const bf16* cg = static_cast<const bf16*>(p.C) + b * p.csb + g * p.csg;
  const int t0 = seg * sg.tiles;
  const int t1 = min((p.L + QT - 1) / QT, t0 + sg.tiles);
  const int64_t nstate = static_cast<int64_t>(gridDim.y) * p.H;
  float* ws_ld = sg.ws + (sg.count - 1) * nstate * N * P;

  // tile t: C (not in the states pass), B and x by 16-byte copies, dt
  // by 4-byte ones, rows past L zero-filled
  auto load_tile = [&](int t) {
    const int l0 = t * QT;
    if (tid < QT) {
      const bool in = l0 + tid < p.L;
      cp_async4(s0 + S::OFF_DT + tid * 4, dg + (in ? l0 + tid : 0) * p.dsl,
                in);
    }
    for (int i = tid; i < QT * N / 8; i += THREADS) {
      const int r = i / (N / 8), k = i % (N / 8);
      const bool in = l0 + r < p.L;
      const int64_t l = in ? l0 + r : 0;
      if (!STATES) cp_async16(s0 + swz(r, k), cg + l * p.csl + 8 * k, in);
      cp_async16(s0 + S::OFF_B + swz(r, k), bg + l * p.bsl + 8 * k, in);
    }
    for (int i = tid; i < QT * P / 8; i += THREADS) {
      const int r = i / (P / 8), k = i % (P / 8);
      const bool in = l0 + r < p.L;
      const int64_t l = in ? l0 + r : 0;
      cp_async16(s0 + S::OFF_X + swz(r, k), xg + l * p.xsl + 8 * k, in);
    }
    cp_async_commit();
  };

  // h in f32 accumulators: hacc[m][4j + 2i + c] is row 64 m + r0 + 8i,
  // column 8j + c0 + c.  The scan starts from the state carried into its
  // segment, h = exp(ld_r) h + own_r over the segments before it, and
  // writes its bf16 hi/lo pair; the states pass starts from zero.
  const int r0 = 16 * warp + (lane >> 2), c0 = 2 * (lane & 3);
  float hacc[MT][32];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int e = 0; e < 32; ++e) hacc[m][e] = 0.f;
  if (!STATES) {
    for (int r = 0; r < seg; ++r) {
      const int64_t at = r * nstate + static_cast<int64_t>(b) * p.H + h;
      const float decay = expf(ws_ld[at]);
      const float* own = sg.ws + at * N * P;
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) {
            const float2 v = *reinterpret_cast<const float2*>(
                own + (64 * m + r0 + 8 * i) * P + 8 * jj + c0);
            float* d = &hacc[m][4 * jj + 2 * i];
            d[0] = decay * d[0] + v.x;
            d[1] = decay * d[1] + v.y;
          }
    }
  }
  // h's bf16 pair for the next tile's Z: row n, chunk j ^ (n % 8)
  auto write_h_pair = [&] {
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int n = 64 * m + r0 + 8 * i;
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          uint32_t hi, lo;
          split_bf16(hacc[m][4 * jj + 2 * i], hacc[m][4 * jj + 2 * i + 1], hi,
                     lo);
          const uint32_t off = n * 128 + ((jj ^ (n & 7)) << 4) + 2 * c0;
          *reinterpret_cast<uint32_t*>(base + S::OFF_H + off) = hi;
          *reinterpret_cast<uint32_t*>(base + S::OFF_H + S::H + off) = lo;
        }
      }
  };
  if (!STATES) write_h_pair();
  float ld = 0.f;               // the segment's sum of dt A

  for (int t = t0; t < t1; ++t) {
    const int l0 = t * QT;
    load_tile(t);               // into space the last tile's barrier freed
    cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();            // the tile, and last tile's h pair

    // cum: the inclusive prefix of dt A over the tile, which every warp
    // takes for itself (lane k holds rows 2k and 2k + 1), and u_j = dt_j
    // exp(cum_last - cum_j)
    const float* sDt = reinterpret_cast<const float*>(base + S::OFF_DT);
    {
      const int r = 2 * lane;
      const float d0 = sDt[r], d1 = sDt[r + 1];
      const float a0 = d0 * A, a1 = a0 + d1 * A;
      float s = a1;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, s, off);
        if (lane >= off) s += o;
      }
      float excl = __shfl_up_sync(0xffffffffu, s, 1);
      if (lane == 0) excl = 0.f;
      const float cum0 = excl + a0, cum1 = excl + a1;
      const float last = __shfl_sync(0xffffffffu, cum1, 31);
      sCum[r] = cum0;
      sCum[r + 1] = cum1;
      sU[r] = d0 * expf(last - cum0);
      sU[r + 1] = d1 * expf(last - cum1);
      ld += last;
    }
    __syncwarp();

    const uint32_t sC = s0, sB = s0 + S::OFF_B, sX = s0 + S::OFF_X;
    float z[32];
    uint32_t whi[4][4], wlo[4][4];
    if (!STATES) {
      // S = C B^T (both K-major over n), then Z = C h_hi + C h_lo (h
      // MN-major [n, p])
      float sc[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk)
        wgmma_ss64<0, 0>(
            sc, sw128_desc(sC + (kk >> 2) * BLOCK + (kk & 3) * 32, 16, 1024),
            sw128_desc(sB + (kk >> 2) * BLOCK + (kk & 3) * 32, 16, 1024),
            kk > 0);
      wgmma_commit();
#pragma unroll
      for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int kk = 0; kk < N / 16; ++kk)
          wgmma_ss64<0, 1>(
              z, sw128_desc(sC + (kk >> 2) * BLOCK + (kk & 3) * 32, 16, 1024),
              sw128_desc(sH + half * S::H + kk * 16 * 128, N * 128, 1024),
              half > 0 || kk > 0);
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(sc);

      // W = S exp(cum_i - cum_j) dt_j for j <= i, else 0 (exponentiated
      // only where kept), split to hi/lo A fragments
      const float cum_i[2] = {sCum[r0], sCum[r0 + 8]};
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int j = 8 * jj + c0 + c;
          const float cum_j = sCum[j], dt_j = sDt[j];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            float& w = sc[4 * jj + 2 * i + c];
            w = j <= r0 + 8 * i ? w * expf(cum_i[i] - cum_j) * dt_j : 0.f;
          }
        }
      split_frag(sc, whi, wlo);

      // y = exp(cum_i) Z + W_hi x + W_lo x (x MN-major [j, p])
      wgmma_wait<0>();
      fence_regs(z);
      const float e_i[2] = {expf(cum_i[0]), expf(cum_i[1])};
#pragma unroll
      for (int e = 0; e < 32; ++e) z[e] *= e_i[(e >> 1) & 1];
      fence_regs(z);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t dx = sw128_desc(sX + kk * 16 * 128, BLOCK, 1024);
        wgmma_rs<64>(z, whi[kk], dx, 1);
        wgmma_rs<64>(z, wlo[kk], dx, 1);
      }
      wgmma_commit();
    }

    // meanwhile: (B o u) [j, n] = B_jn u_j as a hi/lo pair, in B's
    // layout (for the state update, an MN-major A over n)
    for (int i = tid; i < QT * N / 8; i += THREADS) {
      const int r = i / (N / 8), k = i % (N / 8);
      const uint32_t off = swz(r, k);
      const uint4 v =
          *reinterpret_cast<const uint4*>(base + S::OFF_B + off);
      const float u = sU[r];
      const uint32_t* w = reinterpret_cast<const uint32_t*>(&v);
      uint4 hi, lo;
      uint32_t* ho = reinterpret_cast<uint32_t*>(&hi);
      uint32_t* lw = reinterpret_cast<uint32_t*>(&lo);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const __nv_bfloat162 bb = *reinterpret_cast<const __nv_bfloat162*>(
            w + q);
        split_bf16(__low2float(bb) * u, __high2float(bb) * u, ho[q], lw[q]);
      }
      *reinterpret_cast<uint4*>(base + S::OFF_BU + off) = hi;
      *reinterpret_cast<uint4*>(base + S::OFF_BU + S::BU + off) = lo;
    }
    fence_proxy_async();
    if (!STATES) {
      wgmma_wait<0>();
      fence_regs(z);
      keep_frag(whi);           // read by the products until the wait
      keep_frag(wlo);
    }
    __syncthreads();            // (B o u) published; S, Z are done with C, h

    // h = exp(cum_last) h + (B o u)^T_hi x + (B o u)^T_lo x
    const float decay = expf(sCum[QT - 1]);
#pragma unroll
    for (int m = 0; m < MT; ++m) {
#pragma unroll
      for (int e = 0; e < 32; ++e) hacc[m][e] *= decay;
      fence_regs(hacc[m]);
    }
    wgmma_fence();
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t dx = sw128_desc(sX + kk * 16 * 128, BLOCK, 1024);
#pragma unroll
        for (int half = 0; half < 2; ++half)
          wgmma_ss64<1, 1>(hacc[m],
                           sw128_desc(sBu + half * S::BU + m * BLOCK +
                                          kk * 16 * 128,
                                      BLOCK, 1024),
                           dx, 1);
      }
    wgmma_commit();

    if (!STATES) {
      // meanwhile: y through C's space, each warp its own 16 rows (row
      // r, chunk jj ^ (r % 8)), then out as whole 128-byte rows
      unsigned char* sY = base;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = r0 + 8 * i;
#pragma unroll
        for (int jj = 0; jj < 8; ++jj)
          *reinterpret_cast<uint32_t*>(sY + r * 128 +
                                       ((jj ^ (r & 7)) << 4) + 2 * c0) =
              pack_bf16(z[4 * jj + 2 * i], z[4 * jj + 2 * i + 1]);
      }
      __syncwarp();
      bf16* yb = static_cast<bf16*>(p.y) +
                 (static_cast<int64_t>(b) * p.L * p.H + h) * P;
#pragma unroll
      for (int q = lane; q < 16 * 8; q += 32) {
        const int r = 16 * warp + (q >> 3), k = q & 7;
        if (l0 + r < p.L)
          *reinterpret_cast<uint4*>(yb +
                                    static_cast<int64_t>(l0 + r) * p.H * P +
                                    8 * k) =
              *reinterpret_cast<const uint4*>(sY + r * 128 +
                                              ((k ^ (r & 7)) << 4));
      }
    }

    wgmma_wait<0>();
#pragma unroll
    for (int m = 0; m < MT; ++m) fence_regs(hacc[m]);
    if (!STATES) {
      write_h_pair();
      fence_proxy_async();
    }
    __syncthreads();            // the tile, (B o u) and cum are free
  }

  // the states pass leaves the segment's own end state and its decay;
  // the last segment's scan the final state
  float* out = nullptr;
  if (STATES) {
    const int64_t at = seg * nstate + static_cast<int64_t>(b) * p.H + h;
    out = sg.ws + at * N * P;
    if (tid == 0) ws_ld[at] = ld;
  } else if (seg == sg.count - 1 && p.h_out != nullptr) {
    out = p.h_out + (static_cast<int64_t>(b) * p.H + h) * N * P;
  }
  if (out != nullptr) {
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int n = 64 * m + r0 + 8 * i;
#pragma unroll
        for (int jj = 0; jj < 8; ++jj)
          *reinterpret_cast<float2*>(out + n * P + 8 * jj + c0) = make_float2(
              hacc[m][4 * jj + 2 * i], hacc[m][4 * jj + 2 * i + 1]);
      }
  }
}

// Sets each instance's shared-memory limit once, at its first use
// (before any graph capture).
template <int N, bool STATES>
cudaError_t prepare() {
  static cudaError_t attr = cudaFuncSetAttribute(
      ssd_wgmma_kernel<N, STATES>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(Smem<N>::bytes));
  return attr;
}

// Segments for a [B, L, H] scan: as many as let every (head, batch,
// segment) block run at once on the card, at most one a tile and
// MAX_SEGMENTS.  One segment (no states pass) when the blocks of the
// whole sequence already fill the card.
template <int N>
cudaError_t count_segments(int B, int L, int H, int* count) {
  cudaError_t err = prepare<N, false>();
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, ssd_wgmma_kernel<N, false>, THREADS, Smem<N>::bytes);
  if (err != cudaSuccess) return err;
  const int tiles = (L + QT - 1) / QT;
  const int want =
      max(1, min(min(tiles, MAX_SEGMENTS), sms * per_sm / (B * H)));
  const int per = (tiles + want - 1) / want;
  *count = (tiles + per - 1) / per;             // no empty segment
  return cudaSuccess;
}

template <int N>
cudaError_t launch(const Params& p, int B, int count, float* ws,
                   cudaStream_t stream) {
  cudaError_t err = prepare<N, false>();
  if (err == cudaSuccess && count > 1) err = prepare<N, true>();
  if (err != cudaSuccess) return err;
  const int tiles = (p.L + QT - 1) / QT;
  const Segments sg{(tiles + count - 1) / count, count, ws};
  if (count > 1) {
    ssd_wgmma_kernel<N, true>
        <<<dim3(p.H, B, count - 1), THREADS, Smem<N>::bytes, stream>>>(p, sg);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  ssd_wgmma_kernel<N, false>
      <<<dim3(p.H, B, count), THREADS, Smem<N>::bytes, stream>>>(p, sg);
  return cudaGetLastError();
}

cudaError_t segments(int B, int L, int H, int N, int P_, int* count) {
  if (P_ != P) return cudaErrorInvalidValue;
  switch (N) {
    case 64: return count_segments<64>(B, L, H, count);
    case 128: return count_segments<128>(B, L, H, count);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t dispatch(const Params& p, int B, int count, float* ws,
                     cudaStream_t stream) {
  if (p.P != P || count < 1 || count > MAX_SEGMENTS ||
      (count > 1 && ws == nullptr))
    return cudaErrorInvalidValue;
  switch (p.N) {
    case 64: return launch<64>(p, B, count, ws, stream);
    case 128: return launch<128>(p, B, count, ws, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace wg

}  // namespace

// dtype (of x, B, C and y): 0 float32, 1 bfloat16; dt and A are float32.
// design: 0 simt, 1 wgmma (bf16 with N 64 or 128 and P 64 only; x, B
// and C 16-byte aligned with [B, L, *] strides of whole 16 bytes, which
// the wrapper checks and the 16-byte copies need).  Strides are in
// elements; the last dim of x, B and C has unit stride.  y is written
// contiguous [B, L, H, P]; h_out, when not null, contiguous [B, H, N,
// P] float32.  wgmma runs in `segments` segments
// (ssd_scan_segments), with a float32 workspace `ws` of (segments - 1)
// x B x H x (N P + 1) when there are more than one.
extern "C" int ssd_scan_launch(
    const void* x, const void* dt, const void* A, const void* B,
    const void* C, void* y, void* h_out, int Bsz, int L, int H, int G,
    int P, int N, int64_t xsb, int64_t xsl, int64_t xsh, int64_t dsb,
    int64_t dsl, int64_t dsh, int64_t bsb, int64_t bsl, int64_t bsg,
    int64_t csb, int64_t csl, int64_t csg, int dtype, int design,
    int segments, void* ws, void* stream_ptr) {
  if (Bsz <= 0 || L <= 0 || H <= 0 || P <= 0) return 0;
  if (G <= 0 || H % G != 0 || N <= 0 || N > simt::MAX_N || Bsz > 65535 ||
      H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{x,   static_cast<const float*>(dt), static_cast<const float*>(A),
           B,   C,   y,   static_cast<float*>(h_out),
           L,   H,   G,   P,   N,   xsb, xsl, xsh, dsb, dsl, dsh,
           bsb, bsl, bsg, csb, csl, csg};
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  cudaError_t err;
  if (design == 1 && dtype == 1)
    err = wg::dispatch(p, Bsz, segments, static_cast<float*>(ws), stream);
  else if (design == 0 && dtype == 0)
    err = simt::launch<float>(p, Bsz, stream);
  else if (design == 0 && dtype == 1)
    err = simt::launch<__nv_bfloat16>(p, Bsz, stream);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

// The segment count of the wgmma design for this shape on the current
// card, into *count (the wrapper sizes the workspace from it).
extern "C" int ssd_scan_segments(int Bsz, int L, int H, int N, int P,
                                 int* count) {
  if (Bsz <= 0 || L <= 0 || H <= 0) return static_cast<int>(
      cudaErrorInvalidValue);
  return static_cast<int>(wg::segments(Bsz, L, H, N, P, count));
}
