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
// cores, which bounds the float32 call).  This first kernel computes
// on the CUDA cores in float32, so it runs well above that bound;
// tensor-core products (wgmma on C.B^T and W.x) are later work.
//
// Design: on Hopper nothing carries between blocks, so one block of 256
// threads owns one (P-tile of 32 columns, head, batch) and walks the
// sequence itself in tiles of 64 rows, keeping its [N, 32] slice of
// the state in float32 shared memory.  Splitting P doubles the blocks
// at P = 64 (256 at zamba2's shape, 320 at mamba2-2.7b's, for 132 SMs);
// the recurrence is independent per column of h and y, and each block
// recomputes cum and C.B^T for its tile.  The caller's chunk does not
// change the function, only where rounding happens: the kernel's 64-row
// tiles hold the intra-tile [64, 64] scores in 16 KB, where a 256-row
// chunk's would not fit beside B and C.  Overflow: every exponent is
// non-positive (cum_i - cum_j only for j <= i, cum_i, cum_last - cum_j),
// so nothing reaches inf and the masked half is never exponentiated;
// the diagonal j = i is in.  Groups: a block reads its head's group of
// B and C through its strides, never a repeated copy.  x, B and C are
// read through their [B, L, *, *] strides (unit stride in the last
// dim), so the model's column slices of one conv output need no copy.
// Rows past L in the last tile are zero (dt 0, so cum stays flat) and
// are not written.  Shared memory at N = 128 is 108,800 bytes, above
// the 48 KB default, hence cudaFuncSetAttribute.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int QT = 64;          // rows per tile
constexpr int PT = 32;          // head-dim columns per block
constexpr int MAX_N = 128;      // state size the shared memory is sized for
constexpr int THREADS = 256;

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

}  // namespace

// dtype (of x, B, C and y): 0 float32, 1 bfloat16; dt and A are float32.
// Strides are in elements; the last dim of x, B and C has unit stride.
// y is written contiguous [B, L, H, P]; h_out, when not null, contiguous
// [B, H, N, P] float32.
extern "C" int ssd_scan_launch(
    const void* x, const void* dt, const void* A, const void* B,
    const void* C, void* y, void* h_out, int Bsz, int L, int H, int G,
    int P, int N, int64_t xsb, int64_t xsl, int64_t xsh, int64_t dsb,
    int64_t dsl, int64_t dsh, int64_t bsb, int64_t bsl, int64_t bsg,
    int64_t csb, int64_t csl, int64_t csg, int dtype, void* stream_ptr) {
  if (Bsz <= 0 || L <= 0 || H <= 0 || P <= 0) return 0;
  if (G <= 0 || H % G != 0 || N <= 0 || N > MAX_N || Bsz > 65535 ||
      H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{x,   static_cast<const float*>(dt), static_cast<const float*>(A),
           B,   C,   y,   static_cast<float*>(h_out),
           L,   H,   G,   P,   N,   xsb, xsl, xsh, dsb, dsl, dsh,
           bsb, bsl, bsg, csb, csl, csg};
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (dtype == 0) return static_cast<int>(launch<float>(p, Bsz, stream));
  if (dtype == 1)
    return static_cast<int>(launch<__nv_bfloat16>(p, Bsz, stream));
  return static_cast<int>(cudaErrorInvalidValue);
}
