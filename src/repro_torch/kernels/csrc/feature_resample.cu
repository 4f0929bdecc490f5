// Row gather out[i, :] = src[idx[i], :] for the server's resampled
// minibatches (paper Eq. 3).
//
// Replaces: src/repro/kernels/feature_resample.py, feature_resample (a
// Pallas scalar-prefetch grid whose index map streamed source row idx[i]
// into output block i).
//
// Bound on the H100: memory.  The call must read M rows and write M rows,
// 2 * M * row_bytes, at 3.35 TB/s; at the main path's shapes (M = 16
// rows of 12,544 bytes) that is about 0.12 us, far below a launch, so in
// practice the call is bound by launch latency.
//
// The transformer round gathers the other extreme: 2 rows of 8 MB (the
// pooled [C * b, S, d] bf16 activations, server batch 2), whose 33.5 MB
// take about 10 us at the HBM rate.
//
// Design: blockIdx.x is the output row, blockIdx.y a chunk of it of at
// most CHUNK_VECS vectors, so a few long rows still spread over every SM
// (as one block each, 2 rows would keep 2 of 132 SMs busy) while a short
// row stays one block.  Each block reads its row
// index (the TPU prefetched it into scalar memory), then copies its chunk
// with the widest vector that the row length and both base pointers allow
// (16, 8, 4, 2 or 1 bytes), so the kernel is agnostic to the element
// type.  A row index outside [0, T) yields a zero row instead of a wild
// read.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int64_t CHUNK_VECS = 4 * THREADS;   // vectors a block copies
constexpr int64_t MAX_CHUNKS = 65535;         // gridDim.y limit

template <typename V>
__global__ void gather_rows_kernel(const V* __restrict__ src,
                                   const int32_t* __restrict__ idx,
                                   V* __restrict__ out, int64_t T,
                                   int64_t row_vecs) {
  const int64_t i = blockIdx.x;
  const int32_t r = idx[i];
  const bool valid = r >= 0 && r < T;
  const V* s = src + (valid ? static_cast<int64_t>(r) * row_vecs : 0);
  V* dst = out + i * row_vecs;
  for (int64_t lo = blockIdx.y * CHUNK_VECS; lo < row_vecs;
       lo += static_cast<int64_t>(gridDim.y) * CHUNK_VECS) {
    const int64_t hi = lo + CHUNK_VECS < row_vecs ? lo + CHUNK_VECS : row_vecs;
    for (int64_t j = lo + threadIdx.x; j < hi; j += blockDim.x)
      dst[j] = valid ? s[j] : V{};
  }
}

template <typename V>
void launch(const void* src, const int32_t* idx, void* out, int64_t T,
            int64_t M, int64_t row_bytes, cudaStream_t stream) {
  const int64_t row_vecs = row_bytes / static_cast<int64_t>(sizeof(V));
  int threads = 32;
  while (threads < THREADS && threads < row_vecs) threads *= 2;
  int64_t chunks = (row_vecs + CHUNK_VECS - 1) / CHUNK_VECS;
  if (chunks > MAX_CHUNKS) chunks = MAX_CHUNKS;
  const dim3 grid(static_cast<unsigned>(M), static_cast<unsigned>(chunks));
  gather_rows_kernel<V><<<grid, threads, 0, stream>>>(
      static_cast<const V*>(src), idx, static_cast<V*>(out), T, row_vecs);
}

bool fits(const void* a, const void* b, int64_t row_bytes, int64_t width) {
  return row_bytes % width == 0 &&
         reinterpret_cast<uintptr_t>(a) % width == 0 &&
         reinterpret_cast<uintptr_t>(b) % width == 0;
}

}  // namespace

extern "C" int feature_resample_launch(const void* src, const int32_t* idx,
                                       void* out, int64_t T, int64_t M,
                                       int64_t row_bytes, void* stream_ptr) {
  if (M <= 0 || row_bytes <= 0) return 0;
  if (M > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (fits(src, out, row_bytes, 16))
    launch<uint4>(src, idx, out, T, M, row_bytes, stream);
  else if (fits(src, out, row_bytes, 8))
    launch<uint2>(src, idx, out, T, M, row_bytes, stream);
  else if (fits(src, out, row_bytes, 4))
    launch<uint32_t>(src, idx, out, T, M, row_bytes, stream);
  else if (fits(src, out, row_bytes, 2))
    launch<uint16_t>(src, idx, out, T, M, row_bytes, stream);
  else
    launch<uint8_t>(src, idx, out, T, M, row_bytes, stream);
  return static_cast<int>(cudaGetLastError());
}
