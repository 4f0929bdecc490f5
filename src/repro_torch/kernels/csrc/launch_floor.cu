// An empty kernel: the yardstick for what one launch costs on the card.
// chip_smoke.py times it with the kernels' own timers (device time from
// CUDA-graph replay, eager time from Python), so a kernel of a few
// microseconds can be read against the least any launch takes.  It is
// not a port of a TPU kernel and no path of the port calls it.
#include <cuda_runtime.h>

namespace {

__global__ void launch_floor_kernel() {}

}  // namespace

extern "C" int launch_floor_launch(void* stream_ptr) {
  launch_floor_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream_ptr)>>>();
  return static_cast<int>(cudaGetLastError());
}
