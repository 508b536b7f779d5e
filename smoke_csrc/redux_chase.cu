// A chain of dependent warp-wide reductions in one warp: the latency of one
// __reduce_max_sync on the card. chip_smoke.py builds this file on its own
// (it is no kernel of the package) and takes the latency as the unit of
// the table stage's bound (compu_tpu_torch/csrc/build_tables.cu): each step
// of a tree needs at least one reduction over the warp's symbols.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

// One warp: v = max over the warp of (v + lane), `steps` times.
__global__ void redux_chase_kernel(int steps, long long* __restrict__ out) {
  const unsigned lane = threadIdx.x & 31;
  unsigned v = lane;
  const long long t0 = clock64();
#pragma unroll 8
  for (int k = 0; k < steps; ++k) v = __reduce_max_sync(0xffffffffu, v + lane);
  const long long t1 = clock64();
  if (lane == 0) {
    out[0] = v;
    out[1] = t1 - t0;
  }
}

}  // namespace

// out: (2,) i64 = [the chain's last value, clock64 cycles for `steps`
// dependent reductions].
extern "C" int compu_redux_chase(void* out, int steps, void* stream) {
  redux_chase_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      steps, static_cast<long long*>(out));
  return static_cast<int>(cudaGetLastError());
}
