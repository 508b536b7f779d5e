// A chain of dependent global loads served by the L2 cache, in one thread:
// the latency of one L2 round trip on the card. chip_smoke.py builds this
// file on its own (it is no kernel of the package) and takes the latency as
// the unit of the pointer doubling's chain bound (compu_tpu_torch/csrc/
// inflate_resolve.cu, P6): a hop of a round reads the map at a position
// another hop wrote, a load that waits on the one before it, from a map of
// 16 MiB that the L2 holds.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kRingWords = 1 << 22;   // 16 MiB: the L2 holds it, the L1 does not
constexpr int kStride = 4099;         // odd: one cycle through every word, 16 KiB apart

__device__ int32_t g_ring[kRingWords];

__global__ void l2_ring_kernel() {
  for (int k = blockIdx.x * blockDim.x + threadIdx.x; k < kRingWords;
       k += gridDim.x * blockDim.x) {
    g_ring[k] = (k + kStride) & (kRingWords - 1);
  }
}

// Thread 0 chases i = ring[i] `steps` times, each load from the L2 (ld.cg:
// not cached in the L1).
__global__ void l2_chase_kernel(int steps, long long* __restrict__ out) {
  if (threadIdx.x != 0) return;
  int i = 0;
  const long long t0 = clock64();
#pragma unroll 8
  for (int k = 0; k < steps; ++k) i = __ldcg(&g_ring[i]);
  const long long t1 = clock64();
  out[0] = i;
  out[1] = t1 - t0;
}

}  // namespace

// out: (2,) i64 = [the chain's last index, clock64 cycles for `steps`
// dependent loads]. The ring is written first, in the same stream.
extern "C" int compu_l2_chase(void* out, int steps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  l2_ring_kernel<<<264, 512, 0, s>>>();
  l2_chase_kernel<<<1, 32, 0, s>>>(steps, static_cast<long long*>(out));
  return static_cast<int>(cudaGetLastError());
}
