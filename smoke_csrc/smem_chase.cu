// A chain of dependent shared-memory reads in one thread: the latency of
// one shared-memory round trip on the card. chip_smoke.py builds this file
// on its own (it is no kernel of the package) and takes the latency as the
// unit of the FSE state scan's bound (compu_tpu_torch/csrc/fse_seq_scan.cu).

#include <cstdint>

#include <cuda_runtime.h>

namespace {

// Thread 0 chases i = ring[i] through shared memory `steps` times.
__global__ void smem_chase_kernel(int steps, long long* __restrict__ out) {
  __shared__ int32_t ring[1024];
  for (int k = threadIdx.x; k < 1024; k += blockDim.x) ring[k] = (k + 97) & 1023;
  __syncthreads();
  if (threadIdx.x != 0) return;
  int i = 0;
  const long long t0 = clock64();
#pragma unroll 8
  for (int k = 0; k < steps; ++k) i = ring[i];
  const long long t1 = clock64();
  out[0] = i;
  out[1] = t1 - t0;
}

}  // namespace

// out: (2,) i64 = [the chain's last index, clock64 cycles for `steps`
// dependent reads].
extern "C" int compu_smem_chase(void* out, int steps, void* stream) {
  smem_chase_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      steps, static_cast<long long*>(out));
  return static_cast<int>(cudaGetLastError());
}
