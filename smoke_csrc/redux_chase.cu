// A chain of dependent warp-wide reductions in one warp: the latency of one
// __reduce_max_sync on the card. chip_smoke.py builds this file on its own
// (it is no kernel of the package) and takes the latency as the unit of
// the table stage's bound (compu_tpu_torch/csrc/build_tables.cu): each step
// of a tree needs at least one reduction over the warp's symbols. A second
// chase times one step of a reduction over four warps (ab_chains.py
// build_tables).

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

// Four warps: v = max over the block of (v + thread), `steps` times, each
// step one warp reduction, one word a warp through shared memory (two
// buffers, so one barrier a step) and a max of the four words. The least
// that a step of a tree spread over four warps takes (the wider design
// that build_tables.cu weighs against its one warp a tree).
__global__ void block_redux_chase_kernel(int steps, long long* __restrict__ out) {
  __shared__ unsigned s_top[2][4];
  const unsigned tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  unsigned v = tid;
  const long long t0 = clock64();
  for (int k = 0; k < steps; ++k) {
    const unsigned w = __reduce_max_sync(0xffffffffu, v + tid);
    if (lane == 0) s_top[k & 1][warp] = w;
    __syncthreads();
    v = max(max(s_top[k & 1][0], s_top[k & 1][1]), max(s_top[k & 1][2], s_top[k & 1][3]));
  }
  const long long t1 = clock64();
  if (tid == 0) {
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

// The same for the four-warp step (block_redux_chase_kernel).
extern "C" int compu_block_redux_chase(void* out, int steps, void* stream) {
  block_redux_chase_kernel<<<1, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      steps, static_cast<long long*>(out));
  return static_cast<int>(cudaGetLastError());
}
