// Grid-wide barriers alone: one cooperative launch whose blocks do nothing
// but `n` grid.sync()s of cooperative_groups. ab_chains.py builds this file
// with the other chases (it is no kernel of the package) and times a launch
// of n barriers against one of none, at several blocks an SM and threads a
// block: the price of a barrier between the steps of the pointer doubling
// and the expansion (compu_tpu_torch/csrc/inflate_resolve.cu, P6 and P7).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

__global__ void grid_sync_kernel(int n, int* __restrict__ sink) {
  cg::grid_group grid = cg::this_grid();
  for (int i = 0; i < n; ++i) grid.sync();
  if (grid.thread_rank() == 0) sink[0] = n;
}

}  // namespace

// sink: (1,) int32. blocks_per_sm blocks of `threads` on every SM, all
// resident (an error if the card holds fewer).
extern "C" int compu_grid_sync(void* sink, int n, int blocks_per_sm, int threads, void* stream) {
  int dev = 0, sms = 0, fit = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fit, grid_sync_kernel, threads, 0);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  if (fit < blocks_per_sm) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  int* sink_p = static_cast<int*>(sink);
  void* args[] = {&n, &sink_p};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(grid_sync_kernel),
                                    dim3(sms * blocks_per_sm), dim3(threads), args, 0,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
