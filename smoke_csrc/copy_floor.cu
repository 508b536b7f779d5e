// B2's bytes moved with no work: each 128-position segment's int64 steps
// read and one byte a position written (the step's low bit), one warp a
// segment, eight warps a block, each lane two 16-byte loads and one 4-byte
// store, as compu_tpu_torch/csrc/parse_cover.cu moves them; and the same
// grid launched empty. ab_chains.py builds this file with chip_smoke.py's
// own library (it is no kernel of the package) and times both beside B2:
// what the card takes for the traffic of B2's byte bound, launch included,
// and what the launch alone takes.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;

__global__ void copy_floor_kernel(const longlong2* __restrict__ step,
                                  uint32_t* __restrict__ out, long long nseg) {
  const long long seg = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (seg >= nseg) return;
  const int lane = threadIdx.x & 31;
  const longlong2 lo = __ldg(step + seg * 64 + lane);
  const longlong2 hi = __ldg(step + seg * 64 + 32 + lane);
  out[seg * 32 + lane] = static_cast<uint32_t>(lo.x & 1) | static_cast<uint32_t>(lo.y & 1) << 8 |
                         static_cast<uint32_t>(hi.x & 1) << 16 |
                         static_cast<uint32_t>(hi.y & 1) << 24;
}

__global__ void empty_kernel() {}

}  // namespace

// step: (nseg * 128,) int64, 16-byte aligned; out: (nseg * 128,) bytes.
extern "C" int compu_copy_floor(const void* step, void* out, long long nseg, void* stream) {
  const unsigned blocks = static_cast<unsigned>((nseg + kWarps - 1) / kWarps);
  copy_floor_kernel<<<blocks, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const longlong2*>(step), static_cast<uint32_t*>(out), nseg);
  return static_cast<int>(cudaGetLastError());
}

// The copy floor's grid for nseg segments, launched with nothing to do.
extern "C" int compu_empty_launch(long long nseg, void* stream) {
  const unsigned blocks = static_cast<unsigned>((nseg + kWarps - 1) / kWarps);
  empty_kernel<<<blocks, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
