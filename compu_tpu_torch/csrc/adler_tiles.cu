// Per-tile adler32 partials.
//
// Replaces: compu_tpu/kernels/pallas_kernels.py:_adler_tile_kernel (via
// adler32_partials). Plain twin: compu_tpu_torch/kernels/adler_tiles.py
// adler32_partials_torch.
//
// For tile t of 1024 bytes x_0..x_1023: out[t] = [sum x_k,
// sum x_k * (1024 - k)], exact in int32 (255 * 1024 * 1024 < 2^31). The
// host combines the tiles into adler32. The TPU kernel wrote the two sums
// into an (8, 128) page per tile; here each tile writes its two int32s.
//
// Bound on the H100: memory. 1024 bytes read and 8 written per tile, about
// 16 integer operations a byte.
//
// Design: one warp per tile, eight tiles per block. Each lane loads two
// 16-byte vectors (bytes 16*lane and 512 + 16*lane on), so a warp's loads
// are coalesced, and the warp adds both sums with shuffles.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kTileBytes = 1024;
constexpr int kWarpsPerBlock = 8;
constexpr int kVecsPerTile = kTileBytes / 16;

__global__ void adler_tiles_kernel(const uint4* __restrict__ data,
                                   int32_t* __restrict__ out,
                                   long long ntiles) {
  const long long t =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / 32;
  if (t >= ntiles) return;  // the whole warp leaves together
  const int lane = threadIdx.x & 31;
  int s = 0, w = 0;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int v = half * 32 + lane;
    const uint4 q = data[t * kVecsPerTile + v];
    const uint32_t quad[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int b = (quad[j >> 2] >> (8 * (j & 3))) & 0xFF;
      s += b;
      w += b * (kTileBytes - (v * 16 + j));
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s += __shfl_down_sync(0xFFFFFFFFu, s, off);
    w += __shfl_down_sync(0xFFFFFFFFu, w, off);
  }
  if (lane == 0) {
    out[2 * t] = s;
    out[2 * t + 1] = w;
  }
}

}  // namespace

// data: ntiles * 1024 bytes, 16-byte aligned; out: (ntiles, 2) i32.
extern "C" int compu_adler_tiles(const void* data, void* out, long long ntiles,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned blocks =
      static_cast<unsigned>((ntiles + kWarpsPerBlock - 1) / kWarpsPerBlock);
  adler_tiles_kernel<<<blocks, kWarpsPerBlock * 32, 0, s>>>(
      static_cast<const uint4*>(data), static_cast<int32_t*>(out), ntiles);
  return static_cast<int>(cudaGetLastError());
}
