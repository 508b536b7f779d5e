// Two kernels' bytes moved with no work, and a grid launched empty.
// ab_chains.py builds this file with chip_smoke.py's own library (it is no
// kernel of the package) and times them beside the kernel: what the card
// takes for the traffic of the kernel's byte bound, launch included, and
// what the launch alone takes.
//
// B2 (compu_copy_floor): each 128-position segment's int64 steps read and
// one byte a position written (the step's low bit), one warp a segment,
// eight warps a block, each lane two 16-byte loads and one 4-byte store, as
// compu_tpu_torch/csrc/parse_cover.cu moves them.
//
// P3 (compu_inflate_copy_floor), on P3's grid (256 lanes a block, a block
// of lanes in one deflate block): each block reads its run of `comps` (its
// first lane's word to the next block's first bit, or to the deflate
// block's end, plus 8 words), its lanes' seg_bits and, once a deflate
// block, the two tables, by coalesced 16-byte loads, and writes its lanes'
// record rows of 511, outp and bad by coalesced stores, as
// compu_tpu_torch/csrc/inflate_scan.cu moves them.

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

constexpr int kLanes = 256;

__global__ void inflate_copy_floor_kernel(const uint4* __restrict__ words, long long nwords,
                                          long long block_bits,
                                          const int32_t* __restrict__ seg_bits, int S,
                                          const int32_t* __restrict__ ns,
                                          const int32_t* __restrict__ ends,
                                          const uint4* __restrict__ lit,
                                          const uint4* __restrict__ dist, int lut4, int R,
                                          uint4* __restrict__ rec, int32_t* __restrict__ outp,
                                          uint8_t* __restrict__ bad) {
  const int blk = blockIdx.y;
  const int seg0 = blockIdx.x * kLanes;
  const long long row0 = static_cast<long long>(blk) * S;
  const long long gbase = static_cast<long long>(blk) * block_bits;
  const long long first = static_cast<uint32_t>(seg_bits[row0 + seg0]) & 0xFFFFFF;
  const long long last = seg0 + kLanes < S
                             ? static_cast<uint32_t>(seg_bits[row0 + seg0 + kLanes]) & 0xFFFFFF
                             : ends[blk];
  const long long lo = ((gbase + first) >> 5) & ~3LL;
  long long n = ((gbase + last) >> 5) + 8 - lo;
  if (ns[blk] <= seg0 * 128 || n < 0) n = 0;
  uint32_t acc = 0;
  for (long long c = threadIdx.x; c < (n + 3) / 4 && lo + 4 * c < nwords; c += kLanes) {
    const uint4 v = __ldg(words + lo / 4 + c);
    acc ^= v.x ^ v.y ^ v.z ^ v.w;
  }
  if (blockIdx.x == 0) {
    for (int c = threadIdx.x; c < lut4; c += kLanes) {
      const uint4 a = __ldg(lit + static_cast<long long>(blk) * lut4 + c);
      const uint4 d = __ldg(dist + static_cast<long long>(blk) * lut4 + c);
      acc ^= a.x ^ a.y ^ a.z ^ a.w ^ d.x ^ d.y ^ d.z ^ d.w;
    }
  }
  const int seg = seg0 + threadIdx.x;
  if (seg < S) {
    acc ^= static_cast<uint32_t>(__ldg(seg_bits + row0 + seg));
    outp[row0 + seg] = 0;
    bad[row0 + seg] = 0;
  }
  asm volatile("" ::"r"(acc));  // the loads are kept
  const int rows = min(kLanes, S - seg0);
  const uint4 fill = make_uint4(511, 511, 511, 511);
  uint4* out = rec + (row0 + seg0) * R / 4;
  for (int v = threadIdx.x; v < rows * R / 4; v += kLanes) out[v] = fill;
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

// comps: (B, cap) u8 and lit, dist: (B, 2^lut_bits) i32, 16-byte aligned;
// seg_bits: (B, S) i32; ns, ends: (B,) i32 (ends: each block's bits up to
// its last non-zero byte); rec: (B * S, R) i32, R a multiple of 4, 16-byte
// aligned; outp: (B * S,) i32; bad: (B * S,) bool.
extern "C" int compu_inflate_copy_floor(const void* comps, long long cap, int B,
                                        const void* seg_bits, int S, const void* ns,
                                        const void* ends, const void* lit, const void* dist,
                                        int lut_bits, int R, void* rec, void* outp, void* bad,
                                        void* stream) {
  if (cap % 16 || R % 4) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((S + kLanes - 1) / kLanes, B);
  inflate_copy_floor_kernel<<<grid, kLanes, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(comps), static_cast<long long>(B) * cap / 4, cap * 8,
      static_cast<const int32_t*>(seg_bits), S, static_cast<const int32_t*>(ns),
      static_cast<const int32_t*>(ends), static_cast<const uint4*>(lit),
      static_cast<const uint4*>(dist), (1 << lut_bits) / 4, R, static_cast<uint4*>(rec),
      static_cast<int32_t*>(outp), static_cast<uint8_t*>(bad));
  return static_cast<int>(cudaGetLastError());
}

// The B2 copy floor's grid for nseg segments, launched with nothing to do
// (at nseg = B * S / 32, P3's grid: one block of 256 threads a 256 lanes).
extern "C" int compu_empty_launch(long long nseg, void* stream) {
  const unsigned blocks = static_cast<unsigned>((nseg + kWarps - 1) / kWarps);
  empty_kernel<<<blocks, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
